"""The arithmetic of the sm_90a attention kernels, in plain PyTorch, against
the JAX package's training attention.

``tokenreduction_tpu_torch/csrc/attention_sm90.cu`` computes the attention
in its own order, which a CPU cannot run as CUDA. This file writes that
order out in PyTorch (``recipe_forward``, ``recipe_backward``) and holds it
against the JAX package on the CPU: ``attention_core_train`` (forward and
``jax.vjp``) and ``attend_branch_train``'s ``jax.vjp``, their Pallas kernels
in interpret mode, as tests/test_torch_train_ops.py runs them. The kernels'
order:

- query and key tiles of 64 rows, the padding rows zero;
- logits in base-2 units, q.k * scale * log2 e + bias * log2 e, capped at
  -FLT_MAX where the query or the key token is invalid (the mask), -inf
  past N; exp2 less the exact row max;
- the forward's row statistics, fp32 [B, H, N, 2]: the row max of the
  logits (-FLT_MAX where a row is fully masked) and 1/sum;
- the backward's P from those statistics (no recomputed max or sum);
- delta in the form each variant ships: the shortcut rowsum(dO * O) +
  [i = 0] row0 . drow0 from the forward's rounded output where there is no
  colsum cotangent and no dbias, else sum_j P_ij dP_ij in full;
- dQ summed over the key tiles in fp32, tile after tile.

Inputs (seeded numpy, the same to both sides) cover N = 4, 13, 68, 197
(none a multiple of 16), a per-key bias, a mask with fully masked query
rows, and non-zero row0 and colsum cotangents. Bounds, each over the
tensor's max|JAX|: fp32 1e-4 (as chip_smoke.py holds an fp32 launch);
bf16 2e-2, the bound chip_smoke.py holds a bf16 counterpart to (both sides
round P, dS and the outputs to bf16, at points that differ by the order of
the arithmetic). The saved statistics must equal the row max and 1/sum of
JAX's logits within 1e-5 of their max.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu.ops.flash_attention_train import (
    attention_core_train as jax_attention_core,
)
from tokenreduction_tpu.ops.fused_block_train import (
    attend_branch_train as jax_attend_branch,
)
from tokenreduction_tpu_torch.ops.flash_attention import (
    layer_norm_bwd_ref,
    layer_norm_stats,
    linear_f32,
    packed_heads,
)

B, H, HD, EPS = 2, 2, 64, 1e-6
WIDTHS = (4, 13, 68, 197)
TILE = 64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
FLT_MAX = float(np.finfo(np.float32).max)
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


# ---- the kernels' arithmetic
def _pad_rows(t, rows):
    """t [..., N, hd] as fp32 with zero rows up to `rows`."""
    pad = torch.zeros(*t.shape[:-2], rows - t.shape[-2], t.shape[-1])
    return torch.cat([t.float(), pad], -2)


def _logits2(q, k, scale, bias, mask, T):
    """The base-2 logits [B, H, T, T] of the padded tiles, with the bias,
    the caps and -inf past N."""
    N = q.shape[-2]
    bias2 = torch.full((q.shape[0], T), -math.inf)
    bias2[:, :N] = 0.0 if bias is None else bias.float() * LOG2E
    x = _pad_rows(q, T) @ _pad_rows(k, T).transpose(-1, -2) \
        * (scale * LOG2E) + bias2[:, None, None, :]
    if mask is not None:
        cap = torch.full((q.shape[0], T), -FLT_MAX)
        cap[:, :N] = torch.where(mask, math.inf, -FLT_MAX)
        x = torch.minimum(torch.minimum(x, cap[:, None, None, :]),
                          cap[:, None, :, None])
    return x


def recipe_forward(q, k, v, scale, bias=None, mask=None, norm_p=False):
    """(out [B, H, N, hd] in q's dtype, row0, colsum, stats [B, H, N, 2])
    in the forward kernel's order: whole padded rows of S, the exact row
    max, exp2; the eval recipe rounds the exponentials before PV and scales
    the output by 1/sum, NORM_P rounds the normalised P."""
    dt, N = q.dtype, q.shape[-2]
    T = -(-N // TILE) * TILE
    x = _logits2(q, k, scale, bias, mask, T)
    m2 = x.amax(-1)
    e = torch.exp2(x - m2[..., None])
    r = torch.where(torch.arange(T) < N, 1.0 / e.sum(-1), 0.0)
    p = e * r[..., None]
    vp = _pad_rows(v, T)
    if norm_p:
        out = p.to(dt).float() @ vp
    else:
        out = (e.to(dt).float() @ vp) * r[..., None]
    m = torch.where(m2 == -FLT_MAX, m2, m2 * LN2)
    stats = torch.stack([m, r], -1)[:, :, :N]
    return (out[:, :, :N].to(dt), p[:, :, 0, :N], p[:, :, :, :N].sum(2),
            stats)


def recipe_backward(q, k, v, out, dout, stats, row0, scale, bias=None,
                    mask=None, drow0=None, dcs=None, exact=False):
    """(dq, dk, dv in q's dtype, the per-head dbias [B, H, N] fp32) in the
    backward kernel's order: P from the forward's statistics, dP with both
    cotangents, delta in full (exact) or in the shortcut form, dS zero at a
    masked pair, dS rounded after the scale, dQ summed over the key tiles
    in fp32 in order."""
    dt, N = q.dtype, q.shape[-2]
    T = -(-N // TILE) * TILE
    valid = torch.arange(T) < N
    m = _pad_rows(stats[..., :1], T)[..., 0]
    r = _pad_rows(stats[..., 1:], T)[..., 0]
    m2 = torch.where(valid, torch.where(m == -FLT_MAX, m, m * LOG2E),
                     math.inf)
    x = _logits2(q, k, scale, bias, mask, T)
    p = torch.exp2(x - m2[..., None]) * r[..., None]
    do = _pad_rows(dout, T)
    dp = do @ _pad_rows(v, T).transpose(-1, -2)
    if drow0 is not None:
        dp[:, :, 0, :N] += drow0.float()
    if dcs is not None:
        dp[:, :, :N, :N] += dcs.float()[:, :, None, :]
    if exact:
        delta = (p * dp).sum(-1)
    else:
        delta = (do * _pad_rows(out, T)).sum(-1)
        if drow0 is not None:
            delta[:, :, 0] += (row0.float() * drow0.float()).sum(-1)
    u = p * (dp - delta[..., None])
    if mask is not None:
        ok = torch.zeros(q.shape[0], T, dtype=torch.bool)
        ok[:, :N] = mask
        u = u.masked_fill(~(ok[:, None, :, None] & ok[:, None, None, :]),
                          0.0)
    ds = (u * scale).to(dt).float()
    qp, kp = _pad_rows(q, T), _pad_rows(k, T)
    dq = torch.zeros_like(qp)
    for j in range(0, T, TILE):  # key tile after key tile
        dq = dq + ds[..., j:j + TILE] @ kp[:, :, j:j + TILE]
    dk = ds.transpose(-1, -2) @ qp
    dv = p.to(dt).float().transpose(-1, -2) @ do
    return (dq[:, :, :N].to(dt), dk[:, :, :N].to(dt), dv[:, :, :N].to(dt),
            u.sum(2)[:, :, :N])


# ---- inputs and checks
def core_inputs(N, seed, masked):
    """q, k, v [B, H, N, hd], a ToMe bias [B, N], a validity mask [B, N]
    (CLS valid, image 0 with only CLS valid, so most of its query rows are
    fully masked) or None, and the cotangents of out, row0 and colsum."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    mask = None
    if masked:
        mask = rng.random((B, N)) > 0.3
        mask[:, 0] = True
        mask[0, 1:] = False
    return ([rand(B, H, N, HD) for _ in range(3)],
            np.log(rng.integers(1, 5, (B, N))).astype(np.float32), mask,
            rand(B, H, N, HD), rand(B, H, N), rand(B, H, N))


def close(got, want, dtype, what):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= BOUND[dtype], f"{what}: {err:.3e} of max|JAX|"


def torch_of(a, dtype):
    """A JAX array (bf16 values are exact in fp32) as a torch tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


CORE_CASES = [(N, kind, name) for N in WIDTHS
              for kind in ("plain", "bias", "mask", "bias+mask")
              for name in ("fp32",)] + \
    [(N, "bias+mask", "bf16") for N in WIDTHS]


@pytest.mark.parametrize("N,kind,dtype_name", CORE_CASES)
def test_forward_and_stats_match_jax(N, kind, dtype_name):
    dtype = DTYPES[dtype_name]
    qkv, bias, mask, *_ = core_inputs(N, seed=N, masked="mask" in kind)
    bias = bias if "bias" in kind else None
    scale = HD ** -0.5
    jq, jk, jv = (jnp.asarray(a, JAX_DTYPES[dtype]) for a in qkv)
    want = jax_attention_core(jq, jk, jv, scale,
                              None if bias is None else jnp.asarray(bias),
                              None if mask is None else jnp.asarray(mask),
                              True)
    q, k, v = (torch_of(a, dtype) for a in (jq, jk, jv))
    got = recipe_forward(q, k, v, scale,
                         None if bias is None else torch.from_numpy(bias),
                         None if mask is None else torch.from_numpy(mask))
    for label, g, w in zip(("out", "row0", "colsum"), got, want):
        close(g, w, dtype, label)
    # the statistics: JAX's logits' row max and 1/sum
    logits = jnp.einsum("bhid,bhjd->bhij", jq.astype(jnp.float32),
                        jk.astype(jnp.float32)) * scale
    if bias is not None:
        logits = logits + jnp.asarray(bias)[:, None, None, :]
    if mask is not None:
        pair = jnp.asarray(mask)[:, None, :, None] & \
            jnp.asarray(mask)[:, None, None, :]
        logits = jnp.where(pair, logits, -FLT_MAX)
    m = logits.max(-1)
    r = 1.0 / jnp.exp(logits - m[..., None]).sum(-1)
    stats = got[3].numpy()
    for label, g, w in (("row max", stats[..., 0], m), ("1/sum", stats[..., 1],
                                                       r)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), label


VJP_CASES = [(N, form, name) for N in WIDTHS
             for form in ("shortcut", "exact") for name in ("fp32", "bf16")]


@pytest.mark.parametrize("N,form,dtype_name", VJP_CASES)
def test_core_vjp_matches_jax(N, form, dtype_name):
    """The shortcut form as the masked core runs it (heuristic's: a mask,
    the row0 cotangent); the exact form as ToMe's core runs it (a bias,
    both cotangents, dbias), with the mask too."""
    dtype = DTYPES[dtype_name]
    exact = form == "exact"
    qkv, bias, mask, g, g0, gc = core_inputs(N, seed=100 + N, masked=True)
    scale = HD ** -0.5
    jq, jk, jv = (jnp.asarray(a, JAX_DTYPES[dtype]) for a in qkv)
    jbias = jnp.asarray(bias) if exact else None
    outs, vjp = jax.vjp(
        lambda q, k, v, b: jax_attention_core(q, k, v, scale, b,
                                              jnp.asarray(mask), True),
        jq, jk, jv, jbias)
    cots = (jnp.asarray(g, JAX_DTYPES[dtype]), jnp.asarray(g0),
            jnp.asarray(gc) if exact else jnp.zeros_like(jnp.asarray(gc)))
    want = vjp(cots)
    q, k, v = (torch_of(a, dtype) for a in (jq, jk, jv))
    tbias = torch.from_numpy(bias) if exact else None
    tmask = torch.from_numpy(mask)
    out, row0, _, stats = recipe_forward(q, k, v, scale, tbias, tmask)
    dq, dk, dv, dbias = recipe_backward(
        q, k, v, out, torch_of(cots[0], dtype), stats, row0, scale, tbias,
        tmask, torch.from_numpy(g0), torch.from_numpy(gc) if exact else None,
        exact=exact)
    for label, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        close(got, w, dtype, label)
    if exact:
        close(dbias.sum(1), want[3], torch.float32 if dtype == torch.float32
              else dtype, "dbias")


def _merge(t):
    Bt, Ht, N, hd = t.shape
    return t.transpose(1, 2).reshape(Bt, N, Ht * hd)


def branch_recipe(x, ls, lb, wqkv, bqkv, wproj, bproj, dy, drow0, scale):
    """attend_branch_train forward and backward with the attention in the
    kernels' order (the normalised-P forward with its statistics, the
    shortcut backward); the rest as the port's plain branch."""
    dt = x.dtype
    Bx, N, D = x.shape
    x_hat, rstd = layer_norm_stats(x.float().reshape(Bx * N, D), EPS)
    ln = (x_hat * ls.float() + lb.float()).to(dt)
    qkv = linear_f32(ln, wqkv, bqkv).to(dt).reshape(Bx, N, 3 * D)
    q, k, v = packed_heads(qkv, H)
    out, row0, _, stats = recipe_forward(q, k, v, scale, norm_p=True)
    merged = _merge(out).reshape(Bx * N, D)
    branch = linear_f32(merged, wproj, bproj).to(dt)
    dyf = dy.to(dt).reshape(Bx * N, D).float()
    dattn = (dyf @ wproj.float()).to(dt).reshape(Bx, N, H, D // H) \
        .transpose(1, 2)
    dq, dk, dv, _ = recipe_backward(q, k, v, out, dattn, stats, row0, scale,
                                    drow0=drow0)
    dqkv = torch.stack([_merge(dq), _merge(dk), _merge(dv)], 2) \
        .reshape(Bx * N, 3 * D).float()
    dx, dls, dlb = layer_norm_bwd_ref(dqkv @ wqkv.float(), x_hat, rstd, ls)
    return (branch.reshape(Bx, N, D), row0), (
        dx.to(dt).reshape(Bx, N, D), dls, dlb, dqkv.T @ ln.float(),
        dqkv.sum(0), dyf.T @ merged.float(), dyf.sum(0))


@pytest.mark.parametrize("N,dtype_name", [(N, name) for N in WIDTHS
                                          for name in ("fp32", "bf16")])
def test_branch_vjp_matches_jax(N, dtype_name):
    dtype = DTYPES[dtype_name]
    D = H * HD
    rng = np.random.default_rng(200 + N)

    def rand(*shape, scale=1.0, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    x = rand(B, N, D)
    params = [rand(D, scale=0.1, shift=1.0), rand(D, scale=0.1),
              rand(D, 3 * D, scale=0.1), rand(3 * D, scale=0.1),
              rand(D, D, scale=0.1), rand(D, scale=0.1)]
    dy, drow0 = rand(B, N, D), rand(B, H, N)
    scale = HD ** -0.5
    jdt = JAX_DTYPES[dtype]
    (out_ref, row0_ref), vjp = jax.vjp(
        lambda *a: jax_attend_branch(*a, H, scale, EPS, True),
        jnp.asarray(x, jdt), *(jnp.asarray(a, jdt) for a in params))
    want = vjp((jnp.asarray(dy, jdt), jnp.asarray(drow0)))

    def leaf(a):  # Flax layout -> nn.Linear's [out, in]
        t = torch_of(jnp.asarray(a, jdt), dtype)
        return t.T.contiguous() if t.dim() == 2 else t

    (out, row0), grads = branch_recipe(
        torch_of(jnp.asarray(x, jdt), dtype), *map(leaf, params),
        torch_of(jnp.asarray(dy, jdt), dtype), torch.from_numpy(drow0),
        scale)
    close(out, out_ref, dtype, "branch")
    close(row0, row0_ref, dtype, "row0")
    names = ("dx", "d ln scale", "d ln bias", "d wqkv", "d bqkv", "d wproj",
             "d bproj")
    for label, got, w in zip(names, grads, want):
        w = np.asarray(w, dtype=np.float32)
        close(got.T if got.dim() == 2 and label != "dx" else got, w, dtype,
              label)
