"""The arithmetic of the wide attention kernels (above 256 tokens), in plain
PyTorch, against the JAX package's attention kernels.

``tokenreduction_tpu_torch/csrc/attention_wide_sm90.cu`` (bf16) and
``csrc/attention_wide_tf32.cu`` (fp32) walk the keys in 64-key tiles, which
a CPU cannot run as CUDA. This file writes their order out in PyTorch and
holds it against the JAX package on the CPU:

- query and key tiles of 64 rows, the padding rows zero; the rectangular
  variant's query rows gathered through the kept ids;
- logits in the kernels' units (bf16: base 2, q.k * scale * log2 e + bias *
  log2 e; fp32: natural), -FLT_MAX at a masked pair, -inf past N;
- pass 1 over the key tiles: the running row max and the sum of the
  exponentials rescaled by exp(old max - new max) whenever the max grows;
  these are the saved row statistics (the row max of the logits and
  1/sum);
- pass 2: P = exp(x - the final max); the eval recipe rounds the
  unnormalised P before PV and scales the output by 1/sum, NORM_P rounds
  the normalised P; O summed over the key tiles in order; colsum added per
  warp of 16 rows, query tile after query tile, the 4 warps summed in
  order;
- the backward: P from the statistics; delta in the shortcut form
  (rowsum(dO * O) + [i = 0] row0 . drow0) or in full (sum over the key
  tiles in order of P dP); dS = P (dP - delta), zero at a masked pair,
  rounded after the scale; dQ summed over the key tiles in order (one
  launch a query tile), dK, dV and dbias over the query tiles in order (one
  launch a key tile).

Against JAX's ``fused_attention`` (bias, mask), ``fused_attention_qkv``
(NORM_P), ``fused_block_attention`` (bias with the head-mean keys, a mask
with fully masked query rows, the idx prologue), ``fused_rect_attention``,
``attention_core_train`` (forward, and ``jax.vjp`` with non-zero row0 and
colsum cotangents) and ``attend_branch_train``'s ``jax.vjp``, each in
interpret mode, at N = 257, 290 and 577 (B = 2, H = 2, none a multiple of
16). Bounds, each over the tensor's max|JAX|: fp32 1e-4, bf16 2e-2; the
saved statistics within 1e-5 of JAX's logits' row max and 1/sum.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu.ops import flash_attention as jax_fa
from tokenreduction_tpu.ops.flash_attention_train import (
    attention_core_train as jax_attention_core,
)
from tokenreduction_tpu.ops.fused_block_train import (
    attend_branch_train as jax_attend_branch,
)
from tokenreduction_tpu_torch.ops.flash_attention import (
    head_mean_keys_ref,
    layer_norm_bwd_ref,
    layer_norm_stats,
    linear_f32,
    ln_qkv_ref,
    packed_heads,
)
from tokenreduction_tpu_torch.ops.gather import take_tokens

B, H, HD, EPS = 2, 2, 64, 1e-6
D = H * HD
WIDTHS = (257, 290, 577)
TILE = 64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
FLT_MAX = float(np.finfo(np.float32).max)
SCALE = HD ** -0.5
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs small products: in one thread, so that the
    test workers' thread pools do not contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the kernels' arithmetic
def _tiles(n):
    return -(-n // TILE) * TILE


def _pad_rows(t, rows):
    """t [..., R, hd] as fp32 with zero rows up to `rows`."""
    pad = torch.zeros(*t.shape[:-2], rows - t.shape[-2], t.shape[-1])
    return torch.cat([t.float(), pad], -2)


def _pad_vec(t, n, fill=0.0):
    """t [B, H, R] (or [B, R]) as fp32 padded with `fill` up to n."""
    pad = torch.full((*t.shape[:-1], n - t.shape[-1]), fill)
    return torch.cat([t.float(), pad], -1)


def wide_logits(q, k, scale, bias, q_valid, k_valid, base2):
    """The logits [B, H, TQ, TK] of the padded tiles in the kernels' units
    (base 2 for bf16, natural for fp32): the bias added after the scale,
    -FLT_MAX where the query or the key is invalid, -inf past N."""
    Bq, _, M, _ = q.shape
    N = k.shape[2]
    TQ, TK = _tiles(M), _tiles(N)
    c = LOG2E if base2 else 1.0
    b = torch.zeros(Bq, TK)
    if bias is not None:
        b[:, :N] = bias.float() * c
    x = _pad_rows(q, TQ) @ _pad_rows(k, TK).transpose(-1, -2) * (scale * c) \
        + b[:, None, None, :]
    if k_valid is not None:
        kv = torch.zeros(Bq, TK, dtype=torch.bool)
        kv[:, :N] = k_valid
        qv = torch.zeros(Bq, TQ, dtype=torch.bool)
        qv[:, :M] = q_valid
        x = torch.where(qv[:, None, :, None] & kv[:, None, None, :], x,
                        torch.tensor(-FLT_MAX))
    x[..., N:] = -math.inf
    return x


def recipe_forward(q, k, v, scale, bias=None, mask=None, norm_p=False,
                   ids=None):
    """(out [B, H, M, hd] in q's dtype, row0, colsum, stats [B, H, N, 2])
    in the wide forward's order; with ids [B, M] the rectangular variant
    (row0, colsum and stats None)."""
    dt = q.dtype
    base2 = dt == torch.bfloat16
    exp = torch.exp2 if base2 else torch.exp
    N = k.shape[2]
    q_valid = mask
    if ids is not None:
        ids = ids.long()
        q = torch.gather(q, 2, ids[:, None, :, None].expand(
            -1, q.shape[1], -1, q.shape[-1]))
        q_valid = torch.gather(mask, 1, ids)
    M = q.shape[2]
    x = wide_logits(q, k, scale, bias, q_valid, mask, base2)
    TQ, TK = x.shape[-2:]
    vp = _pad_rows(v, TK)
    # pass 1: the running statistics, key tile after key tile
    m = torch.full(x.shape[:-1], -math.inf)
    s = torch.zeros(x.shape[:-1])
    for j in range(0, TK, TILE):
        xt = x[..., j:j + TILE]
        n = torch.maximum(m, xt.amax(-1))
        s = s * exp(m - n) + exp(xt - n[..., None]).sum(-1)
        m = n
    r = torch.where(torch.arange(TQ) < M, 1.0 / s, 0.0)
    # pass 2: P from the final max
    o = torch.zeros(*x.shape[:-1], v.shape[-1])
    warps = torch.zeros(4, *x.shape[:2], TK)  # each warp's column sums
    row0 = torch.zeros(*x.shape[:2], TK)
    for j in range(0, TK, TILE):
        p = exp(x[..., j:j + TILE] - m[..., None])
        pn = p * r[..., None]
        o = o + (pn if norm_p else p).to(dt).float() @ vp[:, :, j:j + TILE]
        row0[..., j:j + TILE] = pn[:, :, 0]
        for qi in range(0, TQ, TILE):
            for w in range(4):
                rows = pn[:, :, qi + 16 * w:qi + 16 * w + 16]
                warps[w, ..., j:j + TILE] += rows.sum(2)
    out = (o if norm_p else o * r[..., None])[:, :, :M].to(dt)
    if ids is not None:
        return out, None, None, None
    colsum = ((warps[0] + warps[1]) + warps[2]) + warps[3]
    mx = torch.where(m == -FLT_MAX, m, m * LN2) if base2 else m
    stats = torch.stack([mx, r], -1)[:, :, :N]
    return out, row0[..., :N], colsum[..., :N], stats


def recipe_backward(q, k, v, out, dout, stats, row0, scale, bias=None,
                    mask=None, drow0=None, dcs=None, exact=False):
    """(dq, dk, dv in q's dtype, the per-head dbias [B, H, N] fp32) in the
    wide backward's order (bf16)."""
    dt, N = q.dtype, q.shape[-2]
    T = _tiles(N)
    valid = torch.arange(T) < N
    m = _pad_vec(stats[..., 0], T)
    r = _pad_vec(stats[..., 1], T)
    m2 = torch.where(valid, torch.where(m == -FLT_MAX, m, m * LOG2E),
                     math.inf)
    x = wide_logits(q, k, scale, bias, mask, mask, True)
    p = torch.exp2(x - m2[..., None]) * r[..., None]
    do = _pad_rows(dout, T)
    dp = do @ _pad_rows(v, T).transpose(-1, -2)
    if drow0 is not None:
        dp[:, :, 0, :N] += drow0.float()
    if dcs is not None:
        dp[:, :, :N, :N] += dcs.float()[:, :, None, :]
    if exact:
        delta = torch.zeros(p.shape[:-1])
        for j in range(0, T, TILE):
            delta = delta + (p[..., j:j + TILE] * dp[..., j:j + TILE]).sum(-1)
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
    pr = p.to(dt).float()
    qp, kp = _pad_rows(q, T), _pad_rows(k, T)
    dq = torch.zeros_like(qp)
    for j in range(0, T, TILE):  # a query tile's launch: key tile by tile
        dq = dq + ds[..., j:j + TILE] @ kp[:, :, j:j + TILE]
    dk, dv = torch.zeros_like(qp), torch.zeros_like(qp)
    dbias = torch.zeros(u.shape[:2] + u.shape[3:])
    for i in range(0, T, TILE):  # a key tile's launch: query tile by tile
        dk = dk + ds[:, :, i:i + TILE].transpose(-1, -2) @ qp[:, :, i:i + TILE]
        dv = dv + pr[:, :, i:i + TILE].transpose(-1, -2) @ do[:, :, i:i + TILE]
        dbias = dbias + u[:, :, i:i + TILE].sum(2)
    return (dq[:, :, :N].to(dt), dk[:, :, :N].to(dt), dv[:, :, :N].to(dt),
            dbias[..., :N])


# ---- inputs and checks
def rand(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def token_mask(rng, N):
    """A validity mask [B, N]: CLS valid, image 0 with only CLS valid (most
    of its query rows fully masked), image 1 about 70% valid."""
    mask = rng.random((B, N)) > 0.3
    mask[:, 0] = True
    mask[0, 1:] = False
    return mask


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


def check_stats(stats, jq, jk, bias, mask):
    """The saved statistics against JAX's logits' row max and 1/sum."""
    logits = jnp.einsum("bhid,bhjd->bhij", jq.astype(jnp.float32),
                        jk.astype(jnp.float32)) * SCALE
    if bias is not None:
        logits = logits + jnp.asarray(bias)[:, None, None, :]
    if mask is not None:
        pair = jnp.asarray(mask)[:, None, :, None] & \
            jnp.asarray(mask)[:, None, None, :]
        logits = jnp.where(pair, logits, -FLT_MAX)
    m = logits.max(-1)
    r = 1.0 / jnp.exp(logits - m[..., None]).sum(-1)
    stats = stats.numpy()
    for label, g, w in (("row max", stats[..., 0], m),
                        ("1/sum", stats[..., 1], r)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), label


# every option at one width or another, each width in both dtypes
ATTENTION_CASES = [(257, "plain", "fp32"), (257, "bias", "fp32"),
                   (290, "mask", "fp32"), (577, "bias+mask", "fp32"),
                   (257, "qkv", "bf16"), (290, "mask", "bf16"),
                   (577, "bias", "bf16")]


@pytest.mark.parametrize("N,kind,dtype_name", ATTENTION_CASES)
def test_attention_matches_jax(N, kind, dtype_name):
    """fused_attention (the eval recipe) and, for "qkv", fused_attention_qkv
    (NORM_P) with the bias and the mask, and the saved statistics."""
    dtype = DTYPES[dtype_name]
    jdt = JAX_DTYPES[dtype]
    rng = np.random.default_rng(N)
    qkv = [rand(rng, B, H, N, HD) for _ in range(3)]
    bias = np.log(rng.integers(1, 5, (B, N))).astype(np.float32)
    mask = token_mask(rng, N)
    bias = bias if kind in ("bias", "bias+mask", "qkv") else None
    mask = mask if kind in ("mask", "bias+mask", "qkv") else None
    jq, jk, jv = (jnp.asarray(a, jdt) for a in qkv)
    jbias = None if bias is None else jnp.asarray(bias)
    jmask = None if mask is None else jnp.asarray(mask)
    if kind == "qkv":
        packed = jnp.stack([jq, jk, jv], 0).transpose(1, 3, 0, 2, 4) \
            .reshape(B, N, 3 * D)
        out, row0, colsum = jax_fa.fused_attention_qkv(
            packed, H, SCALE, bias=jbias, mask=jmask, interpret=True)
        want = (out.reshape(B, N, H, HD).transpose(0, 2, 1, 3), row0, colsum)
    else:
        want = jax_fa.fused_attention(jq, jk, jv, SCALE, bias=jbias,
                                      mask=jmask, interpret=True)
    tq, tk, tv = (torch_of(a, dtype) for a in (jq, jk, jv))
    got = recipe_forward(tq, tk, tv, SCALE,
                         None if bias is None else torch.from_numpy(bias),
                         None if mask is None else torch.from_numpy(mask),
                         norm_p=kind == "qkv")
    for label, g, w in zip(("out", "row0", "colsum"), got, want):
        close(g, w, dtype, label)
    check_stats(got[3], jq, jk, bias, mask)


def block_params(rng):
    """LN1, qkv and proj parameters in Flax's layout."""
    return [rand(rng, D, scale=0.1, shift=1.0), rand(rng, D, scale=0.1),
            rand(rng, D, 3 * D, scale=0.1), rand(rng, 3 * D, scale=0.1),
            rand(rng, D, D, scale=0.1), rand(rng, D, scale=0.1)]


def leaf(a, dtype):
    """A Flax leaf as the port's operand (2-D kernels as [out, in])."""
    t = torch_of(a, dtype)
    return t.T.contiguous() if t.dim() == 2 else t


def recipe_block(x, params, bias=None, mask=None, idx=None):
    """fused_block_attention with the recipe's attention: (out, row0,
    colsum, keys)."""
    dt = x.dtype
    if idx is not None:
        x = take_tokens(x, idx)
    Bx, N, _ = x.shape
    ls, lb, wqkv, bqkv, wproj, bproj = params
    qkv = ln_qkv_ref(x, ls, lb, wqkv, bqkv, EPS)
    out, row0, colsum, _ = recipe_forward(*packed_heads(qkv, H), SCALE,
                                          bias, mask)
    merged = out.transpose(1, 2).reshape(Bx, N, D)
    y = (x.float() + linear_f32(merged, wproj, bproj)).to(dt)
    return y, row0, colsum, head_mean_keys_ref(qkv, H)


BLOCK_CASES = [(257, "idx", "fp32"), (290, "mask", "fp32"),
               (577, "bias+keys", "fp32"), (290, "bias+keys", "bf16"),
               (577, "idx", "bf16")]


@pytest.mark.parametrize("N,kind,dtype_name", BLOCK_CASES)
def test_block_attention_matches_jax(N, kind, dtype_name):
    """fused_block_attention: ToMe's bias with the head-mean keys, a mask
    with fully masked query rows, and DyViT's idx prologue (N -> 0.7 N,
    CLS and unsorted patch ids)."""
    dtype = DTYPES[dtype_name]
    jdt = JAX_DTYPES[dtype]
    rng = np.random.default_rng(1000 + N)
    x = rand(rng, B, N, D)
    params = block_params(rng)
    kw, tkw = {}, {}
    if kind == "bias+keys":
        bias = np.log(rng.integers(1, 5, (B, N))).astype(np.float32)
        kw, tkw = (dict(bias=jnp.asarray(bias), want_keys=True),
                   dict(bias=torch.from_numpy(bias)))
    elif kind == "mask":
        mask = token_mask(rng, N)
        kw, tkw = dict(mask=jnp.asarray(mask)), dict(mask=torch.from_numpy(
            mask))
    else:
        K = int(0.7 * (N - 1)) + 1
        idx = np.stack([np.concatenate([[0], 1 + rng.permutation(N - 1)[
            :K - 1]]) for _ in range(B)]).astype(np.int32)
        kw, tkw = dict(idx=jnp.asarray(idx)), dict(idx=torch.from_numpy(idx))
    want = jax_fa.fused_block_attention(
        jnp.asarray(x, jdt), *(jnp.asarray(a, jdt) for a in params), H,
        SCALE, eps=EPS, interpret=True, **kw)
    got = recipe_block(torch_of(jnp.asarray(x, jdt), dtype),
                       [leaf(jnp.asarray(a, jdt), dtype) for a in params],
                       **tkw)
    for label, g, w in zip(("out", "row0", "colsum", "keys"), got, want):
        close(g, w, dtype, label)


RECT_CASES = ((180, 257, "bf16"), (203, 290, "fp32"), (405, 577, "bf16"))


@pytest.mark.parametrize("M,N,dtype_name", RECT_CASES)
def test_rect_attention_matches_jax(M, N, dtype_name):
    """fused_rect_attention at ATS@0.7's shapes: CLS, sorted samples (slot
    1 a dead token), pads of the CLS row."""
    dtype = DTYPES[dtype_name]
    rng = np.random.default_rng(M * 1000 + N)
    qkv = rand(rng, B, N, 3 * D)
    mask = rng.random((B, N)) > 0.3
    mask[:, 0] = True
    mask[0, 1] = False
    ids = np.zeros((B, M), dtype=np.int32)
    n = M - 20
    for b in range(B):
        ids[b, 1:1 + n] = np.sort(1 + rng.permutation(N - 1)[:n])
        ids[b, 1] = np.flatnonzero(~mask[b])[0]
    jqkv = jnp.asarray(qkv, JAX_DTYPES[dtype])
    want = jax_fa.fused_rect_attention(
        jqkv, jnp.asarray(np.eye(N, dtype=np.float32)[ids]),
        jnp.asarray(mask), H, SCALE, interpret=True)
    q, k, v = packed_heads(torch_of(jqkv, dtype), H)
    out = recipe_forward(q, k, v, SCALE, mask=torch.from_numpy(mask),
                         ids=torch.from_numpy(ids))[0]
    close(out.transpose(1, 2).reshape(B, M, D), want, dtype, "merged heads")


@pytest.mark.parametrize("N,form", [(257, "exact"), (290, "shortcut"),
                                    (577, "exact")])
def test_core_vjp_matches_jax(N, form):
    """attention_core_train in bf16: the shortcut form as heuristic's
    masked core runs it (a mask, the row0 cotangent); the exact form as
    ToMe's core runs it (a bias, both cotangents, dbias), with the mask."""
    dtype = torch.bfloat16
    exact = form == "exact"
    rng = np.random.default_rng(2000 + N)
    qkv = [rand(rng, B, H, N, HD) for _ in range(3)]
    bias = np.log(rng.integers(1, 5, (B, N))).astype(np.float32)
    mask = token_mask(rng, N)
    g, g0, gc = rand(rng, B, H, N, HD), rand(rng, B, H, N), rand(rng, B, H, N)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in qkv)
    jbias = jnp.asarray(bias) if exact else None
    outs, vjp = jax.vjp(
        lambda q, k, v, b: jax_attention_core(q, k, v, SCALE, b,
                                              jnp.asarray(mask), True),
        jq, jk, jv, jbias)
    cots = (jnp.asarray(g, jnp.bfloat16), jnp.asarray(g0),
            jnp.asarray(gc) if exact else jnp.zeros_like(jnp.asarray(gc)))
    want = vjp(cots)
    q, k, v = (torch_of(a, dtype) for a in (jq, jk, jv))
    tbias = torch.from_numpy(bias) if exact else None
    tmask = torch.from_numpy(mask)
    out, row0, colsum, stats = recipe_forward(q, k, v, SCALE, tbias, tmask)
    for label, got, w in zip(("out", "row0", "colsum"), (out, row0, colsum),
                             outs):
        close(got, w, dtype, label)
    dq, dk, dv, dbias = recipe_backward(
        q, k, v, out, torch_of(cots[0], dtype), stats, row0, SCALE, tbias,
        tmask, torch.from_numpy(g0), torch.from_numpy(gc) if exact else None,
        exact=exact)
    for label, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        close(got, w, dtype, label)
    if exact:
        close(dbias.sum(1), want[3], dtype, "dbias")


def branch_recipe(x, ls, lb, wqkv, bqkv, wproj, bproj, dy, drow0):
    """attend_branch_train forward and backward with the attention in the
    wide kernels' order (the normalised-P forward with its statistics, the
    shortcut backward); the rest as the port's plain branch."""
    dt = x.dtype
    Bx, N, _ = x.shape
    x_hat, rstd = layer_norm_stats(x.float().reshape(Bx * N, D), EPS)
    ln = (x_hat * ls.float() + lb.float()).to(dt)
    qkv = linear_f32(ln, wqkv, bqkv).to(dt).reshape(Bx, N, 3 * D)
    q, k, v = packed_heads(qkv, H)
    out, row0, _, stats = recipe_forward(q, k, v, SCALE, norm_p=True)
    merged = out.transpose(1, 2).reshape(Bx * N, D)
    branch = linear_f32(merged, wproj, bproj).to(dt)
    dyf = dy.to(dt).reshape(Bx * N, D).float()
    dattn = (dyf @ wproj.float()).to(dt).reshape(Bx, N, H, HD) \
        .transpose(1, 2)
    grads = recipe_backward(q, k, v, out, dattn, stats, row0, SCALE,
                            drow0=drow0)[:3]
    dqkv = torch.stack([t.transpose(1, 2).reshape(Bx, N, D) for t in grads],
                       2).reshape(Bx * N, 3 * D).float()
    dx, dls, dlb = layer_norm_bwd_ref(dqkv @ wqkv.float(), x_hat, rstd, ls)
    return (branch.reshape(Bx, N, D), row0), (
        dx.to(dt).reshape(Bx, N, D), dls, dlb, dqkv.T @ ln.float(),
        dqkv.sum(0), dyf.T @ merged.float(), dyf.sum(0))


@pytest.mark.parametrize("N", (290, 577))
def test_branch_vjp_matches_jax(N):
    """attend_branch_train in bf16 (the amp step's attention halves)."""
    dtype, jdt = torch.bfloat16, jnp.bfloat16
    rng = np.random.default_rng(3000 + N)
    x = rand(rng, B, N, D)
    params = block_params(rng)
    dy, drow0 = rand(rng, B, N, D), rand(rng, B, H, N)
    (out_ref, row0_ref), vjp = jax.vjp(
        lambda *a: jax_attend_branch(*a, H, SCALE, EPS, True),
        jnp.asarray(x, jdt), *(jnp.asarray(a, jdt) for a in params))
    want = vjp((jnp.asarray(dy, jdt), jnp.asarray(drow0)))
    (out, row0), grads = branch_recipe(
        torch_of(jnp.asarray(x, jdt), dtype),
        *(leaf(jnp.asarray(a, jdt), dtype) for a in params),
        torch_of(jnp.asarray(dy, jdt), dtype), torch.from_numpy(drow0))
    close(out, out_ref, dtype, "branch")
    close(row0, row0_ref, dtype, "row0")
    names = ("dx", "d ln scale", "d ln bias", "d wqkv", "d bqkv", "d wproj",
             "d bproj")
    for label, got, w in zip(names, grads, want):
        close(got.T if got.dim() == 2 and label != "dx" else got, w, dtype,
              label)


def test_fully_masked_rows_stay_uniform():
    """A fully masked query row (every logit -FLT_MAX) is uniform over its
    N keys after the online pass: its running max never turns -inf - -inf
    into NaN, and its statistics are -FLT_MAX and 1/N."""
    N = 290
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rand(rng, B, H, N, HD)).to(torch.bfloat16)
               for _ in range(3))
    mask = torch.from_numpy(token_mask(rng, N))
    out, row0, colsum, stats = recipe_forward(q, k, v, SCALE, mask=mask)
    assert torch.isfinite(out.float()).all() and torch.isfinite(colsum).all()
    dead = ~mask[0]
    assert bool((stats[0, :, dead, 0] == -FLT_MAX).all())
    torch.testing.assert_close(stats[0, :, dead, 1],
                               torch.full_like(stats[0, :, dead, 1], 1 / N))
    uniform = v[0].float().mean(1, keepdim=True).expand(H, N, HD)
    close(out[0][:, dead], uniform[:, dead], torch.bfloat16, "dead rows")
