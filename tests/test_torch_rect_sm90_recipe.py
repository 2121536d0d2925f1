"""The arithmetic of the sm_90a rectangular attention, in plain PyTorch,
against the JAX package's rectangular kernels.

The rectangular variant of ``tokenreduction_tpu_torch/csrc/attention_sm90.cu``
(ATS's sampling blocks) computes in its own order, which a CPU cannot run
as CUDA. ``recipe_rect`` writes that order out:

- query tiles of 64 rows gathered through the kept ids (cp.async into the
  swizzled tiles), the rows past M zero;
- the key and value tiles of all N rows, zero past N;
- logits in base-2 units, q.k * scale * log2 e, -inf past N, capped at
  -FLT_MAX where the key token is invalid or the gathered query token is
  invalid (the mask at ids[b, m]); exp2 less the exact row max, in one
  pass over the whole row;
- the unnormalised exponentials rounded to the operand dtype before PV, the
  output scaled by 1/sum (the eval recipe), rows past M dropped.

It is held against ``fused_rect_attention`` and, with the port's plain out
projection and gathered residual around it, ``fused_rect_block`` of the JAX
package (Pallas in interpret mode) at (M, N) = 4x13, 13x50, 50x197 and
70x50 with a head dim of 64, on seeded numpy inputs whose kept rows pad
with copies of the CLS row and re-sample a dead token, under masks with
invalid tokens (one image with every token but CLS invalid). Bounds over each output's
max|JAX|: fp32 1e-4, bf16 2e-2 (both sides round the exponentials and the
output, at points that differ by the order of the arithmetic). A padded
row's output equals the CLS row's, and a fully masked row is the mean of
the N values.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu.ops import flash_attention as jax_fa
from tokenreduction_tpu_torch.ops.flash_attention import (
    linear_f32,
    packed_heads,
)
from torch_threads import one_torch_thread  # noqa: F401

B, H, HD = 2, 2, 64
D = H * HD
TILE = 64
LOG2E = 1.4426950408889634
FLT_MAX = float(np.finfo(np.float32).max)
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# ATS@0.25's sampling blocks, and more kept rows than keys (no model's)
PAIRS = ((4, 13), (13, 50), (50, 197), (70, 50))


def _pad_rows(t, rows):
    """t [..., R, hd] as fp32 with zero rows up to `rows`."""
    pad = torch.zeros(*t.shape[:-2], rows - t.shape[-2], t.shape[-1])
    return torch.cat([t.float(), pad], -2)


def recipe_rect(qkv, ids, mask, scale):
    """Merged heads [B, M, D] in qkv's dtype of the kept query rows ids
    [B, M] over all N keys, in the kernel's order."""
    dt = qkv.dtype
    Bq, N = mask.shape
    M = ids.shape[1]
    TQ, TK = -(-M // TILE) * TILE, -(-N // TILE) * TILE
    q, k, v = packed_heads(qkv, H)
    gathered = torch.gather(q, 2, ids.long()[:, None, :, None].expand(
        Bq, H, M, HD))
    qt, kt, vt = _pad_rows(gathered, TQ), _pad_rows(k, TK), _pad_rows(v, TK)
    bias2 = torch.full((TK,), -math.inf)
    bias2[:N] = 0.0
    kcap = torch.full((Bq, TK), -FLT_MAX)
    kcap[:, :N] = torch.where(mask, math.inf, -FLT_MAX)
    qcap = torch.full((Bq, TQ), -FLT_MAX)
    qcap[:, :M] = torch.where(torch.gather(mask, 1, ids.long()), math.inf,
                              -FLT_MAX)
    x = qt @ kt.transpose(-1, -2) * (scale * LOG2E) + bias2
    x = torch.minimum(torch.minimum(x, kcap[:, None, None, :]),
                      qcap[:, None, :, None])
    e = torch.exp2(x - x.amax(-1, keepdim=True))
    r = torch.where(torch.arange(TQ) < M, 1.0 / e.sum(-1), 0.0)
    out = (e.to(dt).float() @ vt) * r[..., None]
    return out[:, :, :M].to(dt).transpose(1, 2).reshape(Bq, M, D)


def rect_inputs(M, N, seed):
    """qkv [B, N, 3D], x [B, N, D], a validity mask [B, N] (CLS valid;
    image 1 with every other token invalid), the kept ids [B, M] (CLS,
    sorted samples with slot 1 re-sampling a dead token, pads of the CLS
    row at the tail), and out-projection weights in Flax's layout."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * D)).astype(np.float32)
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    mask = rng.random((B, N)) > 0.3
    mask[:, 0] = True
    mask[0, 1] = False
    mask[1, 1:] = False
    n = min(M - 1, N - 1) - 1
    ids = np.zeros((B, M), dtype=np.int32)
    for b in range(B):
        ids[b, 1:1 + n] = np.sort(1 + rng.permutation(N - 1)[:n])
        ids[b, 1] = np.flatnonzero(~mask[b])[0]
    wproj = (0.05 * rng.standard_normal((D, D))).astype(np.float32)
    bproj = (0.05 * rng.standard_normal(D)).astype(np.float32)
    return qkv, x, mask, ids, wproj, bproj


def torch_of(a, dtype):
    """A JAX array (bf16 values are exact in fp32) as a torch tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def close(got, want, dtype, what):
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= BOUND[dtype], f"{what}: {err:.3e} of max|JAX|"


CASES = [(M, N, name) for M, N in PAIRS for name in ("fp32", "bf16")]


@pytest.mark.parametrize("M,N,dtype_name", CASES)
def test_rect_attention_matches_jax(M, N, dtype_name):
    dtype = DTYPES[dtype_name]
    qkv, _, mask, ids, _, _ = rect_inputs(M, N, seed=M * 1000 + N)
    scale = HD ** -0.5
    jqkv = jnp.asarray(qkv, JAX_DTYPES[dtype])
    onehot = np.eye(N, dtype=np.float32)[ids]
    want = jax_fa.fused_rect_attention(jqkv, jnp.asarray(onehot),
                                       jnp.asarray(mask), H, scale,
                                       interpret=True)
    got = recipe_rect(torch_of(jqkv, dtype), torch.from_numpy(ids),
                      torch.from_numpy(mask), scale)
    assert got.dtype == dtype
    close(got, want, dtype, "merged heads")


@pytest.mark.parametrize("M,N,dtype_name", CASES)
def test_rect_block_matches_jax(M, N, dtype_name):
    """fused_rect_block: the recipe's attention, then the port's plain out
    projection and gathered residual (summed in fp32, rounded once)."""
    dtype = DTYPES[dtype_name]
    jdt = JAX_DTYPES[dtype]
    qkv, x, mask, ids, wproj, bproj = rect_inputs(M, N, seed=M * 1000 + N + 1)
    scale = HD ** -0.5
    jqkv, jx, jw, jb = (jnp.asarray(a, jdt) for a in (qkv, x, wproj, bproj))
    want = jax_fa.fused_rect_block(jqkv, jx, jnp.asarray(ids),
                                   jnp.asarray(mask), jw, jb, H, scale,
                                   interpret=True)
    tx = torch_of(jx, dtype)
    merged = recipe_rect(torch_of(jqkv, dtype), torch.from_numpy(ids),
                         torch.from_numpy(mask), scale)
    rows = torch.gather(tx, 1, torch.from_numpy(ids).long()[..., None]
                        .expand(-1, -1, D))
    got = (rows.float() + linear_f32(merged, torch_of(jw, dtype).T,
                                     torch_of(jb, dtype))).to(dtype)
    close(got, want, dtype, "block out")


@pytest.mark.parametrize("M,N", PAIRS)
def test_pads_copy_cls_and_dead_rows_are_uniform(M, N):
    """A slot padded with the CLS row gives the CLS slot's output bit for
    bit; a slot whose token is invalid (a fully masked query row) averages
    the values of all N keys; so does every row of the image whose only
    valid token is CLS, but CLS itself, which attends to CLS alone."""
    qkv, _, mask, ids, _, _ = rect_inputs(M, N, seed=M + N)
    out = recipe_rect(torch.from_numpy(qkv), torch.from_numpy(ids),
                      torch.from_numpy(mask), HD ** -0.5)
    for b in range(B):
        for m in range(1, M):
            if ids[b, m] == 0:
                assert torch.equal(out[b, m], out[b, 0])
    v_mean = torch.from_numpy(qkv[:, :, 2 * D:]).mean(1)
    dead = ~np.take_along_axis(mask, ids.astype(np.int64), 1)
    assert dead[:, 1].all()
    for b, m in zip(*np.nonzero(dead)):
        torch.testing.assert_close(out[b, m], v_mean[b], rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(out[1, 0].numpy(), qkv[1, 0, 2 * D:],
                               rtol=1e-5, atol=1e-5)
