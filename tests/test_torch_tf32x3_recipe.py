"""The arithmetic of the fp32 tensor-core kernels (3xTF32), in plain
PyTorch, against the JAX package.

``tokenreduction_tpu_torch/csrc/gemm_tf32_sm90.cu`` (the fp32 forward GEMM)
and ``csrc/short_attention.cu``'s ``short_attention_tf32_kernel`` (the fp32
square attention) multiply fp32 operands on the tensor cores as 3xTF32,
which a CPU cannot run as CUDA. This file writes that arithmetic out in
PyTorch and holds it against the JAX package on the same seeded numpy
inputs:

- ``tf32`` is ``cvt.rna.tf32.f32``'s rounding by bit arithmetic, as the
  kernels compute it (``csrc/common.cuh`` ``tf32_rna``): round to nearest,
  ties away from zero, 10 mantissa bits kept; ``split`` gives hi =
  tf32(x) and lo = tf32(x - hi), and hi + lo is x within 2^-22 of |x|;
- ``gemm3`` is the product over 8-deep K slices in the kernels' order:
  partials of ``step`` slices (the GEMM's K step of 32; all of K for a
  logit), each the small products (lo.hi, hi.lo; exact products of TF32
  values) of its slices first, then hi.hi, added to the fp32 sum; against
  ``jnp.dot`` at HIGHEST precision within 1e-5 of max|JAX| at K = 384 and
  1536, where one TF32 pass lands outside that bound (the card's
  accumulator truncates where this one rounds: chip_smoke.py holds the
  kernels to their plain versions on the card);
- the training forward's fc1 epilogue: GELU and GELU' (the port's
  ``gelu_grad``) of the 3xTF32 pre-activation plus bias, against the JAX
  package's fp32 ``_gelu_and_prime`` of ``jnp.dot`` at HIGHEST, at the
  fc1 widths of DeiT-Ti, -S and -B, within 1e-5 of max|JAX|;
- ``attention`` is the kernel's order: S = 3xTF32(q, k) * scale + bias,
  -FLT_MAX at a masked pair, the exact row max, P = exp(S - max), the sum,
  O = 3xTF32(P, v) over each half of the keys (a pair of warps, keys
  padded to chunks of 32), half 0 first, / sum, row0 and colsum of P /
  sum, against ``fused_attention`` in interpret mode at N = 4, 13, 68,
  197 with a bias and a mask whose image 0 has only CLS valid (fully
  masked query rows), within 1e-5 of max|JAX|.

The kernels' shared memory a block is checked where it is decided, by
static_asserts in their sources, and chip_smoke.py prints their plans as
the built library reports them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu.ops.flash_attention import (
    fused_attention as jax_fused_attention,
)
from tokenreduction_tpu.ops.fused_mlp_train import _gelu_and_prime
from tokenreduction_tpu_torch.ops.fused_mlp_train import gelu_grad

FLT_MAX = float(np.finfo(np.float32).max)
BOUND = 1e-5  # of max|JAX|
B, H, HD = 2, 2, 64


# ---- the kernels' arithmetic
def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: fp32 x rounded to 10 mantissa bits, to nearest
    with ties away from zero (add half of the dropped 13 bits' weight to
    the magnitude, then clear them), as an fp32 tensor."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def gemm3(a: torch.Tensor, b: torch.Tensor, step: int | None = None
          ) -> torch.Tensor:
    """a [..., M, K] . b [..., N, K]^T in 3xTF32 over K slices of 8: in
    partials of ``step`` slices (all of K if None), each the slices'
    lo.hi and hi.lo in turn, then their hi.hi, added to the fp32 sum."""
    ah, al = split(a)
    bh, bl = split(b)
    K = a.shape[-1]
    width = max(K, 1) if step is None else 8 * step  # K = 0: an empty sum
    acc = torch.zeros(*a.shape[:-1], b.shape[-2])
    for k0 in range(0, K, width):
        slices = [slice(k, k + 8) for k in range(k0, min(K, k0 + width), 8)]
        part = torch.zeros_like(acc)
        for s in slices:
            for x, y in ((al, bh), (ah, bl)):
                part = part + x[..., s] @ y[..., s].transpose(-1, -2)
        for s in slices:
            part = part + ah[..., s] @ bh[..., s].transpose(-1, -2)
        acc = acc + part
    return acc


def gemm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same product in one TF32 pass (hi.hi)."""
    return tf32(a) @ tf32(b).transpose(-1, -2)


def attention(q, k, v, scale, bias, mask):
    """(out [B, H, N, hd], row0 [B, H, N], colsum [B, H, N]) in the order
    of short_attention_tf32_kernel."""
    s = gemm3(q, k) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    if mask is not None:
        pair = mask[:, None, :, None] & mask[:, None, None, :]
        s = s.masked_fill(~pair, -FLT_MAX)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    r = 1.0 / e.sum(-1, keepdim=True)
    half = -(-e.shape[-1] // 32) * 16  # keys padded to chunks of 32
    vt = v.transpose(-1, -2)
    out = (gemm3(e[..., :half], vt[..., :half])
           + gemm3(e[..., half:], vt[..., half:])) * r
    p = e * r
    return out, p[:, :, 0], p.sum(2)


def rel(got, want) -> float:
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- the split
@pytest.mark.parametrize("seed", [0, 1])
def test_split_reproduces_x_within_2_pow_minus_22(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        (rng.standard_normal(20000) * 10.0 ** rng.uniform(-6, 6, 20000))
        .astype(np.float32))
    hi, lo = split(x)
    for part in (hi, lo):  # both are TF32: the 13 low bits clear
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # of TF32 at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp])
    assert torch.equal(tf32(x), want)


# ---- the GEMM
@pytest.mark.parametrize("K", [384, 1536])
def test_gemm_3xtf32_matches_jax_highest(K):
    rng = np.random.default_rng(K)
    a = rng.standard_normal((24, K)).astype(np.float32)
    b = rng.standard_normal((16, K)).astype(np.float32)
    want = jnp.dot(jnp.asarray(a), jnp.asarray(b).T,
                   precision="highest")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert rel(gemm3(ta, tb, step=4), want) <= BOUND  # K steps of 32
    # one TF32 pass is not enough: the reason for three
    assert rel(gemm1(ta, tb), want) > BOUND


@pytest.mark.parametrize("K", [192, 384, 768])  # DeiT-Ti, -S, -B
def test_gemm_3xtf32_gelu_grad_matches_jax(K):
    rng = np.random.default_rng(700 + K)
    x = rng.standard_normal((24, K)).astype(np.float32)
    w = (rng.standard_normal((32, K)) * K ** -0.5).astype(np.float32)
    b = (0.5 * rng.standard_normal(32)).astype(np.float32)
    pre = jnp.dot(jnp.asarray(x), jnp.asarray(w).T,
                  precision="highest") + jnp.asarray(b)
    want_gelu, want_grad = _gelu_and_prime(pre, jnp.float32)
    h = gemm3(torch.from_numpy(x), torch.from_numpy(w), step=4) \
        + torch.from_numpy(b)
    assert rel(torch.nn.functional.gelu(h), want_gelu) <= BOUND
    assert rel(gelu_grad(h), want_grad) <= BOUND


# ---- the attention
@pytest.mark.parametrize("N", [4, 13, 68, 197])
@pytest.mark.parametrize("kind", ["plain", "bias+mask"])
def test_attention_3xtf32_order_matches_jax(N, kind):
    rng = np.random.default_rng(300 + N)
    q, k, v = (rng.standard_normal((B, H, N, HD)).astype(np.float32)
               for _ in range(3))
    bias = mask = None
    if kind == "bias+mask":
        bias = np.log(rng.integers(1, 5, (B, N))).astype(np.float32)
        mask = rng.random((B, N)) > 0.3
        mask[:, 0] = True
        mask[0, 1:] = False  # image 0: every query row but CLS fully masked
    scale = HD ** -0.5
    want = jax_fused_attention(
        *map(jnp.asarray, (q, k, v)), scale,
        bias=None if bias is None else jnp.asarray(bias),
        mask=None if mask is None else jnp.asarray(mask), interpret=True)
    got = attention(*map(torch.from_numpy, (q, k, v)), scale,
                    None if bias is None else torch.from_numpy(bias),
                    None if mask is None else torch.from_numpy(mask))
    for label, g, w in zip(("out", "row0", "colsum"), got, want):
        assert rel(g, w) <= BOUND, label
