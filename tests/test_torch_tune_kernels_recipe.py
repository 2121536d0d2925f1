"""The arithmetic of the kernel tools' sm_90a kernels, in plain PyTorch,
against the JAX tool itself.

``tokenreduction_tpu_torch/csrc/mlp_chunked.cu`` (#13) and
``csrc/attn_joint.cu`` (#12) compute in their own order, which a CPU
cannot run as CUDA. This file writes that order out in PyTorch
(``recipe_mlp_chunked``, ``recipe_attn_joint``) and holds it against
``tools/tune_kernels.py``'s ``mlp_chunked`` and ``attn_joint``, their Pallas
kernels in interpret mode (``force_tpu_interpret_mode``, as
tests/test_torch_tools.py runs them), and the by-products against the JAX
package's ``fused_block_attention`` (the tool's kernel returns only the
block's output). The kernels' order:

- #13: LN in fp32, rounded; the hidden units in slices of 32, each slice's
  fc1 + b1 and exact GELU in fp32, rounded to the working dtype, its fc2
  product added to one fp32 accumulator slice after slice; x + acc, then
  + b2, rounded once;
- #12: for each (image, head), q, k, v = round(LN . Wqkv_h^T + bqkv_h) on
  64-row tiles, rows past N zeros; logits in base-2 units
  (q.k * scale * log2 e), key columns past N at -inf; exp2 less the exact
  row max, P = e * (1 / sum), rounded before the value product; row0 and
  colsum in fp32, colsum summed over a warp's 16 query rows as rows g and
  g + 8 and then a tree over g, over the query tiles in order, then over
  the four warps in order; the projection and the residual as the GEMM
  launch after the kernel.

Inputs: seeded numpy, the same to both sides; B = 2 with N = 13, 68 and
160 (160: three attention tiles in two passes of 128 rows, and 320 MLP
rows, two and a half blocks of 128). Bounds, each over the tensor's
max|JAX|: fp32 1e-4 (the two sides sum in other orders, and the JAX tool's
GELU takes a rational erf within 1.5e-7); bf16 2e-2 (each side rounds the
LN output, qkv or the hidden, the probabilities and the result to bf16,
and a sum that rounds apart moves a rounded value by an ulp, 2^-8).
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tokenreduction_tpu.ops.flash_attention import (
    fused_block_attention as jax_block_attention,
)
from tokenreduction_tpu_torch.ops.flash_attention import (
    layer_norm_f32,
    linear_f32,
    packed_heads,
)
from tokenreduction_tpu_torch.tools import _measure
from tools import tune_kernels as jax_tune

D, H, HD, EPS = 384, 6, 64, 1e-6
SCALE = HD ** -0.5
B = 2
WIDTHS = (13, 68, 160)
SLICE = 32     # mlp_chunked.cu's hidden units a slice
TILE = 64      # attn_joint.cu's rows a tile
LOG2E = 1.4426950408889634
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
PARAMS = ("ls", "lb", "wqkv", "bqkv", "wproj", "bproj")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny products in one thread (the test workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the kernels' arithmetic
def recipe_mlp_chunked(x, w):
    """x [B, N, D] -> x + fc2(gelu(fc1(LN x))) in mlp_chunked.cu's order
    (w in nn.Linear's layout)."""
    dt = x.dtype
    rows = x.reshape(-1, D).float()
    ln = layer_norm_f32(rows, w["ls"], w["lb"], EPS).to(dt).float()
    acc = torch.zeros_like(rows)
    for c0 in range(0, w["w1"].shape[0], SLICE):
        h = ln @ w["w1"][c0:c0 + SLICE].float().T \
            + w["b1"][c0:c0 + SLICE].float()
        h = (0.5 * h * (1.0 + torch.erf(h * 2 ** -0.5))).to(dt).float()
        acc = acc + h @ w["w2"][:, c0:c0 + SLICE].float().T
    return ((rows + acc) + w["b2"].float()).to(dt).view(x.shape)


def _colsum_order(p):
    """colsum of P [B, H, T, N] (rows past N zero, T a multiple of 64) in
    the kernel's order: per warp's 16 rows, rows g and g + 8 first, then a
    tree over g; over the query tiles in order; over the 4 warps in
    order."""
    Bn, Hn, T, N = p.shape
    r = p.view(Bn, Hn, T // TILE, 4, 2, 8, N)  # tile, warp, g + 8 half, g
    v = r[:, :, :, :, 0] + r[:, :, :, :, 1]
    v = v[..., 0::2, :] + v[..., 1::2, :]  # g pairs (0, 1), (2, 3), ...
    v = v[..., 0::2, :] + v[..., 1::2, :]
    v = (v[..., 0, :] + v[..., 1, :])      # [B, H, tiles, warps, N]
    cs = torch.zeros(Bn, Hn, 4, N)
    for tile in range(T // TILE):
        cs = cs + v[:, :, tile]
    return ((cs[:, :, 0] + cs[:, :, 1]) + cs[:, :, 2]) + cs[:, :, 3]


def recipe_attn_joint(x, w):
    """(x + proj(attn(qkv(LN1 x))), row0, colsum) in attn_joint.cu's
    order, with the layer_norm launch before it and the gemm(res=x)
    launch after it."""
    dt = x.dtype
    Bn, N, _ = x.shape
    T = -(-N // TILE) * TILE
    x32 = x.float()
    ln = layer_norm_f32(x32, w["ls"], w["lb"], EPS).to(dt)
    qkv = torch.zeros(Bn, T, 3 * D)
    qkv[:, :N] = linear_f32(ln, w["wqkv"], w["bqkv"]).to(dt).float()
    q, k, v = packed_heads(qkv, H)  # [B, H, T, 64], rows past N zero
    key_bias = torch.full((T,), -math.inf)
    key_bias[:N] = 0.0
    logits2 = q @ k.transpose(-1, -2) * (SCALE * LOG2E) + key_bias
    e = torch.exp2(logits2 - logits2.amax(-1, keepdim=True))
    r = torch.where(torch.arange(T) < N, 1.0 / e.sum(-1), 0.0)
    p = e * r[..., None]
    merged = (p.to(dt).float() @ v)[:, :, :N].to(dt)
    merged = merged.transpose(1, 2).reshape(Bn, N, D)
    out = (x32 + linear_f32(merged, w["wproj"], w["bproj"])).to(dt)
    return out, p[:, :, 0, :N], _colsum_order(p[..., :N])


# ---- the JAX side, once per width and dtype
def weights_np(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.05, shift=0.0):
        return (shift + scale * rng.standard_normal(shape)).astype(np.float32)

    return {"ls": r(D, scale=0.1, shift=1.0), "lb": r(D, scale=0.1),
            "wqkv": r(D, 3 * D), "bqkv": r(3 * D, scale=0.1),
            "wproj": r(D, D), "bproj": r(D, scale=0.1),
            "w1": r(D, 4 * D), "b1": r(4 * D, scale=0.1),
            "w2": r(4 * D, D), "b2": r(D, scale=0.1)}


@functools.lru_cache(maxsize=None)
def case(n: int, dtype: str):
    """(JAX weights, the port's weights, JAX x, the port's x): the values
    rounded to the dtype on the JAX side and carried across exactly."""
    jdt, tdt, _ = DTYPES[dtype]
    wj = {k: jnp.asarray(v, jdt) for k, v in weights_np(20).items()}
    wt = _measure.from_jax_layout(
        {k: np.asarray(v.astype(jnp.float32)) for k, v in wj.items()},
        dtype=tdt)
    x = np.random.default_rng(21).standard_normal((B, n, D)).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    return wj, wt, xj, xt


def close(got, want, tol, what):
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"{what}: {err:.3e} of max|JAX| > {tol}"


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_chunked_recipe_matches_jax(dtype, n):
    wj, wt, xj, xt = case(n, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_tune.mlp_chunked(xj, wj, 4)
    got = recipe_mlp_chunked(xt, wt)
    assert got.dtype == xt.dtype
    close(got, want, DTYPES[dtype][2], "mlp_chunked recipe")


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_joint_recipe_matches_jax(dtype, n):
    wj, wt, xj, xt = case(n, dtype)
    tol = DTYPES[dtype][2]
    with pltpu.force_tpu_interpret_mode():
        want = jax_tune.attn_joint(xj, wj, H, SCALE, B)
        _, row0_j, colsum_j = jax_block_attention(
            xj, *(wj[k] for k in PARAMS), H, SCALE)
    out, row0, colsum = recipe_attn_joint(xt, wt)
    close(out, want, tol, "attn_joint recipe")
    # the by-products, fp32 on both sides, from logits of q and k rounded to
    # the dtype (in bf16 each side's own rounding)
    close(row0, row0_j, tol, "row0")
    close(colsum, colsum_j, tol, "colsum")
    assert row0.dtype == colsum.dtype == torch.float32
    assert tuple(row0.shape) == tuple(colsum.shape) == (B, H, n)


def test_colsum_order_is_a_sum_over_the_query_rows():
    """The kernel's colsum order adds every valid query row once."""
    p = torch.rand(2, 3, 2 * TILE, 70)
    p[:, :, 100:] = 0.0
    torch.testing.assert_close(_colsum_order(p), p.sum(2), rtol=1e-6,
                               atol=1e-6)
