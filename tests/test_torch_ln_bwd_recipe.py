"""The order of the LayerNorm backward kernel, in plain PyTorch, against the
JAX package's training branches.

``layer_norm_bwd`` in ``tokenreduction_tpu_torch/csrc/ln_gemm.cu`` sums the
parameter gradients over the rows in its own fixed order, which a CPU
cannot run as CUDA. ``recipe_ln_bwd`` writes that order out:

- the bands of ``_build.ln_bwd_plan`` (the launcher's own plan): block i
  takes the consecutive rows [i * rows, min(M, (i + 1) * rows));
- warp w of a block (16 warps at K = 384, else 8) takes the band's rows
  w, w + warps, ... and sums their dLN * Xhat and dLN in fp32, row after
  row;
- the block adds its warps in index order into one partial row;
- the partial rows are added in block order, and d gamma and d beta are
  rounded once to the parameters' dtype;
- dx = rstd (dxhat - mean(dxhat) - Xhat mean(dxhat Xhat)), dxhat = dLN *
  gamma, with the two-pass fp32 statistics recomputed from x, rounded once
  to x's dtype.

The recipe replaces the plain LayerNorm backward inside the port's plain
backward of ``mlp_branch`` and ``attend_branch_train``, and both are held
against ``jax.vjp`` of the JAX package's kernels (Pallas in interpret mode,
as tests/test_torch_train_ops.py runs them) on seeded numpy inputs: dx,
d scale and d bias, each within fp32 1e-4 and bf16 2e-2 of its max|JAX|
(bf16: both sides round dLN's inputs and the outputs at points that differ
by the order of the arithmetic). The plan itself is checked too: every row
in exactly one band, no more bands than SMs, a ragged last band, and the
same plan for the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu.ops.fused_block_train import (
    attend_branch_train as jax_attend_branch,
)
from tokenreduction_tpu.ops.fused_mlp_train import mlp_branch as jax_mlp_branch
from tokenreduction_tpu_torch.ops import _build
from tokenreduction_tpu_torch.ops import fused_block_train, fused_mlp_train
from tokenreduction_tpu_torch.ops.flash_attention import (
    layer_norm_bwd_ref,
    layer_norm_stats,
)
from torch_threads import one_torch_thread  # noqa: F401

B, H, EPS = 2, 2, 1e-6
SMS = 4  # a small card: several bands at these row counts
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
CASES = [(N, D, name) for N in (4, 13, 68) for D in (64, 128)
         for name in ("fp32", "bf16")]


def kernel_warps(K: int) -> int:
    """Warps of a layer_norm_bwd block: the K = 384 instance's 16, the
    general instance's 8 (csrc/ln_gemm.cu LnBwd)."""
    return 16 if K == 384 else 8


def recipe_ln_bwd(x, w, dln, eps, sms):
    """(dx in x's dtype, d gamma, d beta in w's dtype) of LayerNorm rows x
    [M, K] with gamma w and the fp32 dLN [M, K], in the kernel's order."""
    M, K = x.shape
    x_hat, rstd = layer_norm_stats(x.float(), eps)
    d = dln.float()
    dxhat = d * w.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * x_hat).mean(-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - x_hat * m2)).to(x.dtype)
    rows_of = torch.cat([d * x_hat, d], 1)  # each row's [2K] terms
    bands, rows = _build.ln_bwd_plan(M, sms)
    warps = kernel_warps(K)
    total = torch.zeros(2 * K)
    for i in range(bands):
        start, end = i * rows, min(M, (i + 1) * rows)
        part = torch.zeros(2 * K)
        for wi in range(warps):
            acc = torch.zeros(2 * K)
            for m in range(start + wi, end, warps):
                acc = acc + rows_of[m]
            part = part + acc
        total = total + part
    dwb = total.to(w.dtype)
    return dx, dwb[:K], dwb[K:]


def rand(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def torch_of(a, dtype):
    """A JAX array (bf16 values are exact in fp32) as a torch tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def close(got, want, dtype, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= BOUND[dtype], f"{what}: {err:.3e} of max|JAX|"


def branch_grads(monkeypatch, module, bwd_ref, x, *args):
    """The port's plain backward of a branch with its LayerNorm backward
    taken in the kernel's order (the recipe in place of
    layer_norm_bwd_ref, reading the branch's own rows x)."""
    rows = x.reshape(-1, x.shape[-1])
    monkeypatch.setattr(
        module, "layer_norm_bwd_ref",
        lambda dln, x_hat, rstd, weight: recipe_ln_bwd(rows, weight, dln,
                                                       EPS, SMS))
    return bwd_ref(x, *args)


def leaf(a, jdt, dtype):
    """A Flax-layout array (cast to JAX's dtype) as a port leaf: 2-D
    kernels transposed into nn.Linear's [out, in]."""
    t = torch_of(jnp.asarray(a, jdt), dtype)
    return t.T.contiguous() if t.dim() == 2 else t


@pytest.mark.parametrize("N,D,dtype_name", CASES)
def test_mlp_branch_ln_bwd_matches_jax(N, D, dtype_name, monkeypatch):
    dtype = DTYPES[dtype_name]
    jdt = JAX_DTYPES[dtype]
    rng = np.random.default_rng(N * 1000 + D)
    x = rand(rng, B, N, D)
    params = [rand(rng, D, scale=0.1, shift=1.0), rand(rng, D, scale=0.1),
              rand(rng, D, 4 * D, scale=0.1), rand(rng, 4 * D, scale=0.05),
              rand(rng, 4 * D, D, scale=0.1), rand(rng, D, scale=0.05)]
    g = rand(rng, B, N, D)
    _, vjp = jax.vjp(lambda *a: jax_mlp_branch(*a, EPS, True),
                     jnp.asarray(x, jdt), *(jnp.asarray(a, jdt) for a in params))
    want = vjp(jnp.asarray(g, jdt))
    ls, lb, w1, b1, w2, _ = (leaf(a, jdt, dtype) for a in params)
    got = branch_grads(monkeypatch, fused_mlp_train,
                       fused_mlp_train.mlp_branch_bwd_ref,
                       torch_of(jnp.asarray(x, jdt), dtype), ls, lb, w1, b1,
                       w2, torch_of(jnp.asarray(g, jdt), dtype), EPS)
    for label, t, w in zip(("dx", "d ln scale", "d ln bias"), got[:3],
                           want[:3]):
        close(t, w, dtype, label)


@pytest.mark.parametrize("N,D,dtype_name", CASES)
def test_attend_branch_ln_bwd_matches_jax(N, D, dtype_name, monkeypatch):
    dtype = DTYPES[dtype_name]
    jdt = JAX_DTYPES[dtype]
    rng = np.random.default_rng(N * 1000 + D + 1)
    x = rand(rng, B, N, D)
    params = [rand(rng, D, scale=0.1, shift=1.0), rand(rng, D, scale=0.1),
              rand(rng, D, 3 * D, scale=0.1), rand(rng, 3 * D, scale=0.1),
              rand(rng, D, D, scale=0.1), rand(rng, D, scale=0.1)]
    dy, drow0 = rand(rng, B, N, D), rand(rng, B, H, N)
    scale = (D // H) ** -0.5
    _, vjp = jax.vjp(lambda *a: jax_attend_branch(*a, H, scale, EPS, True),
                     jnp.asarray(x, jdt), *(jnp.asarray(a, jdt) for a in params))
    want = vjp((jnp.asarray(dy, jdt), jnp.asarray(drow0)))
    ls, lb, wqkv, bqkv, wproj, _ = (leaf(a, jdt, dtype) for a in params)
    got = branch_grads(monkeypatch, fused_block_train,
                       fused_block_train.attend_branch_train_bwd_ref,
                       torch_of(jnp.asarray(x, jdt), dtype), ls, lb, wqkv,
                       bqkv, wproj, torch_of(jnp.asarray(dy, jdt), dtype),
                       torch.from_numpy(drow0), H, scale, EPS)
    for label, t, w in zip(("dx", "d ln scale", "d ln bias"), got[:3],
                           want[:3]):
        close(t, w, dtype, label)


@pytest.mark.parametrize("M", (8, 50, 6304))
def test_recipe_matches_plain_at_deit_width(M):
    """The K = 384 instance's order (16 warps a block, the H100's 132
    SMs) against the plain fp32 backward, including a ragged last band
    (M = 6304: B = 32, N = 197)."""
    rng = np.random.default_rng(M)
    x = torch.from_numpy(rand(rng, M, 384))
    w = torch.from_numpy(rand(rng, 384, scale=0.1, shift=1.0))
    dln = torch.from_numpy(rand(rng, M, 384))
    got = recipe_ln_bwd(x, w, dln, EPS, 132)
    x_hat, rstd = layer_norm_stats(x, EPS)
    for label, t, want in zip(("dx", "d scale", "d bias"), got,
                              layer_norm_bwd_ref(dln, x_hat, rstd, w)):
        close(t, want.numpy(), torch.float32, label)


PLANS = [(M, sms) for M in (1, 15, 16, 17, 500, 6304, 50432)
         for sms in (1, 4, 132)]


@pytest.mark.parametrize("M,sms", PLANS)
def test_plan_covers_every_row_once(M, sms):
    bands, rows = _build.ln_bwd_plan(M, sms)
    assert 1 <= bands <= sms
    covered = [m for i in range(bands)
               for m in range(i * rows, min(M, (i + 1) * rows))]
    assert covered == list(range(M))  # each row once, bands in order
    assert (bands - 1) * rows < M  # no empty band
    assert bands <= -(-M // _build.LN_BWD_WARPS)  # a band per 16 rows at most
    assert _build.ln_bwd_plan(M, sms) == (bands, rows)


def test_plan_main_path_shapes():
    """B = 256 at DeiT-S's widths: one band an SM of the H100; B = 32, N =
    197 (M = 6304): a ragged last band."""
    assert _build.ln_bwd_plan(256 * 197, 132) == (132, 383)
    bands, rows = _build.ln_bwd_plan(32 * 197, 132)
    assert (bands, rows) == (132, 48) and 32 * 197 - (bands - 1) * rows == 16
