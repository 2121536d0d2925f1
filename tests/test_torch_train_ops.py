"""The port's training branches against the JAX custom-VJP Pallas kernels.

``mlp_branch``, ``attend_branch_train`` and ``attention_core_train`` of
the port run, on CPU tensors, their plain forward and their plain
hand-written backward. The
JAX kernels run in interpret mode, as tests/test_fused_kernels.py runs
them, forward and backward through ``jax.vjp``. Both sides get the same
seeded numpy inputs and cotangents in fp32, including non-zero
cotangents of the attention's row0 (and, for the core, of its colsum,
with a per-key bias); weights go to the port transposed
into nn.Linear's [out, in] layout and its weight gradients come back
transposed.

Bounds: outputs rtol = atol = 1e-5, gradients rtol = atol = 1e-4, the
bounds of the JAX kernels' own custom-VJP tests (the TPU kernels' rational
erf is within 1.5e-7 of the exact erf the port uses, and the sums run in
other orders). Each plain hand-written backward is also held against
torch.autograd of its plain forward at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu.ops.fused_block_train import (
    attend_branch_train as jax_attend_branch,
)
from tokenreduction_tpu.ops.flash_attention_train import (
    attention_core_train as jax_attention_core,
)
from tokenreduction_tpu.ops.fused_mlp_train import mlp_branch as jax_mlp_branch
from tokenreduction_tpu_torch.ops.flash_attention import fused_attention_ref
from tokenreduction_tpu_torch.ops.flash_attention_train import (
    attention_core_train,
    attention_core_train_bwd_ref,
)
from tokenreduction_tpu_torch.ops.fused_block_train import (
    attend_branch_train,
    attend_branch_train_bwd_ref,
    attend_branch_train_ref,
)
from tokenreduction_tpu_torch.ops.fused_mlp_train import (
    mlp_branch,
    mlp_branch_bwd_ref,
    mlp_branch_ref,
)
from torch_threads import one_torch_thread  # noqa: F401

B, H, EPS = 3, 2, 1e-6
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
REF_TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(N, D) for N in (12, 17) for D in (16, 32)]  # N 17: not 8k


def rand(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def attn_inputs(N, D, seed):
    """x, Flax-layout params, the branch and row0 cotangents."""
    rng = np.random.default_rng(seed)
    params = [rand(rng, D, scale=0.1, shift=1.0), rand(rng, D, scale=0.1),
              rand(rng, D, 3 * D, scale=0.1), rand(rng, 3 * D, scale=0.1),
              rand(rng, D, D, scale=0.1), rand(rng, D, scale=0.1)]
    return (rand(rng, B, N, D), params, rand(rng, B, N, D),
            rand(rng, B, H, N))


def mlp_inputs(N, D, seed):
    rng = np.random.default_rng(seed)
    params = [rand(rng, D, scale=0.1, shift=1.0), rand(rng, D, scale=0.1),
              rand(rng, D, 4 * D, scale=0.1), rand(rng, 4 * D, scale=0.05),
              rand(rng, 4 * D, D, scale=0.1), rand(rng, D, scale=0.05)]
    return rand(rng, B, N, D), params, rand(rng, B, N, D)


def to_torch(a):
    """A Flax-layout array as a port leaf: 2-D kernels transposed."""
    a = a.T if a.ndim == 2 else a
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()


def from_torch(t):
    a = t.detach().numpy()
    return a.T if a.ndim == 2 else a


def check_grads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(from_torch(g), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("N,D", SHAPES)
def test_mlp_branch_matches_jax(N, D):
    x, params, g = mlp_inputs(N, D, seed=N + D)
    out_ref, vjp = jax.vjp(lambda *a: jax_mlp_branch(*a, EPS, True),
                           jnp.asarray(x), *map(jnp.asarray, params))
    leaves = [torch.from_numpy(x).requires_grad_(), *map(to_torch, params)]
    out = mlp_branch(*leaves, EPS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               **OUT_TOL)
    check_grads(torch.autograd.grad(out, leaves, torch.from_numpy(g)),
                vjp(jnp.asarray(g)))


@pytest.mark.parametrize("N,D", SHAPES)
def test_attend_branch_train_matches_jax(N, D):
    x, params, g, g0 = attn_inputs(N, D, seed=N + D)
    scale = (D // H) ** -0.5
    (out_ref, row0_ref), vjp = jax.vjp(
        lambda *a: jax_attend_branch(*a, H, scale, EPS, True),
        jnp.asarray(x), *map(jnp.asarray, params))
    leaves = [torch.from_numpy(x).requires_grad_(), *map(to_torch, params)]
    out, row0 = attend_branch_train(*leaves, H, scale, EPS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               **OUT_TOL)
    np.testing.assert_allclose(row0.detach().numpy(), np.asarray(row0_ref),
                               **OUT_TOL)
    check_grads(torch.autograd.grad((out, row0), leaves,
                                    (torch.from_numpy(g),
                                     torch.from_numpy(g0))),
                vjp((jnp.asarray(g), jnp.asarray(g0))))


@pytest.mark.parametrize("N,D", SHAPES)
def test_mlp_branch_bwd_ref_matches_autograd(N, D):
    x, params, g = mlp_inputs(N, D, seed=2 * N + D)
    leaves = [torch.from_numpy(x).requires_grad_(), *map(to_torch, params)]
    g = torch.from_numpy(g)
    want = torch.autograd.grad(mlp_branch_ref(*leaves, EPS), leaves, g)
    got = mlp_branch_bwd_ref(*leaves[:6], g, EPS)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **REF_TOL)


@pytest.mark.parametrize("N,D", SHAPES)
def test_attend_branch_train_bwd_ref_matches_autograd(N, D):
    x, params, g, g0 = attn_inputs(N, D, seed=2 * N + D)
    scale = (D // H) ** -0.5
    leaves = [torch.from_numpy(x).requires_grad_(), *map(to_torch, params)]
    cots = (torch.from_numpy(g), torch.from_numpy(g0))
    want = torch.autograd.grad(
        attend_branch_train_ref(*leaves, H, scale, EPS), leaves, cots)
    got = attend_branch_train_bwd_ref(*leaves[:6], *cots, H, scale, EPS)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **REF_TOL)


def test_row0_cotangent_reaches_every_input():
    """A cotangent on row0 alone moves dx and the qkv and LN gradients
    (the softmax backward at query row 0), but not the out projection's."""
    x, params, _, g0 = attn_inputs(12, 16, seed=5)
    leaves = [torch.from_numpy(x).requires_grad_(), *map(to_torch, params)]
    out, row0 = attend_branch_train(*leaves, H, (16 // H) ** -0.5, EPS)
    grads = torch.autograd.grad((out, row0), leaves,
                                (torch.zeros_like(out), torch.from_numpy(g0)))
    dx, dls, dlb, dwqkv, dbqkv, dwproj, dbproj = grads
    for moved in (dx, dls, dlb, dwqkv, dbqkv):
        assert moved.abs().max() > 0
    assert dwproj.abs().max() == 0 and dbproj.abs().max() == 0


CORE_SHAPES = [(N, hd) for N in (12, 17) for hd in (16, 64)]


def core_inputs(N, hd, seed):
    """q, k, v [B, H, N, hd], a ToMe bias (log sizes) [B, N], and the
    cotangents of out, row0 and colsum."""
    rng = np.random.default_rng(seed)
    qkv = [rand(rng, B, H, N, hd) for _ in range(3)]
    bias = np.log(rng.integers(1, 5, (B, N))).astype(np.float32)
    return (qkv, bias, rand(rng, B, H, N, hd), rand(rng, B, H, N),
            rand(rng, B, H, N))


@pytest.mark.parametrize("N,hd", CORE_SHAPES)
def test_attention_core_train_matches_jax(N, hd):
    qkv, bias, g, g0, gc = core_inputs(N, hd, seed=N + hd)
    scale = hd ** -0.5
    outs_ref, vjp = jax.vjp(
        lambda q, k, v, b: jax_attention_core(q, k, v, scale, b, None, True),
        *map(jnp.asarray, qkv), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (*qkv, bias)]
    outs = attention_core_train(*leaves[:3], scale, leaves[3])
    for got, want in zip(outs, outs_ref):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **OUT_TOL)
    grads = torch.autograd.grad(outs, leaves, tuple(
        map(torch.from_numpy, (g, g0, gc))))
    for got, want in zip(grads, vjp(tuple(map(jnp.asarray, (g, g0, gc))))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("N,hd", CORE_SHAPES)
def test_attention_core_train_bwd_ref_matches_autograd(N, hd):
    qkv, bias, g, g0, gc = core_inputs(N, hd, seed=2 * N + hd)
    scale = hd ** -0.5
    leaves = [torch.from_numpy(a).requires_grad_() for a in (*qkv, bias)]
    cots = tuple(map(torch.from_numpy, (g, g0, gc)))
    want = torch.autograd.grad(
        fused_attention_ref(*leaves[:3], scale, bias=leaves[3]), leaves, cots)
    dq, dk, dv, dbias = attention_core_train_bwd_ref(
        *leaves[:3], leaves[3], *cots, scale)
    for a, b in zip((dq, dk, dv, dbias.sum(1)), want):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **REF_TOL)
