"""The port's kernel counterparts against the JAX Pallas kernels.

Each test feeds the same seeded numpy arrays (fp32) to the JAX kernel,
run in interpret mode as tests/test_fused_kernels.py runs it, and to the
port's wrapper on CPU tensors, which runs its plain PyTorch version.
Weights go to the port transposed into nn.Linear's [out, in] layout.

Tolerance rtol = atol = 1e-5: the TPU kernels' rational erf is within
1.5e-7 of the exact erf the port uses, and the two sides sum in different
orders; both are far below 1e-5 at these magnitudes.

Widths: 17 (16 patches + CLS, not a multiple of 8) and the keep-0.25
stage widths of the tiny config, 5 and 2. At D=128 with 2 heads (hd 64)
and N <= 24 the JAX side takes its head-stacked path, a different
composition from its per-head path at D=32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu.ops.flash_attention import (
    fused_attention as jax_attention,
)
from tokenreduction_tpu.ops.flash_attention import (
    fused_block_attention as jax_block_attention,
)
from tokenreduction_tpu.ops.fused_full_block import (
    fused_full_block as jax_full_block,
)
from tokenreduction_tpu.ops.fused_mlp import (
    fused_mlp_gather_residual as jax_mlp_gather,
)
from tokenreduction_tpu.ops.fused_mlp import (
    fused_mlp_residual as jax_mlp_residual,
)
from tokenreduction_tpu_torch.ops.flash_attention import (
    fused_attention,
    fused_block_attention,
)
from tokenreduction_tpu_torch.ops.flash_attention_train import (
    attention_core_train,
)
from tokenreduction_tpu_torch.ops.fused_full_block import fused_full_block
from tokenreduction_tpu_torch.ops.fused_mlp import (
    fused_mlp_gather_residual,
    fused_mlp_residual,
)

TOL = dict(rtol=1e-5, atol=1e-5)
B = 2
DIMS = [(32, 2), (128, 2)]  # (D, heads): hd 16 per-head path, hd 64 stacked
EPS = 1e-6


def make_params(D, seed):
    """Seeded fp32 block params in Flax layout ([in, out] kernels)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(
        ls1=1 + r(D, scale=0.1), lb1=r(D, scale=0.1),
        wqkv=r(D, 3 * D), bqkv=r(3 * D), wproj=r(D, D), bproj=r(D),
        ls2=1 + r(D, scale=0.1), lb2=r(D, scale=0.1),
        w1=r(D, 4 * D), b1=r(4 * D), w2=r(4 * D, D), b2=r(D))


def jx(p, *names):
    return [jnp.asarray(p[n]) for n in names]


def th(p, *names):
    """Port operands: 2-D kernels transposed to [out, in]."""
    return [torch.from_numpy(np.ascontiguousarray(p[n].T if p[n].ndim == 2
                                                  else p[n]))
            for n in names]


def images(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


ATTN = ("ls1", "lb1", "wqkv", "bqkv", "wproj", "bproj")
MLP = ("ls2", "lb2", "w1", "b1", "w2", "b2")


@pytest.mark.parametrize("D,H", DIMS)
@pytest.mark.parametrize("N", [17, 5, 2])
def test_fused_full_block_matches_jax(D, H, N):
    p = make_params(D, seed=N)
    x = images((B, N, D), seed=100 + N)
    scale = (D // H) ** -0.5
    ref = jax_full_block(jnp.asarray(x), *jx(p, *ATTN, *MLP), H, scale,
                         eps=EPS, interpret=True)
    out = fused_full_block(torch.from_numpy(x), *th(p, *ATTN, *MLP), H,
                           scale, eps=EPS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("D,H", DIMS)
@pytest.mark.parametrize("N", [17, 5, 2])
def test_fused_block_attention_matches_jax(D, H, N):
    p = make_params(D, seed=N + 1)
    x = images((B, N, D), seed=200 + N)
    scale = (D // H) ** -0.5
    ref = jax_block_attention(jnp.asarray(x), *jx(p, *ATTN), H, scale,
                              eps=EPS, interpret=True)
    out = fused_block_attention(torch.from_numpy(x), *th(p, *ATTN), H, scale,
                                eps=EPS)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("D,H", DIMS)
@pytest.mark.parametrize("N,K", [(17, 12), (12, 8), (17, 5), (5, 2)])
def test_fused_mlp_gather_residual_matches_jax(D, H, N, K):
    p = make_params(D, seed=N + K)
    x = images((B, N, D), seed=300 + N)
    rng = np.random.default_rng(K)
    idx = np.stack([np.concatenate([[0], 1 + rng.permutation(N - 1)[:K - 1]])
                    for _ in range(B)]).astype(np.int32)
    ref = jax_mlp_gather(jnp.asarray(x), jnp.asarray(idx), *jx(p, *MLP),
                         eps=EPS, interpret=True)
    out = fused_mlp_gather_residual(torch.from_numpy(x),
                                    torch.from_numpy(idx), *th(p, *MLP),
                                    eps=EPS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("bad", [-1, 5])
def test_mlp_gather_refuses_out_of_range_ids(bad):
    """An id outside 0..N-1 raises instead of reading another image's
    rows (the kernel faults on the card for the same ids)."""
    p = make_params(32, seed=0)
    x = torch.from_numpy(images((B, 5, 32), seed=0))
    idx = torch.tensor([[0, 1], [0, bad]], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="out of bounds"):
        fused_mlp_gather_residual(x, idx, *th(p, *MLP), eps=EPS)


def log_sizes(shape, seed):
    """A ToMe bias: the log of merged-token sizes 1..4."""
    sizes = np.random.default_rng(seed).integers(1, 5, shape)
    return np.log(sizes).astype(np.float32)


@pytest.mark.parametrize("D,H", DIMS)
@pytest.mark.parametrize("N", [17, 5, 2])
def test_fused_block_attention_bias_and_keys_match_jax(D, H, N):
    """ToMe's extensions: the per-key bias and the head-mean keys."""
    p = make_params(D, seed=N + 2)
    x = images((B, N, D), seed=400 + N)
    bias = log_sizes((B, N), seed=N)
    scale = (D // H) ** -0.5
    ref = jax_block_attention(jnp.asarray(x), *jx(p, *ATTN), H, scale,
                              eps=EPS, bias=jnp.asarray(bias),
                              want_keys=True, interpret=True)
    out = fused_block_attention(torch.from_numpy(x), *th(p, *ATTN), H, scale,
                                eps=EPS, bias=torch.from_numpy(bias),
                                want_keys=True)
    assert len(out) == len(ref) == 4
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("D,H", DIMS)
@pytest.mark.parametrize("N", [17, 5, 2])
def test_fused_mlp_residual_matches_jax(D, H, N):
    p = make_params(D, seed=N + 3)
    x = images((B, N, D), seed=500 + N)
    ref = jax_mlp_residual(jnp.asarray(x), *jx(p, *MLP), eps=EPS,
                           interpret=True)
    out = fused_mlp_residual(torch.from_numpy(x), *th(p, *MLP), eps=EPS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("N,with_bias", [(17, True), (5, True), (17, False)])
def test_fused_attention_matches_jax(hd, N, with_bias):
    rng = np.random.default_rng(N + hd)
    q, k, v = (rng.standard_normal((B, 3, N, hd)).astype(np.float32)
               for _ in range(3))
    bias = log_sizes((B, N), seed=hd) if with_bias else None
    scale = hd ** -0.5
    ref = jax_attention(*map(jnp.asarray, (q, k, v)), scale,
                        bias=None if bias is None else jnp.asarray(bias),
                        interpret=True)
    out = fused_attention(*map(torch.from_numpy, (q, k, v)), scale,
                          bias=None if bias is None
                          else torch.from_numpy(bias))
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_refuse_unported_extensions():
    """Every extension of the TPU kernels is ported: the idx prologue
    (DyViT) and the training core's mask (heuristic) run. What the JAX
    kernels refuse the wrappers refuse too, instead of ignoring it: the
    idx prologue with a bias or a mask raises."""
    p = make_params(32, seed=0)
    x = torch.from_numpy(images((B, 5, 32), seed=0))
    idx = torch.tensor([[0, 3, 1], [0, 2, 4]], dtype=torch.int32)
    mask = torch.ones(B, 5, dtype=torch.bool)
    for kw in (dict(mask=mask), dict(bias=torch.zeros(B, 5))):
        with pytest.raises(ValueError, match="idx"):
            fused_block_attention(x, *th(p, *ATTN), 2, 0.25, idx=idx, **kw)
    assert fused_block_attention(x, *th(p, *ATTN), 2, 0.25,
                                 idx=idx)[0].shape == (B, 3, 32)
    q = torch.zeros(B, 2, 5, 16)
    assert attention_core_train(q, q, q, 0.25,
                                mask=mask)[0].shape == q.shape
    assert fused_block_attention(x, *th(p, *ATTN), 2, 0.25,
                                 mask=mask)[0].shape == x.shape
    assert fused_attention(q, q, q, 0.25, mask=mask)[0].shape == q.shape
