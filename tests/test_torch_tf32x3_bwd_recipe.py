"""The arithmetic of the fp32 backward GEMM on the tensor cores (3xTF32),
in plain PyTorch, against the JAX package.

``tokenreduction_tpu_torch/csrc/gemm_tf32_bwd_sm90.cu`` runs the two fp32
GEMM layouts that only the training backward launches, dY . W (W read as
stored) and the weight gradient, as 3xTF32 on the tensor cores, which a CPU
cannot run as CUDA. This file writes that arithmetic out with the helpers
of ``tests/test_torch_tf32x3_recipe.py`` (``gemm3``: each operand split
into TF32 hi and lo parts, each K step of 32 a partial from zero, the small
products first, added to the fp32 sum) and holds it against the JAX package
on the same seeded numpy inputs, within 1e-5 of max|JAX|:

- dY . W (``dyw``) with the contracted dimension at DeiT-S's 1152 (qkv),
  384 (proj, fc2) and 1536 (fc1), against ``jnp.dot`` at HIGHEST; fc2's
  with the fp32 GELU' factor and its column sums per 128-row tile, the
  tiles added in order (db1's partials);
- the weight gradient (``wgrad``) at DeiT-S's four weight shapes over 1000
  rows (a ragged last K step), cut by ``_build.wgrad_split_tf32`` at 16
  SMs into several slices: each slice's 3xTF32 product over its rows (K
  steps from the slice's first row) and its column sums of dY, the slices
  added in order, against ``jnp.dot`` at HIGHEST contracting the rows and
  the column sums;
- the branch backwards composed from these (the plain backward's other
  intermediates, ``dyw`` and ``wgrad`` in place of its products) against
  the VJPs of the JAX package's ``mlp_branch`` and
  ``attend_branch_train`` in interpret mode: dW and db of qkv, proj, fc1
  and fc2;
- ``_build.wgrad_split_tf32``'s plan for DeiT-S's four weight gradients on
  the H100's 132 SMs at B = 256 and 32, N = 197: slices of whole K steps
  that cover the rows exactly, at least 90% of whole waves filled, and
  fp32 partials of at most 10% of the operands' bytes at B = 256; at B =
  32 no split count within that limit fills the waves, and the plan fills
  them with more (the fewest that do).

The tile (BM x BN x BK) is read from the kernel's source; chip_smoke.py
holds the kernel to its plain version on the card.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_tf32x3_recipe import gemm3, rel
from tokenreduction_tpu.ops.fused_block_train import (
    attend_branch_train as jax_attend_branch,
)
from tokenreduction_tpu.ops.fused_mlp_train import mlp_branch as jax_mlp_branch
from tokenreduction_tpu_torch.ops import _build
from tokenreduction_tpu_torch.ops.flash_attention import (
    layer_norm_stats,
    linear_f32,
)
from tokenreduction_tpu_torch.ops.fused_block_train import (
    attention_bwd_ref,
    attention_train_ref,
)
from tokenreduction_tpu_torch.ops.fused_mlp_train import gelu_grad

BOUND = 1e-5  # of max|JAX|
EPS = 1e-6
SOURCE = (pathlib.Path(_build.__file__).parent.parent / "csrc"
          / "gemm_tf32_bwd_sm90.cu").read_text()
TILE = {name.lower(): int(re.search(rf"constexpr int {name} = (\d+);",
                                    SOURCE).group(1))
        for name in ("BM", "BN", "BK")}
STEP = TILE["bk"] // 8  # the k8 slices of a K step
D, H4 = 384, 1536  # DeiT-S
SMS = 132  # the H100's
PARTIALS = 0.1  # the most the fp32 partials may weigh against the operands


# ---- the kernel's arithmetic
def dyw(dy, w, mul=None):
    """(Y, column sums) of Y = dY . W in 3xTF32 (W [K, n] as stored), the
    fp32 factor applied; the column sums per 128-row tile, the tiles added
    in order."""
    y = gemm3(dy, w.T, step=STEP)
    if mul is not None:
        y = y * mul
    sums = torch.zeros(y.shape[1])
    for t in range(0, y.shape[0], TILE["bm"]):
        sums = sums + y[t:t + TILE["bm"]].sum(0)
    return y, sums


def wgrad(dy, x, sms):
    """(dW [n_out, K], db [n_out]) of dy [M, n_out] and x [M, K]: each of
    wgrad_split_tf32's slices in 3xTF32 over its own rows, the slices
    added in order."""
    M, n_out = dy.shape
    splits, rows = _build.wgrad_split_tf32(M, n_out, x.shape[1], sms,
                                           **TILE)
    dw, db = torch.zeros(n_out, x.shape[1]), torch.zeros(n_out)
    for z in range(splits):
        cut = slice(z * rows, (z + 1) * rows)
        dw = dw + gemm3(dy[cut].T, x[cut].T, step=STEP)
        db = db + dy[cut].sum(0)
    return dw, db


def rand(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def highest(a, b):
    return jnp.dot(jnp.asarray(a), jnp.asarray(b), precision="highest")


# ---- dY . W
@pytest.mark.parametrize("layer,K,n", [("qkv", 3 * D, D), ("proj", D, D),
                                       ("fc1", H4, D)])
def test_dyw_3xtf32_matches_jax_highest(layer, K, n):
    """dY [M, K] . W [K, n] at DeiT-S's contracted widths (n cut to 64)."""
    rng = np.random.default_rng(K + n)
    dy = rand(rng, 300, K)
    w = rand(rng, K, 64, scale=K ** -0.5)
    y, _ = dyw(torch.from_numpy(dy), torch.from_numpy(w))
    assert rel(y, highest(dy, w)) <= BOUND


def test_dyw_fc2_factor_and_column_sums_match_jax():
    """fc2's dH = (dY . W2) * GELU'(h) and db1 = the column sums of dH:
    300 rows, three row tiles, the last ragged."""
    rng = np.random.default_rng(7)
    dy = rand(rng, 300, D)
    w2 = rand(rng, D, 96, scale=D ** -0.5)
    gp = gelu_grad(torch.from_numpy(rand(rng, 300, 96))).numpy()
    want = highest(dy, w2) * jnp.asarray(gp)
    dh, db1 = dyw(torch.from_numpy(dy), torch.from_numpy(w2),
                  torch.from_numpy(gp))
    assert rel(dh, want) <= BOUND
    assert rel(db1, want.sum(0)) <= BOUND


# ---- the weight gradient
@pytest.mark.parametrize("n_out,K", [(3 * D, D), (D, D), (H4, D), (D, H4)])
def test_wgrad_3xtf32_slices_match_jax_highest(n_out, K):
    """DeiT-S's four weight gradients over 1000 rows at 16 SMs: several
    slices, a ragged last K step."""
    M, sms = 1000, 16
    assert M % TILE["bk"]
    assert _build.wgrad_split_tf32(M, n_out, K, sms, **TILE)[0] > 1
    rng = np.random.default_rng(n_out * 3 + K)
    dy, x = rand(rng, M, n_out), rand(rng, M, K)
    dw, db = wgrad(torch.from_numpy(dy), torch.from_numpy(x), sms)
    assert rel(dw, highest(dy.T, x)) <= BOUND
    assert rel(db, jnp.asarray(dy).sum(0)) <= BOUND


# ---- the branch backwards
B, H = 2, 2
E2E_D = 64
E2E_SMS = 8


def torch_leaf(a):
    """A Flax-layout parameter as the port's: 2-D kernels in nn.Linear's
    [out, in]."""
    t = torch.from_numpy(np.asarray(a, dtype=np.float32))
    return t.T.contiguous() if t.dim() == 2 else t


def close(got, want, what):
    """got (the port's layout) within BOUND of want (JAX's, Flax layout)."""
    got = got.T if got.dim() == 2 else got
    err = rel(got, want)
    assert err <= BOUND, f"{what}: {err:.3e} of max|JAX|"


@pytest.mark.parametrize("N", [13, 68])
def test_mlp_branch_backward_matches_jax(N):
    """dW1, db1, dW2, db2 of mlp_branch: dH = (dY . W2) GELU'(h) with db1
    its tile sums, dW2 and db2 from dY and the hidden activation, dW1 from
    dH and the LayerNorm's output."""
    D = E2E_D
    rng = np.random.default_rng(N + 40)
    x = rand(rng, B, N, D)
    params = [rand(rng, D, scale=0.1, shift=1.0), rand(rng, D, scale=0.1),
              rand(rng, D, 4 * D, scale=0.1), rand(rng, 4 * D, scale=0.05),
              rand(rng, 4 * D, D, scale=0.1), rand(rng, D, scale=0.05)]
    g = rand(rng, B, N, D)
    _, vjp = jax.vjp(lambda *a: jax_mlp_branch(*a, EPS, True),
                     jnp.asarray(x), *(jnp.asarray(a) for a in params))
    want = vjp(jnp.asarray(g))
    ls, lb, w1, b1, w2, _ = (torch_leaf(a) for a in params)
    x_hat, _ = layer_norm_stats(torch.from_numpy(x).reshape(-1, D), EPS)
    ln = x_hat * ls + lb
    h = linear_f32(ln, w1, b1)
    a = F.gelu(h)
    gc = torch.from_numpy(g).reshape(-1, D)
    dh, db1 = dyw(gc, w2, gelu_grad(h))
    dw1, _ = wgrad(dh, ln, E2E_SMS)
    dw2, db2 = wgrad(gc, a, E2E_SMS)
    for label, got, w in zip(("d w1", "d b1", "d w2", "d b2"),
                             (dw1, db1, dw2, db2), want[3:]):
        close(got, w, label)


@pytest.mark.parametrize("N", [13, 68])
def test_attend_branch_backward_matches_jax(N):
    """dWqkv, dbqkv, dWproj, dbproj of attend_branch_train: dattn = dY .
    Wproj, the attention's plain backward, dWqkv and dbqkv from dqkv and
    the LayerNorm's output, dWproj and dbproj from dY and the merged
    heads."""
    D = E2E_D
    rng = np.random.default_rng(N + 50)
    x = rand(rng, B, N, D)
    params = [rand(rng, D, scale=0.1, shift=1.0), rand(rng, D, scale=0.1),
              rand(rng, D, 3 * D, scale=0.1), rand(rng, 3 * D, scale=0.1),
              rand(rng, D, D, scale=0.1), rand(rng, D, scale=0.1)]
    dy, drow0 = rand(rng, B, N, D), rand(rng, B, H, N)
    scale = (D // H) ** -0.5
    _, vjp = jax.vjp(lambda *a: jax_attend_branch(*a, H, scale, EPS, True),
                     jnp.asarray(x), *(jnp.asarray(a) for a in params))
    want = vjp((jnp.asarray(dy), jnp.asarray(drow0)))
    ls, lb, wqkv, bqkv, wproj, _ = (torch_leaf(a) for a in params)
    x_hat, _ = layer_norm_stats(torch.from_numpy(x).reshape(B * N, D), EPS)
    ln = x_hat * ls + lb
    qkv = linear_f32(ln, wqkv, bqkv).reshape(B, N, 3 * D)
    merged = attention_train_ref(qkv, H, scale)[0].reshape(B * N, D)
    dyc = torch.from_numpy(dy).reshape(B * N, D)
    dattn, _ = dyw(dyc, wproj)
    dqkv = attention_bwd_ref(qkv, dattn.reshape(B, N, D),
                             torch.from_numpy(drow0), H,
                             scale).reshape(B * N, 3 * D)
    dwqkv, dbqkv = wgrad(dqkv, ln, E2E_SMS)
    dwproj, dbproj = wgrad(dyc, merged, E2E_SMS)
    for label, got, w in zip(("d wqkv", "d bqkv", "d wproj", "d bproj"),
                             (dwqkv, dbqkv, dwproj, dbproj), want[3:]):
        close(got, w, label)


# ---- the split plan
@pytest.mark.parametrize("batch", [256, 32])
@pytest.mark.parametrize("layer,n_out,K", [("qkv", 3 * D, D),
                                           ("proj", D, D), ("fc1", H4, D),
                                           ("fc2", D, H4)])
def test_wgrad_plan_fills_the_h100(batch, layer, n_out, K):
    M = batch * 197
    splits, rows = _build.wgrad_split_tf32(M, n_out, K, SMS, **TILE)
    assert rows % TILE["bk"] == 0
    assert (splits - 1) * rows < M <= splits * rows  # no empty slice
    tiles = -(-n_out // TILE["bm"]) * -(-K // TILE["bn"])
    assert _build.wave_fill(splits * tiles, SMS) >= _build.WGRAD_FILL
    share = splits * n_out * K / (M * (n_out + K))
    if batch == 256:
        assert share <= PARTIALS
    else:  # no count of whole K steps within the limit fills the waves
        steps = -(-M // TILE["bk"])
        within = [s for s in range(1, steps + 1)
                  if s * n_out * K <= PARTIALS * M * (n_out + K)]
        assert max(_build.wave_fill(s * tiles, SMS) for s in within) \
            < _build.WGRAD_FILL
