"""The order of the fixed-order partial sums and the lanes of the head-mean
keys, in plain PyTorch, against the JAX package's kernels.

``sum_partials_many`` in ``tokenreduction_tpu_torch/csrc/ln_gemm.cu`` adds,
in one launch per training branch backward, the fp32 partials that the
weight gradients write per slice of rows (``gemm_wgrad``), that db1 writes
per 128-row tile (``gemm``'s column sums) and that the LayerNorm backward
writes per band of rows: each column in z order from 0, rounded once to
the gradient's dtype. A CPU cannot run it as CUDA, so the tests here write
its order out:

- the order (``_build.sum_order``): the tallest jobs first, the same
  order for the same shapes, and job sets larger than one launch's table
  (``SUM_JOBS``, the C entry's ``kSumJobs``) split into launches in
  order; and, in that order, the blocks that ``tr_sum_partials_many``
  gives each job (``c_blocks``, its rule written out with its constants
  read from the source): every column of every job in exactly one
  thread's columns, four-column threads only where a float4 a row fits,
  and the sums, column by column, equal to each job summed alone bit for
  bit;
- the sums themselves (``recipe_wgrad``): the partials of
  ``_build.wgrad_split``'s slices (the bf16 GEMM's 128 x 192 x 64 tile on
  the H100's 132 SMs), each slice's product and column sums in fp32, added
  in slice order, and db1's 128-row tiles likewise, in place of the plain
  backward's sums inside the branches' plain backward, held against
  ``jax.vjp`` of the JAX package's ``attend_branch_train`` and
  ``mlp_branch`` (Pallas in interpret mode, as
  tests/test_torch_ln_bwd_recipe.py runs them): every weight and bias
  gradient within fp32 1e-4 and bf16 2e-2 of its max|JAX| (bf16: both
  sides round their operands at points that differ by the order of the
  arithmetic);
- ``head_mean_keys``' reference: ``head_mean_keys_ref`` (the fp32 sum in
  head order from head 0, one true division by H, one rounding, which
  the kernel's 16-byte lanes keep bit for bit on the card) against JAX's
  ``want_keys`` by-product of ``fused_block_attention`` within the same
  bounds.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tokenreduction_tpu.ops.flash_attention import (
    fused_block_attention as jax_block_attention,
)
from tokenreduction_tpu.ops.fused_block_train import (
    attend_branch_train as jax_attend_branch,
)
from tokenreduction_tpu.ops.fused_mlp_train import mlp_branch as jax_mlp_branch
from tokenreduction_tpu_torch.ops import _build
from tokenreduction_tpu_torch.ops.flash_attention import (
    head_mean_keys_ref,
    layer_norm_stats,
    linear_f32,
    ln_qkv_ref,
)
from tokenreduction_tpu_torch.ops.fused_block_train import (
    attention_bwd_ref,
    attention_train_ref,
)
from tokenreduction_tpu_torch.ops.fused_mlp_train import gelu_grad
from torch_threads import one_torch_thread  # noqa: F401

B, H, EPS = 2, 2, 1e-6
SMS = 132  # the H100's SMs
TILE = dict(bm=128, bn=192, bk=64)  # the bf16 GEMM's (chip_smoke phase 1)
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
CASES = [(N, D, name) for N in (4, 13, 68) for D in (64, 128)
         for name in ("fp32", "bf16")]


def z_sum(parts):
    """fp32 partial rows [S, L] added in z order from 0."""
    acc = torch.zeros(parts.shape[1:])
    for row in parts:
        acc = acc + row
    return acc


def recipe_wgrad(dy, x, sms=SMS):
    """(dW [n_out, K], db [n_out]) in fp32 from the fp32 values of dy
    [M, n_out] and x [M, K], in the kernels' order: each slice of
    ``wgrad_split``'s product and column sums, the slices then added in
    order."""
    M, n_out = dy.shape
    splits, rows = _build.wgrad_split(M, n_out, x.shape[1], sms, **TILE)
    cuts = [slice(z * rows, (z + 1) * rows) for z in range(splits)]
    return (z_sum(torch.stack([dy[c].T @ x[c] for c in cuts])),
            z_sum(torch.stack([dy[c].sum(0) for c in cuts])))


def recipe_col_sums(d):
    """The column sums of fp32 rows d [M, L] per 128-row tile (the GEMM's
    col_sums), the tiles then added in order."""
    tile = _build.GEMM_TILE
    return z_sum(torch.stack([d[t:t + tile].sum(0)
                              for t in range(0, d.shape[0], tile)]))


def attend_sums(x, ls, lb, wqkv, bqkv, wproj, dy, drow0, scale):
    """(dwqkv, dbqkv, dwproj, dbproj) of the attention branch: the
    intermediates of the plain backward (attend_branch_train_bwd_ref), the
    sums in the kernels' order."""
    dt = x.dtype
    _, N, D = x.shape
    x_hat, _ = layer_norm_stats(x.float().reshape(B * N, D), EPS)
    ln = (x_hat * ls.float() + lb.float()).to(dt)
    qkv = linear_f32(ln, wqkv, bqkv).to(dt).reshape(B, N, 3 * D)
    merged = attention_train_ref(qkv, H, scale)[0].reshape(B * N, D).float()
    dyc = dy.to(dt).reshape(B * N, D).float()
    dattn = (dyc @ wproj.float()).to(dt)
    dqkv = attention_bwd_ref(qkv, dattn.reshape(B, N, D), drow0, H,
                             scale).reshape(B * N, 3 * D).float()
    dwqkv, dbqkv = recipe_wgrad(dqkv, ln.float())
    dwproj, dbproj = recipe_wgrad(dyc, merged)
    return (dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype),
            dwproj.to(wproj.dtype), dbproj.to(ls.dtype))


def mlp_sums(x, ls, lb, w1, b1, w2, g):
    """(dw1, db1, dw2, db2) of the MLP branch: the intermediates of the
    plain backward (mlp_branch_bwd_ref), the sums in the kernels' order
    (db1 from the fp32 dH's row tiles)."""
    dt, D = x.dtype, x.shape[-1]
    x_hat, _ = layer_norm_stats(x.float().reshape(-1, D), EPS)
    ln = (x_hat * ls.float() + lb.float()).to(dt)
    h = linear_f32(ln, w1, b1)
    a = F.gelu(h).to(dt)
    gc = g.to(dt).reshape(-1, D).float()
    dh = (gc @ w2.float()) * gelu_grad(h)
    dw1, _ = recipe_wgrad(dh.to(dt).float(), ln.float())
    dw2, db2 = recipe_wgrad(gc, a.float())
    return (dw1.to(w1.dtype), recipe_col_sums(dh).to(b1.dtype),
            dw2.to(w2.dtype), db2.to(b1.dtype))


def rand(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def torch_of(a, dtype):
    """A JAX array (bf16 values are exact in fp32) as a torch tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def leaf(a, jdt, dtype):
    """A Flax-layout array (cast to JAX's dtype) as a port leaf: 2-D
    kernels transposed into nn.Linear's [out, in]."""
    t = torch_of(jnp.asarray(a, jdt), dtype)
    return t.T.contiguous() if t.dim() == 2 else t


def close(got, want, dtype, what):
    """got (port layout) within the bound of want (JAX's, Flax layout)."""
    got = got.detach().float()
    got = (got.T if got.dim() == 2 else got).numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= BOUND[dtype], f"{what}: {err:.3e} of max|JAX|"


@pytest.mark.parametrize("N,D,dtype_name", CASES)
def test_mlp_branch_sums_match_jax(N, D, dtype_name):
    dtype = DTYPES[dtype_name]
    jdt = JAX_DTYPES[dtype]
    rng = np.random.default_rng(N * 1000 + D + 2)
    x = rand(rng, B, N, D)
    params = [rand(rng, D, scale=0.1, shift=1.0), rand(rng, D, scale=0.1),
              rand(rng, D, 4 * D, scale=0.1), rand(rng, 4 * D, scale=0.05),
              rand(rng, 4 * D, D, scale=0.1), rand(rng, D, scale=0.05)]
    g = rand(rng, B, N, D)
    _, vjp = jax.vjp(lambda *a: jax_mlp_branch(*a, EPS, True),
                     jnp.asarray(x, jdt), *(jnp.asarray(a, jdt) for a in params))
    want = vjp(jnp.asarray(g, jdt))
    ls, lb, w1, b1, w2, _ = (leaf(a, jdt, dtype) for a in params)
    got = mlp_sums(torch_of(jnp.asarray(x, jdt), dtype), ls, lb, w1, b1, w2,
                   torch_of(jnp.asarray(g, jdt), dtype))
    for label, t, w in zip(("d w1", "d b1", "d w2", "d b2"), got, want[3:]):
        close(t, w, dtype, label)


@pytest.mark.parametrize("N,D,dtype_name", CASES)
def test_attend_branch_sums_match_jax(N, D, dtype_name):
    dtype = DTYPES[dtype_name]
    jdt = JAX_DTYPES[dtype]
    rng = np.random.default_rng(N * 1000 + D + 3)
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
    got = attend_sums(torch_of(jnp.asarray(x, jdt), dtype), ls, lb, wqkv,
                      bqkv, wproj, torch_of(jnp.asarray(dy, jdt), dtype),
                      torch.from_numpy(drow0), scale)
    for label, t, w in zip(("d wqkv", "d bqkv", "d wproj", "d bproj"), got,
                           want[3:]):
        close(t, w, dtype, label)


@pytest.mark.parametrize("n_out,K", [(1152, 384), (384, 384), (1536, 384),
                                     (384, 1536)])
def test_wgrad_recipe_matches_plain_at_deit_width(n_out, K):
    """DeiT-S's four weight gradients at B = 32, N = 197 (M = 6304: a
    ragged last slice), the recipe against the plain fp32 products."""
    M = 32 * 197
    rng = np.random.default_rng(n_out + K)
    dy = torch.from_numpy(rand(rng, M, n_out))
    x = torch.from_numpy(rand(rng, M, K))
    assert _build.wgrad_split(M, n_out, K, SMS, **TILE)[0] > 1
    dw, db = recipe_wgrad(dy, x)
    for got, want in ((dw, dy.T @ x), (db, dy.sum(0))):
        err = (got - want).abs().max() / want.abs().max()
        assert err <= BOUND[torch.float32]


def branch_jobs(M, D=384, H4=1536):
    """The [S, L] partials of each DeiT-S branch backward's sum launch at
    M rows on the H100 (in the order the branches hand them over)."""
    bands = _build.ln_bwd_plan(M, SMS)[0]

    def wg(n_out, K):
        return _build.wgrad_split(M, n_out, K, SMS, **TILE)[0]

    attention = [(wg(D, D), D * D), (wg(D, D), D), (wg(3 * D, D), 3 * D * D),
                 (wg(3 * D, D), 3 * D), (bands, 2 * D)]
    mlp = [(-(-M // _build.GEMM_TILE), H4), (wg(D, H4), D * H4),
           (wg(D, H4), D), (wg(H4, D), H4 * D), (bands, 2 * D)]
    return attention, mlp


EIGHT = [(7, 1152), (132, 768), (1, 4), (394, 1536), (22, 147456),
         (9, 1001), (5, 10), (3, 589824)]
JOB_SETS = {
    "attention B=256 N=197": branch_jobs(256 * 197)[0],
    "mlp B=256 N=197": branch_jobs(256 * 197)[1],
    "attention B=256 N=68": branch_jobs(256 * 68)[0],
    "mlp B=256 N=68": branch_jobs(256 * 68)[1],
    "eight": EIGHT,
    "nine": EIGHT + [(13, 333)],
    "empty and zero rows": [(3, 0), (0, 12), (40, 7), (40, 8)],
}


SUM_SOURCE = (pathlib.Path(_build.__file__).parent.parent / "csrc"
              / "ln_gemm.cu").read_text()
SUM_C = {name: int(re.search(rf"\b{name} = (\d+)", SUM_SOURCE).group(1))
         for name in ("kSumJobs", "kSumThreads", "kSumTall")}


def c_blocks(shapes, launch):
    """[(job, its first block, its blocks, its columns a thread)] of one
    launch of ``tr_sum_partials_many`` on the jobs ``launch`` (indices into
    ``shapes``, in launch order): its rule, written out."""
    out, first = [], 0
    for j in launch:
        S, L = shapes[j]
        cols = 4 if S <= SUM_C["kSumTall"] and L % 4 == 0 else 1
        blocks = -(-L // (SUM_C["kSumThreads"] * cols))
        out.append((j, first, blocks, cols))
        first += blocks
    return out


def thread_columns(L, blocks, cols):
    """Each thread's (first column, columns) of a job of width L over its
    blocks."""
    for b in range(blocks):
        for t in range(SUM_C["kSumThreads"]):
            c0 = (b * SUM_C["kSumThreads"] + t) * cols
            if c0 < L:
                yield c0, min(cols, L - c0)


def test_sum_jobs_is_the_c_table_size():
    assert _build.SUM_JOBS == SUM_C["kSumJobs"]


@pytest.mark.parametrize("name", JOB_SETS)
def test_plan_covers_every_column_once(name):
    shapes = JOB_SETS[name]
    launches = _build.sum_order(shapes)
    assert sorted(j for launch in launches for j in launch) == \
        list(range(len(shapes)))
    for launch in launches:
        assert 1 <= len(launch) <= _build.SUM_JOBS
        for j, _, blocks, cols in c_blocks(shapes, launch):
            S, L = shapes[j]
            covered = [c0 + c for c0, n in thread_columns(L, blocks, cols)
                       for c in range(n)]
            assert covered == list(range(L))  # each column once, in order
            if cols == 4:  # a float4 a row fits
                assert L % 4 == 0 and S <= SUM_C["kSumTall"]


@pytest.mark.parametrize("name", JOB_SETS)
def test_plan_runs_tall_jobs_first(name):
    shapes = JOB_SETS[name]
    for launch in _build.sum_order(shapes):
        heights = [shapes[j][0] for j in launch]
        assert heights == sorted(heights, reverse=True)
        for a, b in zip(launch, launch[1:]):  # equal heights keep their order
            assert shapes[a][0] > shapes[b][0] or a < b
    assert _build.sum_order(list(shapes)) == _build.sum_order(tuple(shapes))


@pytest.mark.parametrize("n", [9, 16, 17])
def test_plan_splits_large_sets_in_order(n):
    shapes = [(1 + j % 5, 64 * (j + 1)) for j in range(n)]
    launches = _build.sum_order(shapes)
    assert len(launches) == -(-n // _build.SUM_JOBS)
    for i, launch in enumerate(launches):
        jobs = range(i * _build.SUM_JOBS, min(n, (i + 1) * _build.SUM_JOBS))
        assert sorted(launch) == list(jobs)


@pytest.mark.parametrize("name", ["eight", "nine", "empty and zero rows"])
def test_plan_sums_equal_each_job_alone(name):
    """The batched launch in sum_order's order, each thread adding its
    columns' rows in z order from 0, gives every job's single sum bit for
    bit."""
    shapes = JOB_SETS[name]
    gen = torch.Generator().manual_seed(len(shapes))
    parts = [torch.randn(S, L, generator=gen) for S, L in shapes]
    outs = [torch.full((L,), float("nan")) for _, L in shapes]
    for launch in _build.sum_order(shapes):
        for j, _, blocks, cols in c_blocks(shapes, launch):
            for c0, n in thread_columns(shapes[j][1], blocks, cols):
                outs[j][c0:c0 + n] = z_sum(parts[j][:, c0:c0 + n])
    for part, out in zip(parts, outs):
        assert torch.equal(out, z_sum(part))


KEYS_CASES = [(D, heads, N, name) for D, heads in ((128, 2), (96, 3),
                                                   (60, 3))
              for N in (5, 17) for name in ("fp32", "bf16")]


@pytest.mark.parametrize("D,heads,N,dtype_name", KEYS_CASES)
def test_keys_lanes_match_jax(D, heads, N, dtype_name):
    """head_mean_keys_ref, whose order the kernel's lanes keep, on the
    port's plain qkv: within the bound of JAX's by-product (whose qkv comes
    from its own LayerNorm and product)."""
    dtype = DTYPES[dtype_name]
    jdt = JAX_DTYPES[dtype]
    rng = np.random.default_rng(D * 100 + N)
    x = rand(rng, B, N, D)
    params = [rand(rng, D, scale=0.1, shift=1.0), rand(rng, D, scale=0.1),
              rand(rng, D, 3 * D, scale=0.1), rand(rng, 3 * D, scale=0.1),
              rand(rng, D, D, scale=0.1), rand(rng, D, scale=0.1)]
    scale = (D // heads) ** -0.5
    want = jax_block_attention(
        jnp.asarray(x, jdt), *(jnp.asarray(a, jdt) for a in params), heads,
        scale, eps=EPS, want_keys=True, interpret=True)[3]
    ls, lb, wqkv, bqkv = (leaf(a, jdt, dtype) for a in params[:4])
    qkv = ln_qkv_ref(torch_of(jnp.asarray(x, jdt), dtype), ls, lb, wqkv,
                     bqkv, EPS)
    got = head_mean_keys_ref(qkv, heads)
    want = np.asarray(want, dtype=np.float32)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= BOUND[dtype]
