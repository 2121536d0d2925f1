"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (Hopper:
the kernels are built for sm_90a). Phases, each printing its own lines:

0. device: refuse to run without CUDA; print the card's name and power
   limit (nvidia-smi), torch and CUDA versions; turn TF32 off.
1. build: compile tokenreduction_tpu_torch/csrc/*.cu with nvcc into
   build/tokenreduction_tpu_torch/<source hash>/.
2. kernels: each kernel counterpart against its plain PyTorch version on
   the same CUDA tensors at the main path's widths, fp32 at B=32 (bound
   1e-4 of max|plain|) and bf16 at B=256 (bound 2e-2 of max|plain|), with
   CUDA-event times (median of 20 runs). In bf16 the block's output is
   dominated by its residual, so each bf16 launch is also held alone,
   with no residual, against its plain version at B=256, relative to that
   tensor's own max: LayerNorm (bf16, fp32 and gathered rows), the qkv
   and fc1+GELU GEMMs and the attention's merged heads within 1e-2 (one
   to three bf16 ulps of the max, where two fp32 sums round apart); the
   attention's fp32 row0 and colsum and the proj and fc2 GEMMs with fp32
   output within 1e-4.
   ToMe's eval counterparts: fused_block_attention with a per-key bias
   (log sizes) and the head-mean keys, and fused_mlp_residual, at ToMe@0.7's
   widths 197, 138, 97, 68.
   Training kernels (attend_branch_train, mlp_branch, attention_core_train):
   forward outputs and every gradient, with non-zero row0 (and, for the
   core, colsum) cotangents, against the plain forward and the plain
   hand-written backward at the training widths, fp32 at B=32 (1e-4) and
   bf16 at B=256 (2e-2), each tensor of its own max|plain|; each new bf16
   launch alone (gemm with W untransposed, with the GELU' factor and
   column sums, gemm_wgrad, short_attention_bwd, layer_norm_bwd, the
   training attention forward; the biased attention forward, head_mean_keys
   and the biased backward with its colsum cotangent and dbias over
   [B, H, N, hd] views) as above.
   Beside each counterpart's time: its bound (bytes or operations at the
   H100's peak rates) and the eager bf16 composition of library calls
   (F.layer_norm, F.linear, scaled_dot_product_attention with the bias as
   its mask, autograd for the backward) computing the same function.
3. models: DeiT-S dense, topk@0.7, topk@0.25 and ToMe@0.7 (loc 3 6 9) at
   full width with seeded weights on the card (kernels) against the same
   model on the CPU (plain versions), with the launch counts of one
   forward. fp32 at B=8: logits within 1e-4 of max|CPU|, the same top-1,
   the same kept ids and equal Assignment_Maps. bf16 at B=32: top-1
   agreement at least 0.9, at least 0.9 of the kept ids in the CPU's kept
   set, ToMe's share of equal Assignment_Maps entries (bound set from a
   measured run), two ToMe forwards with the same logits, and dense logits
   within 2e-2 of max|CPU|. Random weights make near-uniform attention, so
   the top-k scores lie closer than a bf16 ulp and a few kept ids differ;
   the reducing models' bf16 logits, which then see other tokens, are
   reported only. Kept_Tokens flips (same id at the same rank) are
   reported.
   Training, drop_path 0: the loss and every gradient of dense, topk@0.7
   and ToMe@0.7 on the card against the CPU, fp32 at B=8 (1e-4 of each
   leaf's max|CPU|, the same kept ids and merges) and bf16 amp at B=32
   (bounds set from measured runs), and the launches of one train step:
   12 forwards and 12 backwards of each training branch (ToMe: the
   attention branch in blocks 0-3, the attention core in blocks 4-11).
4. serve: 5 batches of 256 bf16 images through each model; outputs must
   be finite; img/s over batches 2-5.
5. train: bench.py's train step for dense, topk@0.7 and ToMe@0.7 -- b256,
   amp, drop_path 0.1 from a seeded CUDA generator, grouped AdamW lr 1e-3
   with backbone_lr_scale 0.01, clip 1.0, EMA 0.99996, label smoothing 0.1
   -- 8 steps on seeded random images and labels; the losses must be
   finite and the params must move; ms/step and img/s over steps 3-8. Then
   the same steps with the eager bf16 library composition in place of the
   three training counterparts, and last a torch.profiler window of two
   topk@0.7 and two ToMe@0.7 steps: the device's busy share and its time
   per step by kernel.

Phases 4 and 5 are the main path's runs: each counterpart's launch count
is set to 0 just before and read just after.

No failure is caught: any phase that fails ends the script with a
traceback and a non-zero exit code, before the result lines. The last two
lines are the kernels' JSON record and the result JSON.
"""

from __future__ import annotations

import copy
import gc
import json
import pathlib
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

import tokenreduction_tpu_torch
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.core import layers
from tokenreduction_tpu_torch.ops.flash_attention import (
    attention_ref,
    fused_attention,
    fused_attention_ref,
    fused_block_attention,
    fused_block_attention_ref,
    head_mean_keys_ref,
    layer_norm_bwd_ref,
    layer_norm_f32,
    layer_norm_stats,
    linear_f32,
    packed_heads,
)
from tokenreduction_tpu_torch.ops.flash_attention_train import (
    attention_core_train,
    attention_core_train_bwd_ref,
)
from tokenreduction_tpu_torch.ops.fused_block_train import (
    attend_branch_train,
    attend_branch_train_bwd_ref,
    attend_branch_train_ref,
    attention_bwd_ref,
    attention_train_ref,
)
from tokenreduction_tpu_torch.ops.fused_full_block import (
    fused_full_block,
    fused_full_block_ref,
)
from tokenreduction_tpu_torch.ops.fused_mlp import (
    fused_mlp_gather_residual,
    fused_mlp_gather_residual_ref,
    fused_mlp_residual,
    fused_mlp_residual_ref,
)
from tokenreduction_tpu_torch.ops.fused_mlp_train import (
    gelu_grad,
    mlp_branch,
    mlp_branch_bwd_ref,
    mlp_branch_ref,
)
from tokenreduction_tpu_torch.ops.gather import take_tokens
from tokenreduction_tpu_torch.reduction import tome as tome_model
from tokenreduction_tpu_torch.train import losses
from tokenreduction_tpu_torch.train.optim import OptimConfig, create_optimizer
from tokenreduction_tpu_torch.train.step import (
    StepConfig,
    init_train_state,
    loss_and_grads,
    make_train_step,
)

DEVICE = "cuda"
D, HEADS, H4 = 384, 6, 1536  # DeiT-S
SCALE = (D // HEADS) ** -0.5
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # of max|plain|
BATCH = {torch.float32: 32, torch.bfloat16: 256}
# a bf16 launch alone, of the tensor's own max|plain|: bf16 outputs, and
# fp32 outputs of bf16 operands
LAUNCH_BOUND = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# of max|CPU|; in bf16 for dense only (no selection)
MODEL_BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MODEL_BATCH = {torch.float32: 8, torch.bfloat16: 32}
MODEL_TOP1 = {torch.float32: 1.0, torch.bfloat16: 0.9}
KEPT_SET = {torch.float32: 1.0, torch.bfloat16: 0.9}  # share of kept ids
# share of ToMe's Assignment_Maps entries equal to the CPU's (bf16: bound
# set from the measured 0.928)
ASSIGN_SAME = {torch.float32: 1.0, torch.bfloat16: 0.9}
# one train step on the card against the CPU, of each tensor's max|CPU|:
# fp32 the loss and every gradient leaf, with the same kept ids. bf16 amp
# (bounds set from measured runs: loss 4.5e-3, dense gradients 1.6e-2):
# the loss, dense's gradient leaves, and topk's share of kept ids in the
# CPU's kept set; topk's bf16 gradients, taken over other tokens where a
# near-tied score flips, are reported only
TRAIN_BOUND = {torch.float32: dict(loss=1e-4, grads=1e-4, kept_set=1.0),
               torch.bfloat16: dict(loss=2e-2, grads=5e-2, kept_set=0.9)}
EPS = 1e-6
# H100 SXM peak rates (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
EVAL_WRAPPERS = {
    "fused_full_block": fused_full_block,
    "fused_block_attention": fused_block_attention,
    "fused_mlp_gather_residual": fused_mlp_gather_residual,
    "fused_mlp_residual": fused_mlp_residual,
}
TRAIN_WRAPPERS = {
    "attend_branch_train": attend_branch_train,
    "mlp_branch": mlp_branch,
    "attention_core_train": attention_core_train,
}
WRAPPERS = {**EVAL_WRAPPERS, **TRAIN_WRAPPERS}
REPLACES = {
    "fused_full_block": "tokenreduction_tpu/ops/fused_full_block.py:118",
    "fused_block_attention": "tokenreduction_tpu/ops/flash_attention.py:660",
    "fused_mlp_gather_residual": "tokenreduction_tpu/ops/fused_mlp.py:192",
    "fused_mlp_residual": "tokenreduction_tpu/ops/fused_mlp.py:137",
    "attend_branch_train": "tokenreduction_tpu/ops/fused_block_train.py:344",
    "mlp_branch": "tokenreduction_tpu/ops/fused_mlp_train.py:257",
    "attention_core_train":
        "tokenreduction_tpu/ops/flash_attention_train.py:172",
}
# the kernel wrapper of each counterpart, and the CUDA sources it launches
# (the first is the record's "source")
WRAPPER_SOURCES = {
    name: f"tokenreduction_tpu_torch/ops/{module}.py"
    for name, module in (("fused_full_block", "fused_full_block"),
                         ("fused_block_attention", "flash_attention"),
                         ("fused_mlp_gather_residual", "fused_mlp"),
                         ("fused_mlp_residual", "fused_mlp"),
                         ("attend_branch_train", "fused_block_train"),
                         ("mlp_branch", "fused_mlp_train"),
                         ("attention_core_train", "flash_attention_train"))}
LN_GEMM = "tokenreduction_tpu_torch/csrc/ln_gemm.cu"
ATTENTION = "tokenreduction_tpu_torch/csrc/short_attention.cu"
CUDA_SOURCES = {
    "fused_full_block": [LN_GEMM, ATTENTION],
    "fused_block_attention": [ATTENTION, LN_GEMM],
    "fused_mlp_gather_residual": [LN_GEMM],
    "fused_mlp_residual": [LN_GEMM],
    "attend_branch_train": [ATTENTION, LN_GEMM],
    "mlp_branch": [LN_GEMM],
    "attention_core_train": [ATTENTION],
}
FULL_BLOCK_N = (197, 138, 97, 68, 50, 13, 4)
BLOCK_ATTN_N = (197, 138, 97, 50, 13)
MLP_GATHER_NK = ((197, 138), (138, 97), (97, 68), (197, 50), (50, 13),
                 (13, 4))
# the widths of topk@0.7's training halves (and dense's 197), and of
# ToMe@0.7's stages (eval and training)
TRAIN_N = (197, 138, 97, 68)
TOME_N = TRAIN_N
GRAD_NAMES = {
    "attend_branch_train": ("branch", "row0", "dx", "d ln1 scale",
                            "d ln1 bias", "d wqkv", "d bqkv", "d wproj",
                            "d bproj"),
    "mlp_branch": ("branch", "dx", "d ln2 scale", "d ln2 bias", "d w1",
                   "d b1", "d w2", "d b2"),
    "attention_core_train": ("out", "row0", "colsum", "dq", "dk", "dv",
                             "dbias"),
}
MODELS = {
    "dense": ("deit_small_patch16_224_local", {}),
    "topk@0.7": ("topk_small_patch16_224",
                 dict(reduction_loc=(3, 6, 9), keep_rate=(0.7,))),
    "topk@0.25": ("topk_small_patch16_224",
                  dict(reduction_loc=(3, 6, 9), keep_rate=(0.25,))),
    "tome@0.7": ("tome_small_patch16_224",
                 dict(reduction_loc=(3, 6, 9), keep_rate=(0.7,))),
}
TRAIN_MODELS = ("dense", "topk@0.7", "tome@0.7")
NO_TRAIN = dict.fromkeys(TRAIN_WRAPPERS, 0)
NO_EVAL = dict.fromkeys(EVAL_WRAPPERS, 0)
# launches of one forward: 12 score-less blocks (dense); 9 score-less
# blocks and 3 reduction blocks (topk at loc 3 6 9); 12 attention and 12
# MLP halves (ToMe)
PER_FORWARD = {
    "dense": {**NO_EVAL, **NO_TRAIN, "fused_full_block": 12},
    "topk@0.7": {**NO_EVAL, **NO_TRAIN, "fused_full_block": 9,
                 "fused_block_attention": 3, "fused_mlp_gather_residual": 3},
    "tome@0.7": {**NO_EVAL, **NO_TRAIN, "fused_block_attention": 12,
                 "fused_mlp_residual": 12},
}
PER_FORWARD["topk@0.25"] = PER_FORWARD["topk@0.7"]
# launches of one train step, a forward and a backward each: every MLP
# half's mlp_branch; every attention half's attend_branch_train, except
# ToMe's after its first merge (blocks 4-11, with the size bias), which
# take the attention core
PER_TRAIN_STEP_BWD = {
    "dense": {**NO_TRAIN, "attend_branch_train": 12, "mlp_branch": 12},
    "tome@0.7": {**NO_TRAIN, "attend_branch_train": 4, "mlp_branch": 12,
                 "attention_core_train": 8},
}
PER_TRAIN_STEP_BWD["topk@0.7"] = PER_TRAIN_STEP_BWD["dense"]
PER_TRAIN_STEP = {label: {**NO_EVAL, **{k: 2 * n for k, n in bwd.items()}}
                  for label, bwd in PER_TRAIN_STEP_BWD.items()}
SERVE_BATCHES, SERVE_B = 5, 256
TRAIN_STEPS, TRAIN_B = 8, 256


def require(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0
    for w in TRAIN_WRAPPERS.values():
        w.backward_launches = 0


def counts() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def backward_counts() -> dict:
    return {name: w.backward_launches for name, w in TRAIN_WRAPPERS.items()}


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() over `runs` runs, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(name: str, B: int, N: int, K: int | None = None):
    """(least ms, "bytes" or "operations") of a bf16 counterpart at these
    shapes: each input read once and each output written once over the
    H100's memory rate, against the products' operations (forward, and
    for the training counterparts also backward, with no recompute) over
    its bf16 tensor-core rate."""
    E, M = 2, B * N
    attn_w = 4 * D * D + 6 * D  # wqkv, bqkv, wproj, bproj, LN scale, bias
    mlp_w = 8 * D * D + H4 + 3 * D
    by_products = 4 * B * HEADS * N  # one fp32 [B, H, N]
    if name == "fused_full_block":
        flops = 24 * M * D * D + 4 * B * N * N * D
        nbytes = E * (2 * M * D + attn_w + mlp_w)
    elif name == "fused_block_attention":
        flops = 8 * M * D * D + 4 * B * N * N * D
        nbytes = E * (2 * M * D + attn_w) + 2 * by_products
    elif name == "fused_mlp_gather_residual":  # the K gathered rows
        flops = 16 * B * K * D * D
        nbytes = E * (2 * B * K * D + mlp_w) + 8 * B * K
    elif name == "fused_mlp_residual":
        flops = 16 * M * D * D
        nbytes = E * (2 * M * D + mlp_w)
    elif name == "fused_attention":  # q, k, v, bias in; out, row0, colsum
        flops = 4 * B * N * N * D
        nbytes = E * 4 * M * D + 2 * by_products + 4 * B * N
    elif name == "attend_branch_train":  # x, dy, drow0 in; out, row0, dx,
        flops = 24 * M * D * D + 12 * B * N * N * D  # and the grads out
        nbytes = E * (4 * M * D + 2 * attn_w) + 2 * by_products
    elif name == "attention_core_train":  # q, k, v, bias, dout, drow0, dcs
        flops = 12 * B * N * N * D  # in; out, row0, colsum, dq, dk, dv,
        nbytes = E * 8 * M * D + 4 * by_products + 4 * 2 * B * N  # dbias
    else:  # mlp_branch
        flops = 48 * M * D * D
        nbytes = E * (4 * M * D + 2 * mlp_w)
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes \
        else "bytes"


# ---- the eager bf16 compositions of library calls (timing yardsticks;
# the port never calls them)
def library_core(q, k, v, scale, bias=None):
    """(softmax(q k^T * scale [+ bias]) v, the fp32 CLS row of the
    probabilities, None) over [B, H, N, hd]: no column mass. Also a drop-in
    for attention_core_train in Attention (phase 5)."""
    mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    logits = (q[:, :, :1] @ k.transpose(-1, -2)).float() * scale
    if bias is not None:
        logits = logits + bias.float()[:, None, None, :]
    return o, torch.softmax(logits, -1)[:, :, 0], None


def library_attention(x, ls, lb, wqkv, bqkv, wproj, bproj, num_heads=HEADS,
                      scale=SCALE, eps=EPS, bias=None, want_keys=False):
    """(proj(attn(qkv(LN x))), the fp32 CLS row of the probabilities) and,
    with want_keys, the head-mean keys; also a drop-in for
    attend_branch_train in Block (phase 5)."""
    B, N, Dx = x.shape
    ln = F.layer_norm(x, (Dx,), ls, lb, eps)
    q, k, v = F.linear(ln, wqkv, bqkv).view(B, N, 3, num_heads, -1) \
        .permute(2, 0, 3, 1, 4)
    o, row0, _ = library_core(q, k, v, scale, bias)
    y = F.linear(o.transpose(1, 2).reshape(B, N, Dx), wproj, bproj)
    return (y, row0, k.mean(1)) if want_keys else (y, row0)


def library_mlp(x, ls, lb, w1, b1, w2, b2, eps=EPS):
    ln = F.layer_norm(x, (x.shape[-1],), ls, lb, eps)
    return F.linear(F.gelu(F.linear(ln, w1, b1)), w2, b2)


def log_sizes(B, N, gen, dtype):
    """A ToMe bias on the card: the log of merged-token sizes 1..4."""
    sizes = torch.randint(1, 5, (B, N), generator=gen).float()
    return torch.log(sizes).to(DEVICE, dtype)


def library_full_block(x, ls1, lb1, wqkv, bqkv, wproj, bproj, ls2, lb2, w1,
                       b1, w2, b2):
    y = x + library_attention(x, ls1, lb1, wqkv, bqkv, wproj, bproj)[0]
    return y + library_mlp(y, ls2, lb2, w1, b1, w2, b2)


def block_params(dtype, gen):
    """Seeded block weights in nn.Linear layout, on the card."""
    def r(*shape, scale=0.05, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=gen)) \
            .to(device=DEVICE, dtype=dtype)

    return dict(
        ls1=r(D, scale=0.1, shift=1.0), lb1=r(D, scale=0.1),
        wqkv=r(3 * D, D), bqkv=r(3 * D), wproj=r(D, D), bproj=r(D),
        ls2=r(D, scale=0.1, shift=1.0), lb2=r(D, scale=0.1),
        w1=r(H4, D), b1=r(H4), w2=r(D, H4), b2=r(D))


ATTN = ("ls1", "lb1", "wqkv", "bqkv", "wproj", "bproj")
MLP = ("ls2", "lb2", "w1", "b1", "w2", "b2")


def kernel_cases(dtype, gen):
    """(kernel name, shape label, kernel call, plain call, library call)
    at the main path's widths."""
    B = BATCH[dtype]
    p = block_params(dtype, gen)
    attn = [p[k] for k in ATTN]
    mlp = [p[k] for k in MLP]

    def x_of(N):
        return torch.randn(B, N, D, generator=gen).to(DEVICE, dtype)

    for N in FULL_BLOCK_N:
        x = x_of(N)
        yield ("fused_full_block", f"B={B} N={N}",
               lambda x=x: fused_full_block(x, *attn, *mlp, HEADS, SCALE),
               lambda x=x: fused_full_block_ref(x, *attn, *mlp, HEADS, SCALE),
               lambda x=x: library_full_block(x, *attn, *mlp))
    for N in BLOCK_ATTN_N:
        x = x_of(N)
        yield ("fused_block_attention", f"B={B} N={N}",
               lambda x=x: fused_block_attention(x, *attn, HEADS, SCALE),
               lambda x=x: fused_block_attention_ref(x, *attn, HEADS, SCALE),
               lambda x=x: (x + library_attention(x, *attn)[0]))
    for N in TOME_N:
        x, bias = x_of(N), log_sizes(B, N, gen, dtype)

        def library(x=x, bias=bias):
            y, row0, keys = library_attention(x, *attn, bias=bias,
                                              want_keys=True)
            return x + y, row0, keys

        yield ("fused_block_attention", f"B={B} N={N} bias keys",
               lambda x=x, bias=bias: fused_block_attention(
                   x, *attn, HEADS, SCALE, bias=bias, want_keys=True),
               lambda x=x, bias=bias: fused_block_attention_ref(
                   x, *attn, HEADS, SCALE, bias=bias, want_keys=True),
               library)
        yield ("fused_mlp_residual", f"B={B} N={N}",
               lambda x=x: fused_mlp_residual(x, *mlp),
               lambda x=x: fused_mlp_residual_ref(x, *mlp),
               lambda x=x: x + library_mlp(x, *mlp))
        # the attention core alone (the training core's forward), over
        # views of a packed qkv
        qkv = torch.randn(B, N, 3 * D, generator=gen).to(DEVICE, dtype)
        heads = packed_heads(qkv, HEADS)
        yield ("fused_attention", f"B={B} N={N}",
               lambda h=heads, b=bias: fused_attention(*h, SCALE, bias=b),
               lambda h=heads, b=bias: fused_attention_ref(*h, SCALE, bias=b),
               lambda h=heads, b=bias: library_core(*h, SCALE, b))
    for N, K in MLP_GATHER_NK:
        x = x_of(N)
        idx = torch.stack([
            torch.cat([torch.zeros(1, dtype=torch.long),
                       1 + torch.randperm(N - 1, generator=gen)[:K - 1]])
            for _ in range(B)]).to(DEVICE)

        def library(x=x, idx=idx):
            g = take_tokens(x, idx)
            return g + library_mlp(g, *mlp)

        yield ("fused_mlp_gather_residual", f"B={B} N={N} K={K}",
               lambda x=x, idx=idx: fused_mlp_gather_residual(x, idx, *mlp),
               lambda x=x, idx=idx: fused_mlp_gather_residual_ref(x, idx,
                                                                  *mlp),
               library)


def train_cases(dtype, gen):
    """(kernel name, shape label, kernel call, plain call, library call)
    of the training counterparts at the training widths. Each call returns
    the forward outputs and every gradient for a fixed random cotangent
    (and a non-zero row0 cotangent): the kernel through the autograd
    wrapper, the plain version through the plain forward and the plain
    hand-written backward, the library composition through autograd."""
    B = BATCH[dtype]
    p = block_params(dtype, gen)

    def case(name, x, dy, drow0):
        attn = name == "attend_branch_train"
        ps = [p[k] for k in (ATTN if attn else MLP)]
        leaves = [t.detach().requires_grad_() for t in (x, *ps)]
        cots = (dy, drow0) if attn else (dy,)

        def grads_of(fn):
            outs = as_list(fn(*leaves))
            return [*outs, *torch.autograd.grad(outs, leaves, cots)]

        if attn:
            return (lambda: grads_of(
                        lambda *a: attend_branch_train(*a, HEADS, SCALE, EPS)),
                    lambda: [*attend_branch_train_ref(x, *ps, HEADS, SCALE,
                                                      EPS),
                             *attend_branch_train_bwd_ref(
                                 x, *ps[:5], dy, drow0, HEADS, SCALE, EPS)],
                    lambda: grads_of(library_attention))
        return (lambda: grads_of(lambda *a: mlp_branch(*a, EPS)),
                lambda: [mlp_branch_ref(x, *ps, EPS),
                         *mlp_branch_bwd_ref(x, *ps[:5], dy, EPS)],
                lambda: grads_of(library_mlp))

    def core_case(qkv, bias, dout, drow0, dcs):
        """The attention core over views of a packed qkv, as Attention
        calls it, with the size bias and the cotangents of all three
        outputs (the library composition has no column mass and takes no
        colsum cotangent)."""
        leaf = qkv.detach().requires_grad_()
        b = bias.detach().requires_grad_()
        q, k, v = packed_heads(leaf, HEADS)
        inputs = (q, k, v, b)
        cots = (dout, drow0, dcs)

        def kernel():
            outs = attention_core_train(q, k, v, SCALE, b)
            return [*outs, *torch.autograd.grad(outs, inputs, cots)]

        def plain():
            dq, dk, dv, db = attention_core_train_bwd_ref(
                q.detach(), k.detach(), v.detach(), bias, dout, drow0, dcs,
                SCALE)
            fwd = fused_attention_ref(q.detach(), k.detach(), v.detach(),
                                      SCALE, bias=bias)
            return [*fwd, dq, dk, dv, db.sum(1).to(bias.dtype)]

        def library():
            o, row0, _ = library_core(q, k, v, SCALE, b)
            return [o, row0, *torch.autograd.grad((o, row0), inputs,
                                                  cots[:2])]

        return kernel, plain, library

    for N in TRAIN_N:
        x = torch.randn(B, N, D, generator=gen).to(DEVICE, dtype)
        dy = torch.randn(B, N, D, generator=gen).to(DEVICE, dtype)
        drow0 = torch.randn(B, HEADS, N, generator=gen).to(DEVICE)
        for name in ("attend_branch_train", "mlp_branch"):
            yield (name, f"B={B} N={N}", *case(name, x, dy, drow0))
        qkv = torch.randn(B, N, 3 * D, generator=gen).to(DEVICE, dtype)
        dout = torch.randn(B, N, HEADS, D // HEADS, generator=gen) \
            .to(DEVICE, dtype).transpose(1, 2)  # as merging the heads sends it
        dcs = torch.randn(B, HEADS, N, generator=gen).to(DEVICE)
        yield ("attention_core_train", f"B={B} N={N}",
               *core_case(qkv, log_sizes(B, N, gen, dtype), dout, drow0, dcs))


def as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, that over max|want|) after checking shape and dtype."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    abs_err = (got.float() - want.float()).abs().max().item()
    return abs_err, abs_err / max(want.float().abs().max().item(), 1e-30)


def launcher_cases(gen):
    """(launch, shape label, [(output label, got, want)]) for each bf16
    launch of the main path alone, at B=256 and the main path's widths.
    Each launch reads the plain version's inputs."""
    from tokenreduction_tpu_torch.ops import _build

    bf16, B = torch.bfloat16, BATCH[torch.bfloat16]
    p = block_params(bf16, gen)

    def ln_ref(rows):  # plain LN2 of rows (bf16 or fp32), rounded to bf16
        return layer_norm_f32(rows.float(), p["ls2"], p["lb2"], EPS).to(bf16)

    def ln_case(rows, M, **gather):
        got = torch.empty(M, D, device=DEVICE, dtype=bf16)
        _build.layer_norm(rows, p["ls2"], p["lb2"], got, eps=EPS, **gather)
        return got

    def gemm_case(x, w, b, y_dtype, **kw):
        n_out = w.shape[1] if kw.get("w_kn") else w.shape[0]
        got = torch.empty(x.shape[0], n_out, device=DEVICE, dtype=y_dtype)
        _build.gemm(x, w, b, got, **kw)
        return got

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen).to(DEVICE, dtype)

    for N in FULL_BLOCK_N:
        M, shape = B * N, f"B={B} N={N}"
        x = randn(M, D)
        x32 = randn(M, D, dtype=torch.float32)
        for label, rows in (("bf16 rows", x), ("fp32 rows", x32)):
            yield f"layer_norm, {label}", shape, [
                ("ln", ln_case(rows, M), ln_ref(rows))]

        ln = ln_ref(x)
        want_qkv = linear_f32(ln, p["wqkv"], p["bqkv"]).to(bf16)
        yield "gemm qkv", shape, [
            ("qkv", gemm_case(ln, p["wqkv"], p["bqkv"], bf16), want_qkv)]

        qkv = want_qkv.view(B, N, 3 * D)
        merged = torch.empty(B, N, D, device=DEVICE, dtype=bf16)
        row0 = torch.empty(B, HEADS, N, device=DEVICE)
        colsum = torch.empty_like(row0)
        _build.short_attention(qkv, merged, HEADS, SCALE, row0=row0,
                               colsum=colsum)
        want = attention_ref(qkv, HEADS, SCALE)
        yield "short_attention", shape, list(zip(
            ("merged heads", "row0", "colsum"), (merged, row0, colsum), want))

        heads = want[0].view(M, D)
        yield "gemm proj, fp32 out", shape, [
            ("y", gemm_case(heads, p["wproj"], p["bproj"], torch.float32),
             linear_f32(heads, p["wproj"], p["bproj"]))]

        h = F.gelu(linear_f32(ln, p["w1"], p["b1"])).to(bf16)
        yield "gemm fc1+GELU", shape, [
            ("hidden", gemm_case(ln, p["w1"], p["b1"], bf16, gelu=True), h)]

        yield "gemm fc2, fp32 out", shape, [
            ("out", gemm_case(h, p["w2"], p["b2"], torch.float32),
             linear_f32(h, p["w2"], p["b2"]))]

        if N not in TRAIN_N:
            continue
        # the training launches
        merged = torch.empty(B, N, D, device=DEVICE, dtype=bf16)
        _build.short_attention(qkv, merged, HEADS, SCALE, row0=row0,
                               norm_p=True)
        yield "short_attention, normalised P", shape, list(zip(
            ("merged heads", "row0"), (merged, row0),
            attention_train_ref(qkv, HEADS, SCALE)))

        dout, drow0 = randn(B, N, D), randn(B, HEADS, N, dtype=torch.float32)
        dqkv = torch.empty_like(qkv)
        _build.short_attention_bwd(qkv, dout, drow0, dqkv, HEADS, SCALE)
        want = attention_bwd_ref(qkv, dout, drow0, HEADS, SCALE)
        yield "short_attention_bwd", shape, [
            (label, dqkv[..., i * D:(i + 1) * D], want[..., i * D:(i + 1) * D])
            for i, label in enumerate(("dq", "dk", "dv"))]

        # ToMe's launches: the biased forward, the head-mean keys, and the
        # biased backward over [B, H, N, hd] views with both cotangents
        bias = log_sizes(B, N, gen, torch.float32)
        _build.short_attention(qkv, merged, HEADS, SCALE, bias=bias,
                               row0=row0, colsum=colsum)
        yield "short_attention, bias", shape, list(zip(
            ("merged heads", "row0", "colsum"), (merged, row0, colsum),
            attention_ref(qkv, HEADS, SCALE, bias)))
        keys = torch.empty(B, N, D // HEADS, device=DEVICE, dtype=bf16)
        _build.head_mean_keys(qkv, keys, HEADS)
        yield "head_mean_keys", shape, [
            ("keys", keys, head_mean_keys_ref(qkv, HEADS))]
        q, k, v = packed_heads(qkv, HEADS)
        dout = randn(B, N, HEADS, D // HEADS).transpose(1, 2)
        dcs = randn(B, HEADS, N, dtype=torch.float32)
        grads = torch.empty(3, B, HEADS, N, D // HEADS, device=DEVICE,
                            dtype=bf16).unbind(0)
        dbias = torch.empty(B, HEADS, N, device=DEVICE)
        _build.short_attention_bwd_heads(q, k, v, dout, *grads, SCALE,
                                         bias=bias, drow0=drow0, dcs=dcs,
                                         dbias=dbias)
        yield "short_attention_bwd, bias, colsum cotangent, dbias", shape, \
            list(zip(("dq", "dk", "dv", "dbias"), (*grads, dbias),
                     attention_core_train_bwd_ref(q, k, v, bias, dout, drow0,
                                                  dcs, SCALE)))

        dy = randn(M, D)
        yield "gemm dY.W (W untransposed)", shape, [
            ("dattn", gemm_case(dy, p["wproj"], None, bf16, w_kn=True),
             (dy.float() @ p["wproj"].float()).to(bf16))]
        dq = dqkv.view(M, 3 * D)
        yield "gemm dY.W, fp32 out", shape, [
            ("dln", gemm_case(dq, p["wqkv"], None, torch.float32, w_kn=True),
             dq.float() @ p["wqkv"].float())]

        a = torch.empty(M, H4, device=DEVICE, dtype=bf16)
        gp = torch.empty(M, H4, device=DEVICE)
        _build.gemm(ln, p["w1"], p["b1"], a, gelu=True, gelu_grad=gp)
        pre = linear_f32(ln, p["w1"], p["b1"])
        yield "gemm fc1+GELU, GELU' out", shape, [
            ("hidden", a, F.gelu(pre).to(bf16)), ("GELU'", gp, gelu_grad(pre))]

        parts = torch.empty(-(-M // _build.GEMM_TILE), H4, device=DEVICE)
        dh = gemm_case(dy, p["w2"], None, bf16, w_kn=True, mul=gp,
                       col_sums=parts)
        dh32 = (dy.float() @ p["w2"].float()) * gp
        yield "gemm dY.W x GELU', column sums", shape, [
            ("dh", dh, dh32.to(bf16)), ("db1", parts.sum(0), dh32.sum(0))]

        dw = torch.empty(3 * D, D, device=DEVICE, dtype=bf16)
        db = torch.empty(3 * D, device=DEVICE, dtype=bf16)
        _build.gemm_wgrad(dq, ln, dw, db)
        yield "gemm_wgrad", shape, [
            ("dW", dw, (dq.float().T @ ln.float()).to(bf16)),
            ("db", db, dq.float().sum(0).to(bf16))]

        dln = randn(M, D, dtype=torch.float32)
        dx = torch.empty_like(x)
        dwb = torch.empty(2, D, device=DEVICE, dtype=bf16)
        _build.layer_norm_bwd(x, p["ls1"], dln, dx, dwb, eps=EPS)
        x_hat, rstd = layer_norm_stats(x.float(), EPS)
        want = layer_norm_bwd_ref(dln, x_hat, rstd, p["ls1"])
        yield "layer_norm_bwd", shape, [
            (label, got, w.to(bf16)) for label, got, w in
            zip(("dx", "d scale", "d bias"), (dx, dwb[0], dwb[1]), want)]

    for N, K in MLP_GATHER_NK:
        x = randn(B, N, D)
        idx = torch.stack([torch.randperm(N, generator=gen)[:K]
                           for _ in range(B)]).to(DEVICE, torch.int32)
        got = ln_case(x.view(B * N, D), B * K, idx=idx, rows_out=K,
                      rows_in=N)
        want = ln_ref(take_tokens(x, idx.long()).view(B * K, D))
        yield "layer_norm, gathered rows", f"B={B} N={N} K={K}", [
            ("ln", got, want)]


def phase_launchers():
    """Phase 2, second part: each bf16 launch alone against its plain
    version, relative to the tensor's own max."""
    worst = {}
    for launch, shape, outputs in launcher_cases(
            torch.Generator().manual_seed(4)):
        errs = []
        for label, got, want in outputs:
            abs_err, rel = rel_err(got, want)
            bound_ = LAUNCH_BOUND[got.dtype]
            require(rel <= bound_, f"{launch} bf16 {shape} {label}: error "
                    f"{rel:.3e} of its max|plain| > bound {bound_:.0e}")
            errs.append(f"{label} {abs_err:.3e} ({rel:.2e} of max, bound "
                        f"{bound_:.0e})")
            key = f"{launch}: {label}"
            worst[key] = max(worst.get(key, 0.0), rel)
        print(f"phase 2 launch {launch} bf16 {shape}: {', '.join(errs)}",
              flush=True)
    for key, rel in worst.items():
        print(f"phase 2 launch worst {key}: {rel:.2e} of its max|plain|",
              flush=True)


def check_case(name, tag, shape, dtype, got, want, labels, rec):
    require(len(got) == len(want) <= len(labels),
            f"{name} {tag} {shape}: {len(got)} outputs, plain {len(want)}")
    errs = []
    for label, g, w in zip(labels, got, want):
        abs_err, rel = rel_err(g, w)
        require(rel <= BOUND[dtype], f"{name} {tag} {shape} {label}: error "
                f"{rel:.3e} of max|plain| > bound {BOUND[dtype]:.0e}")
        errs.append(f"{label} {abs_err:.3e} ({rel:.2e} rel)")
        rec[f"max_rel_err_{tag}"] = max(rec[f"max_rel_err_{tag}"], rel)
        if label in ("out", "branch") and dtype == torch.bfloat16:
            rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    return errs


def phase_kernels() -> dict:
    """Phase 2. Returns per-kernel records for the JSON line (and
    fused_attention's)."""
    gen = torch.Generator().manual_seed(0)
    rec = {name: dict(max_abs_err=0.0, max_rel_err_fp32=0.0,
                      max_rel_err_bf16=0.0)
           for name in (*WRAPPERS, "fused_attention")}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        cases = [(n, s, k, p, lib, ("out", "row0", "colsum", "keys"))
                 for n, s, k, p, lib in kernel_cases(dtype, gen)]
        cases += [(n, s, k, p, lib, GRAD_NAMES[n])
                  for n, s, k, p, lib in train_cases(dtype, gen)]
        for name, shape, kernel, plain, library, labels in cases:
            got, want = as_list(kernel()), as_list(plain())
            torch.cuda.synchronize()
            errs = check_case(name, tag, shape, dtype, got, want, labels,
                              rec[name])
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            lib_ms = cuda_ms(library) if dtype == torch.bfloat16 else None
            lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
            print(f"phase 2 kernel {name} {tag} {shape}: max abs err "
                  f"{', '.join(errs)}; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms{lib}", flush=True)
            if dtype == torch.bfloat16 and "shape" not in rec[name]:
                # the widest main-path shape stands for the kernel
                dims = dict(part.split("=") for part in shape.split())
                bound_ms, bound_by = bound(name, *map(int, dims.values()))
                rec[name].update(shape=f"bf16 {shape}", ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by,
                                 library_composition_ms=lib_ms)
    return rec


def settle():
    """Before a timed run: collect the garbage the checks left behind
    (cycles hold models and their optimizer states) and return the
    allocator's cached blocks, so that no run pays for the one before."""
    gc.collect()
    torch.cuda.empty_cache()


def images(B, gen, dtype=torch.float32):
    return torch.randn(B, 3, 224, 224, generator=gen).to(DEVICE, dtype)


def phase_models(dtype):
    """Phase 3: the full-width models on the card against the CPU."""
    tag = "fp32" if dtype == torch.float32 else "bf16"
    B, bound_ = MODEL_BATCH[dtype], MODEL_BOUND[dtype]
    for label, (name, kw) in MODELS.items():
        viz = name.split("_")[0] in ("topk", "tome")
        model, cfg = create_model(name, device=DEVICE, viz_mode=viz,
                                  generator=torch.Generator().manual_seed(1),
                                  **kw)
        model = model.to(dtype).eval()
        cpu_model = copy.deepcopy(model).cpu()
        x = images(B, torch.Generator().manual_seed(2), dtype)
        reset_counts()
        with torch.no_grad():
            out = model(x)
        torch.cuda.synchronize()
        got_counts = counts()
        require(got_counts == PER_FORWARD[label],
                f"{label}: launches {got_counts} != {PER_FORWARD[label]}")
        with torch.no_grad():
            ref = cpu_model(x.cpu())
        require(counts() == got_counts, "a CPU forward launched a kernel")
        flips = ""
        if viz and cfg.method == "topk":
            (out, v), (ref, v_ref) = out, ref
            n_flip = sum(int((v["Kept_Tokens"][i].cpu() != k).sum())
                         for i, k in v_ref["Kept_Tokens"].items())
            # kept ids that the CPU kept too, in any order
            n_kept = sum(int(torch.isin(a, b).sum())
                         for i, k in v_ref["Kept_Tokens"].items()
                         for a, b in zip(v["Kept_Tokens"][i].cpu(), k))
            n_all = sum(k.numel() for k in v_ref["Kept_Tokens"].values())
            widths = [k.shape[1] + 1 for k in v_ref["Kept_Tokens"].values()]
            flips = (f"; widths 197->{'->'.join(map(str, widths))}; "
                     f"Kept_Tokens flips {n_flip}/{n_all}, same kept set "
                     f"{n_kept}/{n_all} (bound {KEPT_SET[dtype]})")
            require(n_kept >= KEPT_SET[dtype] * n_all,
                    f"{label} {tag}: only {n_kept}/{n_all} kept ids in the "
                    "CPU's kept set")
        elif viz:  # ToMe
            (out, v), (ref, v_ref) = out, ref
            maps, ref_maps = v["Assignment_Maps"], v_ref["Assignment_Maps"]
            require(sorted(maps) == sorted(ref_maps)
                    == list(cfg.reduction_loc),
                    f"{label} {tag}: merges at {sorted(maps)}")
            n_same = sum(int((maps[i].cpu() == a).sum())
                         for i, a in ref_maps.items())
            n_all = sum(a.numel() for a in ref_maps.values())
            widths = [v["Features"][i].shape[1] for i in cfg.reduction_loc]
            flips = (f"; widths 197->{'->'.join(map(str, widths))}; "
                     f"Assignment_Maps entries equal {n_same}/{n_all} "
                     f"({n_same / n_all:.4f}, bound {ASSIGN_SAME[dtype]})")
            require(n_same >= ASSIGN_SAME[dtype] * n_all,
                    f"{label} {tag}: only {n_same}/{n_all} assignment "
                    "entries equal the CPU's")
            if dtype == torch.bfloat16:
                # the merge is deterministic: a second forward, same bits
                with torch.no_grad():
                    again = model(x)[0]
                require(torch.equal(again, out),
                        f"{label} {tag}: two forwards differ")
                flips += "; a second forward gave the same logits"
                reset_counts()
        out = out.cpu()
        require(out.shape == (B, cfg.num_classes) and
                bool(torch.isfinite(out).all()), f"{label}: bad logits")
        err, rel = rel_err(out, ref)
        top1 = (out.argmax(1) == ref.argmax(1)).float().mean().item()
        if viz and dtype == torch.bfloat16:
            limit = "reported only"
        else:
            limit = f"bound {bound_:.0e}"
            require(rel <= bound_, f"{label} {tag}: logits error {rel:.3e} "
                    f"of max|CPU| > {bound_:.0e}")
        require(top1 >= MODEL_TOP1[dtype], f"{label} {tag}: top-1 agreement "
                f"{top1:.3f} < {MODEL_TOP1[dtype]}")
        print(f"phase 3 model {label} ({name}) {tag} B={B}: logits max abs "
              f"err {err:.3e} ({rel:.2e} of max|CPU|, {limit}); "
              f"top-1 agreement {top1:.3f} (bound {MODEL_TOP1[dtype]}); "
              f"launches {got_counts}{flips}", flush=True)


def label_smoothing_loss(out, targets, images_, params):
    return losses.label_smoothing_ce(out, targets, 0.1)


def record_kept(model) -> dict:
    """Record the top-k ids each reduction block gathers in training."""
    kept = {}
    for i in model.cfg.reduction_loc:
        blk = model.blocks[i]

        def gather(x, idx, generator=None, i=i, inner=blk.ffn_gather):
            kept[i] = idx.detach().cpu()
            return inner(x, idx, generator)

        blk.ffn_gather = gather
    return kept


MATCHING = tome_model.bipartite_soft_matching
MERGES = {"cuda": {}, "cpu": {}}  # device type -> {merge: [B, t] ids}


def recorded_matching(metric, r, **kw):
    """ToMe's matching, recording each merge's ids (source, destination,
    then the unmerged) by the device it ran on."""
    info = MATCHING(metric, r, **kw)
    merges = MERGES[metric.device.type]
    merges[len(merges)] = torch.cat(
        [info.src_idx, info.dst_idx, info.unm_idx], 1).cpu()
    return info


def phase_train_models(dtype):
    """Phase 3, training: the loss and every gradient of one train step of
    the full-width models on the card against the CPU (drop_path 0), and
    the launches of one whole train step."""
    tome_model.bipartite_soft_matching = recorded_matching
    try:
        for label in TRAIN_MODELS:
            train_model_check(label, dtype)
    finally:
        tome_model.bipartite_soft_matching = MATCHING


def train_model_check(label, dtype):
    """One model's phase 3 training check (see phase_train_models)."""
    tag = "fp32" if dtype == torch.float32 else "bf16 amp"
    B, bound_ = MODEL_BATCH[dtype], TRAIN_BOUND[dtype]
    cfg = StepConfig(amp=dtype == torch.bfloat16)
    name, kw = MODELS[label]
    model, _ = create_model(name, device=DEVICE,
                            generator=torch.Generator().manual_seed(1),
                            **kw)
    cpu_model = copy.deepcopy(model).cpu()
    merging = model.cfg.method == "tome"
    if merging:
        kept, cpu_kept = MERGES["cuda"], MERGES["cpu"]
        kept.clear()
        cpu_kept.clear()
    else:
        kept, cpu_kept = record_kept(model), record_kept(cpu_model)
    gen = torch.Generator().manual_seed(2)
    x = images(B, gen)
    y = torch.randint(0, 1000, (B,), generator=gen).to(DEVICE)
    opt, _ = create_optimizer(dict(model.named_parameters()),
                              OptimConfig(lr=1e-3, clip_grad=1.0,
                                          backbone_lr_scale=0.01),
                              lambda s: 1e-3, [])
    state = init_train_state(model, opt, device=DEVICE)
    cpu_state = init_train_state(cpu_model, opt, device="cpu")
    model.train()
    cpu_model.train()
    reset_counts()
    loss, grads = loss_and_grads(model, label_smoothing_loss, state.params,
                                 x, y, cfg)
    torch.cuda.synchronize()
    fwd_bwd = counts()
    require(fwd_bwd == PER_TRAIN_STEP[label] and
            backward_counts() == PER_TRAIN_STEP_BWD[label],
            f"{label} {tag}: launches {fwd_bwd}, backward "
            f"{backward_counts()}")
    cpu_loss, cpu_grads = loss_and_grads(cpu_model, label_smoothing_loss,
                                         cpu_state.params, x.cpu(),
                                         y.cpu(), cfg)
    require(counts() == fwd_bwd, "a CPU train step launched a kernel")
    _, loss_rel = rel_err(loss.cpu().reshape(1), cpu_loss.reshape(1))
    worst_name, worst = "", 0.0
    for n, g in grads.items():
        _, rel = rel_err(g.cpu(), cpu_grads[n])
        if rel >= worst:
            worst_name, worst = n, rel
    require(sorted(kept) == sorted(cpu_kept),
            f"{label} {tag}: selections at {sorted(kept)} and, on the "
            f"CPU, {sorted(cpu_kept)}")
    n_all = sum(k.numel() for k in cpu_kept.values())
    in_place = sum(int((kept[i] == cpu_kept[i]).sum()) for i in cpu_kept)
    require(loss_rel <= bound_["loss"], f"{label} {tag}: loss "
            f"{loss_rel:.3e} of max|CPU| > {bound_['loss']:.0e}")
    if merging:  # merge ids (src, dst, unmerged), equal in place
        what = (f"merge ids equal {in_place}/{n_all} ("
                f"{'bound 1.0' if dtype == torch.float32 else 'reported'}"
                ")")
    else:
        same_set = sum(int(torch.isin(a, b).sum()) for i in cpu_kept
                       for a, b in zip(kept[i], cpu_kept[i]))
        require(same_set >= bound_["kept_set"] * n_all,
                f"{label} {tag}: only {same_set}/{n_all} kept ids in the "
                "CPU's kept set")
        what = (f"kept ids in place {in_place}/{n_all}, in the CPU's kept "
                f"set {same_set}/{n_all} (bound {bound_['kept_set']})")
    if dtype == torch.float32:
        require(in_place == n_all,
                f"{label} {tag}: selections differ from the CPU's")
    # gradients are held where the selection is exact or absent
    grads_held = dtype == torch.float32 or not cpu_kept
    if grads_held:
        require(worst <= bound_["grads"], f"{label} {tag}: gradient "
                f"{worst_name} {worst:.3e} of max|CPU| > "
                f"{bound_['grads']:.0e}")
    # one whole train step: the launches of both counterparts
    step = make_train_step(model, label_smoothing_loss, opt, cfg)
    reset_counts()
    state, metrics = step(state, {"image": x, "label": y})
    torch.cuda.synchronize()
    require(counts() == PER_TRAIN_STEP[label] and
            backward_counts() == PER_TRAIN_STEP_BWD[label],
            f"{label} {tag}: train step launches {counts()}")
    require(bool(torch.isfinite(metrics["loss"])), f"{label}: bad loss")
    limit = (f"bound {bound_['grads']:.0e}" if grads_held
             else "reported only")
    print(f"phase 3 train {label} {tag} B={B}: loss {loss.item():.6f} vs "
          f"CPU {cpu_loss.item():.6f} ({loss_rel:.2e} rel, bound "
          f"{bound_['loss']:.0e}); worst gradient leaf {worst_name} "
          f"{worst:.2e} of its max|CPU| ({limit}); {what}; launches of "
          f"one train step {counts()}, backward {backward_counts()}",
          flush=True)


def phase_serve(card: str) -> dict:
    """Phase 4: serve SERVE_BATCHES batches of SERVE_B bf16 images per
    model; the launch counts of this run go into the JSON record."""
    reset_counts()
    expected = dict.fromkeys(WRAPPERS, 0)
    for label, (name, kw) in MODELS.items():
        settle()
        model, _ = create_model(name, device=DEVICE,
                                generator=torch.Generator().manual_seed(1),
                                **kw)
        model = model.to(torch.bfloat16).eval()
        xs = images(SERVE_BATCHES * SERVE_B,
                    torch.Generator().manual_seed(3), torch.bfloat16) \
            .view(SERVE_BATCHES, SERVE_B, 3, 224, 224)
        seconds = []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                out = model(x)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                require(out.shape == (SERVE_B, 1000) and
                        bool(torch.isfinite(out).all()),
                        f"{label}: non-finite or misshapen bf16 logits")
        for k, n in PER_FORWARD[label].items():
            expected[k] += n * SERVE_BATCHES
        ips = SERVE_B * (SERVE_BATCHES - 1) / sum(seconds[1:])
        print(f"phase 4 serve {label} bf16 b{SERVE_B}: {ips:.1f} img/s over "
              f"batches 2-{SERVE_BATCHES} (first batch "
              f"{seconds[0] * 1e3:.1f} ms) on {card}", flush=True)
        del model, xs
    got = counts()
    require(got == expected, f"serve launches {got} != {expected}")
    require(all(got[k] for k in EVAL_WRAPPERS),
            f"a kernel of the path never ran: {got}")
    return got


def train_run(label: str, steps: int, profile: bool = False):
    """bench.py's train recipe for `steps` steps of TRAIN_B; returns
    (seconds per step, losses, profile) where profile, after two more
    steps under torch.profiler, is (the device's busy share of their
    wall time, {kernel: device microseconds}), else None."""
    settle()
    name, kw = MODELS[label]
    model, _ = create_model(name, device=DEVICE, drop_path_rate=0.1,
                            generator=torch.Generator().manual_seed(1), **kw)
    opt, _ = create_optimizer(dict(model.named_parameters()),
                              OptimConfig(lr=1e-3, clip_grad=1.0,
                                          backbone_lr_scale=0.01),
                              lambda s: 1e-3, [])
    state = init_train_state(model, opt, ema=True, device=DEVICE)
    step = make_train_step(model, label_smoothing_loss, opt,
                           StepConfig(ema_decay=0.99996, amp=True),
                           torch.Generator(device=DEVICE).manual_seed(5))
    data = torch.Generator(device=DEVICE).manual_seed(3)
    xs = torch.randn(steps, TRAIN_B, 3, 224, 224, generator=data,
                     device=DEVICE)
    ys = torch.randint(0, 1000, (steps, TRAIN_B), generator=data,
                       device=DEVICE)
    first = {n: p.detach().clone() for n, p in state.params.items()}
    seconds, step_losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, {"image": xs[i], "label": ys[i]})
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        step_losses.append(metrics["loss"])
    prof_out = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(2):
                state, _ = step(state, {"image": xs[i], "label": ys[i]})
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        by_kernel = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = kernel_family(e.name)
                by_kernel[name] = by_kernel.get(name, 0.0) + \
                    e.time_range.elapsed_us()
        device_us = sum(by_kernel.values())
        if device_us > 0:
            prof_out = device_us / window_us, by_kernel
    step_losses = torch.stack(step_losses).cpu()
    require(bool(torch.isfinite(step_losses).all()),
            f"{label}: non-finite train losses {step_losses.tolist()}")
    moved = max((state.params[n] - p).abs().max().item()
                for n, p in first.items())
    ema_moved = max((state.ema_params[n] - p).abs().max().item()
                    for n, p in first.items())
    require(moved > 0 and ema_moved > 0,
            f"{label}: params moved {moved}, EMA {ema_moved}")
    return seconds, step_losses, prof_out


def kernel_family(name: str) -> str:
    """A profiler kernel name without its arguments; the port's kernels
    keep their template arguments (dtype and layout)."""
    name = name.replace("void ", "").replace("trk::(anonymous namespace)::",
                                             "")
    name = name.split("(")[0]
    own = ("gemm_kernel", "short_attention", "layer_norm", "sum_partials")
    return name if name.startswith(own) else name.split("<")[0]


def phase_train(card: str) -> dict:
    """Phase 5: the train steps; the launch counts of this run go into the
    JSON record. Then the eager library composition's steps and, last,
    the profiled windows, whose launches are not counted."""
    reset_counts()
    step_ms = {}
    for label in TRAIN_MODELS:
        seconds, step_losses, _ = train_run(label, TRAIN_STEPS)
        timed = seconds[2:]
        step_ms[label] = 1e3 * sum(timed) / len(timed)
        print(f"phase 5 train {label} bf16 amp b{TRAIN_B}: "
              f"{step_ms[label]:.2f} ms/step, "
              f"{TRAIN_B * len(timed) / sum(timed):.1f} img/s over steps "
              f"3-{TRAIN_STEPS} (first step {seconds[0] * 1e3:.1f} ms); "
              f"losses {[round(v, 4) for v in step_losses.tolist()]} on "
              f"{card}", flush=True)
    got = counts()
    expected = {k: TRAIN_STEPS * sum(PER_TRAIN_STEP[label][k]
                                     for label in TRAIN_MODELS)
                for k in WRAPPERS}
    require(got == expected, f"train launches {got} != {expected}")
    require(all(got[k] for k in TRAIN_WRAPPERS),
            f"a kernel of the path never ran: {got}")

    kernels = (layers.attend_branch_train, layers.mlp_branch,
               layers.attention_core_train)
    layers.attend_branch_train = library_attention
    layers.mlp_branch = library_mlp
    layers.attention_core_train = library_core
    try:
        for label in TRAIN_MODELS:
            seconds, _, _ = train_run(label, TRAIN_STEPS)
            timed = seconds[2:]
            print(f"phase 5 train {label} bf16 amp b{TRAIN_B}, eager library "
                  f"composition: {1e3 * sum(timed) / len(timed):.2f} ms/step, "
                  f"{TRAIN_B * len(timed) / sum(timed):.1f} img/s over steps "
                  f"3-{TRAIN_STEPS}", flush=True)
    finally:
        (layers.attend_branch_train, layers.mlp_branch,
         layers.attention_core_train) = kernels

    for label in ("topk@0.7", "tome@0.7"):
        _, _, prof = train_run(label, 4, profile=True)
        if prof is None:
            print(f"phase 5 profile {label}: device time not measured (the "
                  "profiler saw no device events)", flush=True)
            continue
        busy, by_kernel = prof
        total = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
        # the profiler slows the host; the device time per step against
        # the step time measured above without it
        print(f"phase 5 profile {label} bf16 amp b{TRAIN_B}: device busy "
              f"{100 * busy:.1f}% of two steps (torch.profiler); device time "
              f"{total / 2e3:.2f} ms per step, "
              f"{100 * total / 2e3 / step_ms[label]:.1f}% "
              f"of the unprofiled {step_ms[label]:.2f} ms/step; device time "
              f"by kernel: " + "; ".join(
                  f"{name} {100 * us / total:.1f}%" for name, us in top),
              flush=True)
    return got


def main():
    # phase 0
    root = pathlib.Path(__file__).resolve().parent
    package = pathlib.Path(tokenreduction_tpu_torch.__file__).resolve()
    require(package.parents[1] == root,
            f"the port imported from {package}, not from the checkout {root}")
    require(torch.cuda.is_available(),
            "no CUDA device: chip_smoke.py runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()})"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 0 device: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; TF32 off", flush=True)

    # phase 1
    from tokenreduction_tpu_torch.ops import _build

    kern = _build.kernels()
    print(f"phase 1 build: {kern.path} in {kern.build_seconds:.1f} s "
          f"(0 = already built)", flush=True)
    for line in kern.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"phase 1 ptxas: {line.strip()}")

    rec = phase_kernels()
    # fused_attention runs on the main path only as the training core's
    # forward (counted there): its record stands apart from the JSON line
    print("phase 2 record fused_attention: "
          f"{json.dumps(rec['fused_attention'])}",
          flush=True)
    phase_launchers()
    for dtype in (torch.float32, torch.bfloat16):
        phase_models(dtype)
    for dtype in (torch.float32, torch.bfloat16):
        phase_train_models(dtype)
    launches = phase_serve(card)
    launches.update({k: v for k, v in phase_train(card).items()
                     if k in TRAIN_WRAPPERS})

    kernels = [dict(name=name, route="cuda", source=CUDA_SOURCES[name][0],
                    cuda_sources=CUDA_SOURCES[name],
                    wrapper=WRAPPER_SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    library_ms=None, **rec[name]) for name in WRAPPERS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
