"""The residual and the per-image drop-path scale fused into the training
attention branch's kernels: the counterpart of
``tools/proto_residual_fuse.py``.

The port composes a training block's attention half outside the kernels
(``core/layers.py``: ``x + drop_path(branch)``): one elementwise pass over
[B, N, D] after the branch's forward, one before its backward (the
branch's cotangent s_b dy) and one after it (dx + dy). ``attend_block_res``
moves them into the kernels, as the TPU kernels ``_fwd_kernel_res`` and
``_bwd_kernel_res`` do:

    out = round(x + s_b (proj(attn(qkv(LN1 x))) + bproj))   (fp32 sum)

with s fp32 [B] (mask_b / keep), differentiable in x and the six
parameters and not in s, with the cotangents (dy, drow0). On the card
(bf16) it is ``attend_branch_train``'s chain of launches with two options:

- forward: the proj GEMM's epilogue takes the row scale s[m // N] and the
  residual x (csrc/gemm_sm90.cu, its scaled variant);
- backward: the branch's cotangent round(s_b dy) is written once by a small
  kernel (csrc/ln_gemm.cu row_scale_kernel) and feeds dY . Wproj, dWproj and
  dbproj; the LayerNorm backward adds dy to dx in fp32 before its rounding
  (csrc/ln_gemm.cu, layer_norm_bwd_kernel's residual variant). The row0
  cotangent enters the attention backward as in ``attend_branch_train``.

``main()`` times value and grad of a chain of branches, "outside"
(``attend_branch_train`` + x + s branch in PyTorch) against "fused", at
N = 197, 138, 97, and prints the gradients' relative differences, as the
JAX script does. What it found on the TPU is in its file.

    python -m tokenreduction_tpu_torch.tools.proto_residual_fuse

runs on the card; with ``--device cpu`` the plain versions run, timed by
the host's clock.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.ops import fused_block_train as FBT
from tokenreduction_tpu_torch.ops.flash_attention import (
    check_attention_operands,
    layer_norm_f32,
    linear_f32,
)
from tokenreduction_tpu_torch.tools import _measure as M

ITERS = 20  # the JAX tool's chained branches a timed run
WIDTHS = (197, 138, 97)
KEEP = 0.9  # drop_path 0.1, DeiT-S's protocol rate
PARAMS = ("ls", "lb", "wqkv", "bqkv", "wproj", "bproj")


def attend_block_res_ref(x, ls, lb, wqkv, bqkv, wproj, bproj, s,
                         num_heads: int, scale: float, eps: float = 1e-6):
    """Plain forward of ``attend_block_res`` with the TPU kernel's rounding
    points: (x + s_b proj summed in fp32 and rounded once, row0 [B, H, N]
    fp32)."""
    dt = x.dtype
    ln = layer_norm_f32(x.float(), ls, lb, eps).to(dt)
    qkv = linear_f32(ln, wqkv, bqkv).to(dt)
    merged, row0 = FBT.attention_train_ref(qkv, num_heads, scale)
    proj = linear_f32(merged, wproj, bproj)
    return (x.float() + s.float()[:, None, None] * proj).to(dt), row0


def attend_block_res_bwd_ref(x, ls, lb, wqkv, bqkv, wproj, s, dy, drow0,
                             num_heads: int, scale: float,
                             eps: float = 1e-6):
    """Plain backward of ``attend_block_res``: the branch's cotangent
    round(s_b dy) through ``attend_branch_train``'s plain backward, and dy
    added to dx in fp32 before its rounding. Returns (dx, dls, dlb, dwqkv,
    dbqkv, dwproj, dbproj), weights in nn.Linear's layout."""
    dyb = (dy.float() * s.float()[:, None, None]).to(x.dtype)
    return FBT.attend_branch_train_bwd_ref(x, ls, lb, wqkv, bqkv, wproj, dyb,
                                           drow0, num_heads, scale, eps,
                                           res=dy)


class _AttendBlockRes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ls, lb, wqkv, bqkv, wproj, bproj, s, num_heads,
                scale, eps):
        ctx.hyper = (num_heads, scale, eps)
        if x.is_cuda:
            out, row0, saved = FBT._fwd_cuda(x, ls, lb, wqkv, bqkv, wproj,
                                             bproj, num_heads, scale, eps,
                                             s=s)
            attend_block_res.launches += 1
        else:
            (out, row0), saved = attend_block_res_ref(
                x, ls, lb, wqkv, bqkv, wproj, bproj, s, num_heads, scale,
                eps), ()
        ctx.save_for_backward(x, ls, lb, wqkv, bqkv, wproj, s, *saved)
        return out, row0

    @staticmethod
    def backward(ctx, dy, drow0):
        x, ls, lb, wqkv, bqkv, wproj, s, *saved = ctx.saved_tensors
        num_heads, scale, eps = ctx.hyper
        dy = dy.to(x.dtype).contiguous()
        drow0 = drow0.float().contiguous()
        if x.is_cuda:
            grads = FBT._bwd_cuda(x, ls, wqkv, wproj, saved, dy, drow0,
                                  num_heads, scale, eps, s=s)
            attend_block_res.backward_launches += 1
        else:
            grads = attend_block_res_bwd_ref(x, ls, lb, wqkv, bqkv, wproj, s,
                                             dy, drow0, num_heads, scale, eps)
        return (*grads, None, None, None, None)


def attend_block_res(x, ls, lb, wqkv, bqkv, wproj, bproj, s, num_heads: int,
                     scale: float, eps: float = 1e-6):
    """x [B, N, D], s fp32 [B] -> (x + s_b proj(attn(qkv(LN x))) [B, N, D]
    in x's dtype, row0 [B, H, N] fp32), differentiable in x and the six
    parameters (not in s) and in both outputs. Weights in nn.Linear's
    layout: wqkv [3D, D], wproj [D, D]. On the card bf16 only (the scaled
    GEMM variant is bf16's), head dim 64, N <= 2048 (the attention
    kernels' ATTENTION_MAX_N); ``launches`` counts the card's forwards
    and ``backward_launches`` its backwards."""
    if x.is_cuda:
        name = "attend_block_res"
        check_attention_operands(name, x, num_heads, ls, lb, wqkv, bqkv,
                                 wproj, bproj)
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the card's residual-fused kernels take "
                            f"bf16, got {x.dtype}")
        if (s.dtype != torch.float32 or tuple(s.shape) != (x.shape[0],)
                or s.device != x.device or not s.is_contiguous()):
            raise ValueError(f"{name}: s must be a contiguous fp32 [B] on "
                             f"{x.device}, got {s.dtype} {tuple(s.shape)} on "
                             f"{s.device}")
    return _AttendBlockRes.apply(x, ls, lb, wqkv, bqkv, wproj, bproj, s,
                                 num_heads, scale, eps)


attend_block_res.launches = 0
attend_block_res.backward_launches = 0


def drop_scale(B: int, device, seed: int = 1) -> torch.Tensor:
    """s fp32 [B]: keep_b / KEEP with keep_b ~ Bernoulli(KEEP), seeded."""
    g = torch.Generator().manual_seed(seed)
    return ((torch.rand(B, generator=g) < KEEP).float() / KEEP).to(device)


def chain(variant: str, n: int, device, iters: int = ITERS,
          B: int = M.BATCH):
    """(fn, w, x0): fn() returns (loss, {param: grad}) of the mean of
    ``iters`` chained attention halves of width n, "outside" (the branch,
    then x + s branch in PyTorch) or "fused" (``attend_block_res``)."""
    w = {k: t.requires_grad_() for k, t in M.weights(device).items()
         if k in PARAMS}
    x0 = M.inputs(B, n, device, seed=0)
    s = drop_scale(B, device)
    args = [w[k] for k in PARAMS]

    def fn():
        for t in args:
            t.grad = None
        c = x0
        for _ in range(iters):
            if variant == "outside":
                br, _ = FBT.attend_branch_train(c, *args, M.H, M.SCALE,
                                                M.EPS)
                out = c + s[:, None, None] * br
            else:
                out, _ = attend_block_res(c, *args, s, M.H, M.SCALE, M.EPS)
            c = (out * (1.0 / (1 + 1e-6))).to(x0.dtype)
        loss = c.mean()
        loss.backward()
        return loss.detach(), {k: w[k].grad for k in PARAMS}

    return fn, w, x0


def main(argv=None):
    p = M.parser("Value and grad of a chain of training attention halves: "
                 "the residual and drop-path outside the kernels against "
                 "fused into them.")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    iters = args.iters or ITERS
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu (plain versions)", flush=True)
    for n in WIDTHS:
        grads = {}
        for variant in ("outside", "fused"):
            fn, _, _ = chain(variant, n, device, iters, args.batch)
            ms = M.timeit(fn, device, 1, reps=3) / iters
            grads[variant] = fn()[1]
            print(f"N={n} {variant}: {ms:.4f} ms a branch "
                  f"({M.clock(device)})", flush=True)
        for key in PARAMS:
            a = grads["outside"][key].float()
            b = grads["fused"][key].float()
            rel = float((a - b).abs().max() / (a.abs().max() + 1e-9))
            if rel > 1e-5:
                print(f"  N={n} {key} rel|d|={rel:.2e}", flush=True)
        print(f"  N={n} grads match (rel|d| <= 1e-5 where not printed)",
              flush=True)


if __name__ == "__main__":
    main()
