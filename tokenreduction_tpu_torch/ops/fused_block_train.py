"""The attention branch of a training block, with a hand-written backward.

``attend_branch_train`` is the counterpart of
``tokenreduction_tpu/ops/fused_block_train.py:344 attend_branch_train``:

    branch = proj(attn(qkv(LN1 x))),   row0 = probs[:, :, 0, :]

without the residual (stochastic depth and the residual compose
outside). It is a ``torch.autograd.Function`` differentiable in both
outputs: the fp32 cotangent of row0 [B, H, N] enters the softmax backward
at query row 0, as EViT's differentiable CLS row needs. The backward
returns dx and every parameter gradient, each in its parameter's dtype
(bf16 under amp, as the TPU kernel casts its fp32 accumulators).

Numerics (the TPU kernel's rounding points): fp32 LayerNorm, its output
rounded to x's dtype; qkv rounded; the fp32 softmax with the exact row
max, its normalised probabilities rounded before PV; merged heads
rounded; branch rounded. Backward: dattn = dY Wproj rounded; dV = P^T
dO; dP = dO V^T plus the row0 cotangent on row 0; dS = P (dP - rowsum(dP
P)) * scale rounded; dq, dk, dv rounded; dLN = dqkv Wqkv in fp32; the
bias gradients summed from the rounded dY and dqkv.

Where it splits, and why: the TPU kernel recomputes LN, qkv and the
probabilities from x in VMEM and accumulates the weight gradients across
its sequential grid in VMEM-resident fp32. A Hopper SM has 227 KB of
shared memory and its blocks run in no order, so on the card the branch
is a chain of the hand-written kernels (``csrc/``):

- forward: ``layer_norm``; ``gemm`` qkv; ``short_attention`` with the
  normalised probabilities rounded and row0; ``gemm`` proj;
- backward: ``gemm`` dattn = dY Wproj reading Wproj untransposed;
  ``gemm_wgrad`` dWproj, dbproj; ``short_attention_bwd`` (P from the
  forward's row statistics, writes the packed dqkv); ``gemm_wgrad`` dWqkv,
  dbqkv; ``gemm`` dLN = dqkv Wqkv in fp32; ``layer_norm_bwd``. The weight
  and bias gradients are fp32 partials over slices of the rows, and the
  LayerNorm's parameter gradients over bands of rows; all five are summed
  in a fixed order by one ``sum_partials_many`` launch, the branch's last:
  no atomics, the same bits from run to run.

The forward saves the LN output, qkv and the merged heads (5D elements of
x's dtype per row) instead of recomputing them: at topk@0.7 DeiT-S b256
bf16 the 12 attention halves hold 417,024 rows, about 1.6 GB; and row0
and the attention's row statistics (fp32, 3H per row), which the
attention backward reads with the merged heads (csrc/attention_sm90.cu).

What bounds it: the four products at K = 384 lose much of each output
tile to its fill and epilogue (csrc/gemm_sm90.cu); the attention
(csrc/attention_sm90.cu) not by its loads: its forward by its elementwise
softmax at two warpgroups an SM, its backward by loads, products and
elementwise work that run one after another.

Above 256 tokens the bf16 attention is ``csrc/attention_wide_sm90.cu``'s
(the keys streamed in 64-key tiles, the backward in two launches), up to
``ATTENTION_MAX_N``; there is no fp32 backward above 256 tokens.

On a CPU tensor the branch runs ``attend_branch_train_ref`` forward and
``attend_branch_train_bwd_ref`` backward; on a CUDA tensor it launches
the kernels or raises (N above 2048 in bf16 or 256 in fp32, head dim
other than 64).
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.ops.flash_attention import (
    backward_max_n,
    check_attention_operands,
    layer_norm_bwd_ref,
    layer_norm_f32,
    layer_norm_stats,
    linear_f32,
)


def _attention_probs(qkv, num_heads: int, scale: float):
    """fp32 q, k, v [B, H, N, hd] of a packed qkv [B, N, 3D] and the
    normalised probabilities [B, H, N, N] (exact row max)."""
    B, N, D3 = qkv.shape
    q, k, v = qkv.float().reshape(B, N, 3, num_heads, D3 // 3 // num_heads) \
        .permute(2, 0, 3, 1, 4)
    s = (q @ k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return q, k, v, e * (1.0 / e.sum(-1, keepdim=True))


def _merge(t):
    """[B, H, N, hd] -> [B, N, H * hd]."""
    B, H, N, hd = t.shape
    return t.transpose(1, 2).reshape(B, N, H * hd)


def attention_train_ref(qkv, num_heads: int, scale: float):
    """Plain training attention off a packed qkv [B, N, 3D]: (merged heads
    in qkv's dtype, the normalised probabilities rounded before PV; row0
    [B, H, N] fp32)."""
    _, _, v, p = _attention_probs(qkv, num_heads, scale)
    return _merge(p.to(qkv.dtype).float() @ v).to(qkv.dtype), p[:, :, 0, :]


def attention_bwd_ref(qkv, dout, drow0, num_heads: int, scale: float):
    """Plain backward of ``attention_train_ref``: the packed dqkv
    [B, N, 3D] in qkv's dtype from the merged heads' gradient dout
    [B, N, D] (qkv's dtype) and the fp32 row0 cotangent [B, H, N]."""
    dt = qkv.dtype
    B, N, D3 = qkv.shape
    q, k, v, p = _attention_probs(qkv, num_heads, scale)
    pc = p.to(dt).float()
    do = dout.to(dt).float().reshape(B, N, num_heads, -1).transpose(1, 2)
    dv = (pc.transpose(-1, -2) @ do).to(dt)
    dp = do @ v.transpose(-1, -2)
    dp[:, :, 0, :] += drow0.float()  # the row0 cotangent enters at row 0
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dt).float()
    dq, dk = (ds @ k).to(dt), (ds.transpose(-1, -2) @ q).to(dt)
    return torch.stack([_merge(dq), _merge(dk), _merge(dv)], 2) \
        .reshape(B, N, D3)


def attend_branch_train_ref(x, ls, lb, wqkv, bqkv, wproj, bproj,
                            num_heads: int, scale: float, eps: float = 1e-6):
    """Plain forward of ``attend_branch_train`` (the kernels' rounding
    points). Returns (branch in x's dtype, row0 [B, H, N] fp32)."""
    dt = x.dtype
    ln = layer_norm_f32(x.float(), ls, lb, eps).to(dt)
    qkv = linear_f32(ln, wqkv, bqkv).to(dt)
    merged, row0 = attention_train_ref(qkv, num_heads, scale)
    return linear_f32(merged, wproj, bproj).to(dt), row0


def attend_branch_train_bwd_ref(x, ls, lb, wqkv, bqkv, wproj, dy, drow0,
                                num_heads: int, scale: float,
                                eps: float = 1e-6, res=None):
    """Plain hand-written backward of ``attend_branch_train``: the TPU
    kernel's ``_bwd_kernel`` (fused_block_train.py:95-205) with its
    rounding points. Returns (dx, dls, dlb, dwqkv, dbqkv, dwproj, dbproj),
    weights in nn.Linear's [out, in] layout. res (x's shape, or None) is
    added to dx in fp32 before its rounding: a residual's cotangent (the
    kernel tools' residual-fused branch)."""
    dt = x.dtype
    B, N, D = x.shape
    x_hat, rstd = layer_norm_stats(x.float().reshape(B * N, D), eps)
    ln = (x_hat * ls.float() + lb.float()).to(dt)
    qkv = linear_f32(ln, wqkv, bqkv).to(dt).reshape(B, N, 3 * D)
    merged = attention_train_ref(qkv, num_heads, scale)[0] \
        .reshape(B * N, D).float()
    dy = dy.to(dt).reshape(B * N, D).float()
    dattn = (dy @ wproj.float()).to(dt)
    dqkv = attention_bwd_ref(qkv, dattn.reshape(B, N, D), drow0, num_heads,
                             scale).reshape(B * N, 3 * D).float()
    dx, dls, dlb = layer_norm_bwd_ref(dqkv @ wqkv.float(), x_hat, rstd, ls)
    if res is not None:
        dx = dx + res.float().reshape(B * N, D)
    return (dx.to(dt).reshape(B, N, D), dls.to(ls.dtype), dlb.to(lb.dtype),
            (dqkv.T @ ln.float()).to(wqkv.dtype), dqkv.sum(0).to(bqkv.dtype),
            (dy.T @ merged).to(wproj.dtype), dy.sum(0).to(ls.dtype))


def _fwd_cuda(x, ls, lb, wqkv, bqkv, wproj, bproj, num_heads, scale, eps,
              s=None):
    """Forward launches; returns (branch, row0, saved intermediates). With
    s (fp32 [B], bf16 only) the proj GEMM's epilogue writes x + s_b *
    branch instead of the branch (the kernel tools' residual-fused
    branch)."""
    from tokenreduction_tpu_torch.ops import _build

    B, N, D = x.shape
    rows = x.view(B * N, D)
    ln = torch.empty_like(rows)
    _build.layer_norm(rows, ls, lb, ln, eps=eps)
    qkv = torch.empty(B, N, 3 * D, dtype=x.dtype, device=x.device)
    _build.gemm(ln, wqkv, bqkv, qkv.view(B * N, 3 * D))
    merged = torch.empty_like(x)
    row0 = torch.empty(B, num_heads, N, dtype=torch.float32, device=x.device)
    # the row statistics for the backward (the bf16 kernel's)
    stats = torch.empty(B, num_heads, N, 2, dtype=torch.float32,
                        device=x.device) if x.dtype == torch.bfloat16 \
        else None
    _build.short_attention(qkv, merged, num_heads, scale, row0=row0,
                           stats=stats, norm_p=True)
    branch = torch.empty_like(x)
    if s is None:
        _build.gemm(merged.view(B * N, D), wproj, bproj, branch.view(B * N, D))
    else:
        _build.gemm(merged.view(B * N, D), wproj, bproj, branch.view(B * N, D),
                    res=rows, row_scale=s, scale_rows=N)
    return branch, row0, (ln, qkv, merged, row0, stats)


def _bwd_cuda(x, ls, wqkv, wproj, saved, dy, drow0, num_heads, scale, eps,
              s=None):
    """Backward launches; returns the seven gradients. With s (fp32 [B]),
    dy is the cotangent of x + s_b * branch: the branch's, round(s_b dy),
    is written once by ``row_scale``, and dy is added to dx in the
    LayerNorm backward before its rounding (the kernel tools'
    residual-fused branch)."""
    from tokenreduction_tpu_torch.ops import _build

    ln, qkv, merged, row0, stats = saved
    B, N, D = x.shape
    M = B * N
    dy = dy.view(M, D)
    res = None
    if s is not None:
        res, dy = dy, torch.empty_like(dy)
        _build.row_scale(res, s, dy, rows=N)
    dattn = torch.empty(B, N, D, dtype=x.dtype, device=x.device)
    _build.gemm(dy, wproj, None, dattn.view(M, D), w_kn=True)
    dwproj = torch.empty_like(wproj)
    dbproj = torch.empty(D, dtype=ls.dtype, device=x.device)
    # the branch's fixed-order partial sums, one launch at the end
    sums = _build.gemm_wgrad(dy, merged.view(M, D), dwproj, dbproj)
    dqkv = torch.empty_like(qkv)
    _build.short_attention_bwd(qkv, merged, dattn, drow0, dqkv, num_heads,
                               scale, stats=stats, row0=row0)
    dqkv = dqkv.view(M, 3 * D)
    dwqkv = torch.empty_like(wqkv)
    dbqkv = torch.empty(3 * D, dtype=wqkv.dtype, device=x.device)
    sums += _build.gemm_wgrad(dqkv, ln, dwqkv, dbqkv)
    dln = torch.empty(M, D, dtype=torch.float32, device=x.device)
    _build.gemm(dqkv, wqkv, None, dln, w_kn=True)
    dx = torch.empty_like(x)
    dlnp = torch.empty(2, D, dtype=ls.dtype, device=x.device)
    sums += _build.layer_norm_bwd(x.view(M, D), ls, dln, dx.view(M, D), dlnp,
                                  eps=eps, res=res)
    _build.sum_partials_many(sums)
    return dx, dlnp[0], dlnp[1], dwqkv, dbqkv, dwproj, dbproj


class _AttendBranch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ls, lb, wqkv, bqkv, wproj, bproj, num_heads, scale,
                eps):
        ctx.hyper = (num_heads, scale, eps)
        if x.is_cuda:
            branch, row0, saved = _fwd_cuda(x, ls, lb, wqkv, bqkv, wproj,
                                            bproj, num_heads, scale, eps)
            attend_branch_train.launches += 1
        else:
            (branch, row0), saved = attend_branch_train_ref(
                x, ls, lb, wqkv, bqkv, wproj, bproj, num_heads, scale,
                eps), ()
        ctx.save_for_backward(x, ls, lb, wqkv, bqkv, wproj, *saved)
        return branch, row0

    @staticmethod
    def backward(ctx, dy, drow0):
        x, ls, lb, wqkv, bqkv, wproj, *saved = ctx.saved_tensors
        num_heads, scale, eps = ctx.hyper
        dy = dy.to(x.dtype).contiguous()
        drow0 = drow0.float().contiguous()
        if x.is_cuda:
            grads = _bwd_cuda(x, ls, wqkv, wproj, saved, dy, drow0,
                              num_heads, scale, eps)
            attend_branch_train.launches += 1
            attend_branch_train.backward_launches += 1
        else:
            grads = attend_branch_train_bwd_ref(x, ls, lb, wqkv, bqkv, wproj,
                                                dy, drow0, num_heads, scale,
                                                eps)
        return (*grads, None, None, None)


def attend_branch_train(x, ls, lb, wqkv, bqkv, wproj, bproj, num_heads: int,
                        scale: float, eps: float = 1e-6):
    """x [B, N, D] -> (proj(attn(qkv(LN x))) [B, N, D] in x's dtype,
    row0 [B, H, N] fp32), differentiable in x, every parameter and both
    outputs. Weights in nn.Linear's [out, in] layout: wqkv [3D, D], wproj
    [D, D]. ``launches`` counts the CUDA forwards and backwards,
    ``backward_launches`` the backwards alone."""
    if x.is_cuda:
        check_attention_operands("attend_branch_train", x, num_heads, ls, lb,
                                 wqkv, bqkv, wproj, bproj,
                                 backward_max_n(x.dtype))
    return _AttendBranch.apply(x, ls, lb, wqkv, bqkv, wproj, bproj,
                               num_heads, scale, eps)


attend_branch_train.launches = 0
attend_branch_train.backward_launches = 0
