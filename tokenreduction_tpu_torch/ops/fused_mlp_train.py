"""The MLP branch of a training block, with a hand-written backward.

``mlp_branch`` is the counterpart of
``tokenreduction_tpu/ops/fused_mlp_train.py:257 mlp_branch``:

    branch = fc2(gelu(fc1(LN2 x)))

without the residual: stochastic depth and the residual compose outside,
so autograd around the branch stays exact. It is a
``torch.autograd.Function`` whose backward returns dx and every parameter
gradient, each in its parameter's dtype (bf16 under amp, as the TPU
kernel casts its fp32 accumulators).

Numerics (the TPU kernel's rounding points): fp32 LayerNorm, its output
rounded to x's dtype; the pre-activation h in fp32 and GELU in the exact
erf form with its exact derivative Phi(h) + h phi(h) in both directions
(the TPU kernel's bf16 tanh form lies within 4.7e-4 of it); the hidden
activation rounded; in the backward dA = dY W2 in fp32, dH = dA GELU'(h)
with the bias gradient summed from the fp32 dH, dH rounded for dW1 and
dLN, and dLN in fp32.

Where it splits, and why: the TPU kernel recomputes LN and h from x in
VMEM and accumulates the weight gradients across its sequential grid in
VMEM-resident fp32 (4.7 MB at DeiT-S). A Hopper SM has 227 KB of shared
memory and its blocks run in no order, so on the card the branch is a
chain of the hand-written kernels in ``csrc/ln_gemm.cu``:

- forward: ``layer_norm``; ``gemm`` fc1 with bias and GELU, which also
  writes GELU'(h) in fp32; ``gemm`` fc2 with bias;
- backward: ``gemm`` dH = (dY W2) * GELU'(h) reading W2 untransposed,
  with the column sums of the fp32 dH (db1) per row tile; ``gemm_wgrad``
  for dW2, db2 and dW1 (fp32 partials over slices of the rows); ``gemm``
  dLN = dH W1 in fp32; ``layer_norm_bwd`` for dx, d gamma and d beta
  (partials over bands of rows). The five partial sums (db1, dW2, db2,
  dW1, the LayerNorm's) are one ``sum_partials_many`` launch, the
  branch's last, each in a fixed order: no atomics, the same bits from
  run to run.

The forward saves the LN output and the hidden activation in x's dtype
and GELU'(h) in fp32 (2D + 4D elements of x's dtype and 4D fp32 per row)
instead of recomputing them: at topk@0.7 DeiT-S b256 bf16 the 12 MLP
halves hold 384,000 rows, about 3.8 GB, on an 80 GB card.

What bounds it: the six products (2 forward, 4 backward) at K = 384 or
1536; at N <= 197 each 128x128 tile's fill and epilogue weigh about as
much as its tensor-core work, and the hidden tensor and its gradient make
round trips through device memory. A simple first version on mma.sync;
wgmma, TMA and keeping the hidden tensor on chip are later work.

On a CPU tensor the branch runs ``mlp_branch_ref`` forward and
``mlp_branch_bwd_ref`` backward; on a CUDA tensor it launches the kernels
or raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tokenreduction_tpu_torch.ops.flash_attention import (
    layer_norm_bwd_ref,
    layer_norm_f32,
    layer_norm_stats,
    linear_f32,
)
from tokenreduction_tpu_torch.ops.fused_mlp import check_mlp_operands

_INV_SQRT2 = 2.0 ** -0.5
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


def gelu_grad(h):
    """d gelu(h) / dh of the exact erf GELU: Phi(h) + h phi(h)."""
    return (0.5 * (1.0 + torch.erf(h * _INV_SQRT2))
            + h * _INV_SQRT2PI * torch.exp(-0.5 * h * h))


def mlp_branch_ref(x, ls, lb, w1, b1, w2, b2, eps: float = 1e-6):
    """Plain forward of ``mlp_branch`` (the kernels' rounding points)."""
    dt = x.dtype
    ln = layer_norm_f32(x.float(), ls, lb, eps).to(dt)
    a = F.gelu(linear_f32(ln, w1, b1)).to(dt)
    return linear_f32(a, w2, b2).to(dt)


def mlp_branch_bwd_ref(x, ls, lb, w1, b1, w2, g, eps: float = 1e-6):
    """Plain hand-written backward of ``mlp_branch``: the TPU kernel's
    ``_bwd_kernel`` (fused_mlp_train.py:81-137) with its rounding points.
    Returns (dx, dls, dlb, dw1, db1, dw2, db2), weights in nn.Linear's
    [out, in] layout."""
    dt, shape = x.dtype, x.shape
    x_hat, rstd = layer_norm_stats(x.float().reshape(-1, shape[-1]), eps)
    ln = (x_hat * ls.float() + lb.float()).to(dt)
    h = linear_f32(ln, w1, b1)
    a = F.gelu(h).to(dt)
    gc = g.to(dt).reshape(-1, shape[-1]).float()
    dh = (gc @ w2.float()) * gelu_grad(h)
    dh_c = dh.to(dt).float()
    dx, dls, dlb = layer_norm_bwd_ref(dh_c @ w1.float(), x_hat, rstd, ls)
    return (dx.to(dt).reshape(shape), dls.to(ls.dtype), dlb.to(lb.dtype),
            (dh_c.T @ ln.float()).to(w1.dtype), dh.sum(0).to(b1.dtype),
            (gc.T @ a.float()).to(w2.dtype), gc.sum(0).to(b1.dtype))


def _fwd_cuda(x, ls, lb, w1, b1, w2, b2, eps):
    """Forward launches; returns (branch, saved intermediates)."""
    from tokenreduction_tpu_torch.ops import _build

    B, N, D = x.shape
    M, H4 = B * N, w1.shape[0]
    rows = x.view(M, D)
    ln = torch.empty_like(rows)
    _build.layer_norm(rows, ls, lb, ln, eps=eps)
    a = torch.empty(M, H4, dtype=x.dtype, device=x.device)
    gp = torch.empty(M, H4, dtype=torch.float32, device=x.device)
    _build.gemm(ln, w1, b1, a, gelu=_build.Gelu.ERF, gelu_grad=gp)
    out = torch.empty_like(x)
    _build.gemm(a, w2, b2, out.view(M, D))
    return out, (ln, a, gp)


def _bwd_cuda(x, ls, w1, w2, saved, g, eps):
    """Backward launches; returns the seven gradients."""
    from tokenreduction_tpu_torch.ops import _build

    ln, a, gp = saved
    B, N, D = x.shape
    M, H4 = B * N, w1.shape[0]
    g = g.view(M, D)
    dh = torch.empty(M, H4, dtype=x.dtype, device=x.device)
    db1_parts = torch.empty(-(-M // _build.GEMM_TILE), H4,
                            dtype=torch.float32, device=x.device)
    _build.gemm(g, w2, None, dh, w_kn=True, mul=gp, col_sums=db1_parts)
    db1 = torch.empty(H4, dtype=w1.dtype, device=x.device)
    sums = [(db1_parts, db1)]  # the fixed-order partial sums, one launch
    dw2, db2 = torch.empty_like(w2), torch.empty(D, dtype=w2.dtype,
                                                 device=x.device)
    sums += _build.gemm_wgrad(g, a, dw2, db2)
    dw1 = torch.empty_like(w1)
    sums += _build.gemm_wgrad(dh, ln, dw1)
    dln = torch.empty(M, D, dtype=torch.float32, device=x.device)
    _build.gemm(dh, w1, None, dln, w_kn=True)
    dx = torch.empty_like(x)
    dlnp = torch.empty(2, D, dtype=ls.dtype, device=x.device)
    sums += _build.layer_norm_bwd(x.view(M, D), ls, dln, dx.view(M, D), dlnp,
                                  eps=eps)
    _build.sum_partials_many(sums)
    return dx, dlnp[0], dlnp[1], dw1, db1, dw2, db2


class _MlpBranch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ls, lb, w1, b1, w2, b2, eps):
        ctx.eps = eps
        if x.is_cuda:
            out, saved = _fwd_cuda(x, ls, lb, w1, b1, w2, b2, eps)
            mlp_branch.launches += 1
        else:
            out, saved = mlp_branch_ref(x, ls, lb, w1, b1, w2, b2, eps), ()
        ctx.save_for_backward(x, ls, lb, w1, b1, w2, *saved)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ls, lb, w1, b1, w2, *saved = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        if x.is_cuda:
            grads = _bwd_cuda(x, ls, w1, w2, saved, g, ctx.eps)
            mlp_branch.launches += 1
            mlp_branch.backward_launches += 1
        else:
            grads = mlp_branch_bwd_ref(x, ls, lb, w1, b1, w2, g, ctx.eps)
        return (*grads, None)


def mlp_branch(x, ls, lb, w1, b1, w2, b2, eps: float = 1e-6):
    """x [B, N, D] -> fc2(gelu(fc1(LN x))) [B, N, D], differentiable in x
    and every parameter. Weights in nn.Linear's [out, in] layout: w1
    [4D, D], w2 [D, 4D]. ``launches`` counts the CUDA forwards and
    backwards, ``backward_launches`` the backwards alone."""
    if x.is_cuda:
        check_mlp_operands("mlp_branch", x, ls, lb, w1, b1, w2, b2)
    return _MlpBranch.apply(x, ls, lb, w1, b1, w2, b2, eps)


mlp_branch.launches = 0
mlp_branch.backward_launches = 0
