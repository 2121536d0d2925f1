"""The training attention core, with a hand-written backward.

``attention_core_train`` is the counterpart of
``tokenreduction_tpu/ops/flash_attention_train.py:172
attention_core_train``:

    (out, row0, colsum) = softmax(q k^T * scale [+ bias]) v

over q, k, v [B, H, N, hd] with an optional per-key additive bias [B, N]
(ToMe's log size), the CLS query row ``row0`` and the column mass
``colsum`` of the probabilities as fp32 [B, H, N] by-products. It is a
``torch.autograd.Function`` differentiable in q, k, v and the bias, and
it takes the cotangents of all three outputs. The training blocks reach
it through ``core/layers.py::Attention`` wherever the attention half has
a bias (ToMe after its first merge); the qkv and out projections around
it stay ``nn.Linear``, as the JAX package leaves them to XLA.

Numerics (the TPU kernels' rounding points): the forward is
``fused_attention``'s eval recipe (the unnormalised exponentials rounded
before the value product, 1/sum after it). The backward recomputes the
normalised probabilities P with the exact row max and rounds P before
dV = P^T dO; dP = dO V^T plus the row0 cotangent on query row 0 and the
colsum cotangent on every query row; dS = P (dP - rowsum(dP P)) in fp32,
whose column sums over the queries are the per-head bias gradient (summed
over the heads outside the kernel, as on the TPU); dS rounded, then
dq = round(dS) K scale and dk = round(dS)^T Q scale, rounded. The kernel
rounds dS after the scale: at head dim 64 the scale is 2^-3, a power of
two, so both orders give the same numbers.

Where it splits, and why: the TPU runs forward and backward as one Pallas
kernel each over groups of (image, head) slices in VMEM. On the card each
is one launch of the hand-written kernels in ``csrc/short_attention.cu``
(one block per (image, head), that head's q, k, v and dO in shared
memory, read through their strides so the views of the packed projection
need no copy): ``short_attention`` forward, ``short_attention_bwd``
backward with the bias, both cotangents and dbias. The output is a view
of merged heads, so merging them afterwards copies nothing.

What bounds it: at N <= 197 the forward is bound by reading q, k, v and
by its exponentials, the backward by recomputing QK^T (four passes per
query tile, one per key tile) on mma.sync; a first version.

On a CPU tensor the core runs ``fused_attention_ref`` forward and
``attention_core_train_bwd_ref`` backward; on a CUDA tensor it launches
the kernels or raises. The key-validity mask (heuristic) raises
``NotImplementedError`` until its method is ported.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.ops.flash_attention import (
    bias_operand,
    fused_attention_cuda,
    fused_attention_ref,
    refuse_mask,
)


def attention_core_train_bwd_ref(q, k, v, bias, dout, drow0, dcs,
                                 scale: float):
    """Plain hand-written backward of ``attention_core_train``: the TPU
    kernel's ``_bwd_kernel`` (flash_attention_train.py:38-99) with its
    rounding points. dout [B, H, N, hd]; bias [B, N], drow0 and dcs
    [B, H, N] or None. Returns (dq, dk, dv in q's dtype, the per-head
    bias gradient [B, H, N] fp32)."""
    dt = q.dtype
    q32, k32, v32 = q.float(), k.float(), v.float()
    s = (q32 @ k32.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e * (1.0 / e.sum(-1, keepdim=True))
    do = dout.to(dt).float()
    dv = (p.to(dt).float().transpose(-1, -2) @ do).to(dt)
    dp = do @ v32.transpose(-1, -2)
    if drow0 is not None:
        dp[:, :, 0, :] += drow0.float()  # the row0 cotangent enters at row 0
    if dcs is not None:
        dp = dp + dcs.float()[:, :, None, :]  # the colsum one on every row
    dsu = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = dsu.to(dt).float()
    return (((ds @ k32) * scale).to(dt),
            ((ds.transpose(-1, -2) @ q32) * scale).to(dt), dv, dsu.sum(2))


def _bwd_cuda(q, k, v, bias, dout, drow0, dcs, scale, want_dbias):
    """Backward launch; returns (dq, dk, dv, per-head dbias or None)."""
    from tokenreduction_tpu_torch.ops import _build

    name = "attention_core_train"
    B, H, N, hd = q.shape
    if not _build.heads_loadable(dout):  # e.g. the expanded ones of a sum
        dout = dout.contiguous()
    _build.check_heads(name, q, k, v, dout)

    def row(t):  # a [B, H, N] cotangent as the kernel takes it
        if t is None:
            return None
        _build.check_shapes(name, (t, (B, H, N)))
        return t.float().contiguous()

    dq, dk, dv = torch.empty(3, B, H, N, hd, dtype=q.dtype,
                             device=q.device).unbind(0)
    dbias = torch.empty(B, H, N, dtype=torch.float32,
                        device=q.device) if want_dbias else None
    _build.short_attention_bwd_heads(
        q, k, v, dout, dq, dk, dv, scale,
        bias=bias_operand(name, bias, B, N, q.device), drow0=row(drow0),
        dcs=row(dcs), dbias=dbias)
    return dq, dk, dv, dbias


class _AttentionCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.scale = scale
        ctx.set_materialize_grads(False)  # an unused output's cotangent is 0
        if q.is_cuda:
            res = fused_attention_cuda("attention_core_train", q, k, v, scale,
                                       bias)
            attention_core_train.launches += 1
        else:
            res = fused_attention_ref(q, k, v, scale, bias=bias)
        ctx.save_for_backward(q, k, v, bias)
        return res

    @staticmethod
    def backward(ctx, dout, drow0, dcs):
        q, k, v, bias = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(q)
        dout = dout.to(q.dtype)
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        if q.is_cuda:
            dq, dk, dv, dbias = _bwd_cuda(q, k, v, bias, dout, drow0, dcs,
                                          ctx.scale, want_dbias)
            attention_core_train.launches += 1
            attention_core_train.backward_launches += 1
        else:
            dq, dk, dv, dbias = attention_core_train_bwd_ref(
                q, k, v, bias, dout, drow0, dcs, ctx.scale)
        if want_dbias:
            # the bias is shared by the heads: sum their gradients
            dbias = dbias.sum(1).to(bias.dtype)
        return dq, dk, dv, dbias if want_dbias else None, None


def attention_core_train(q, k, v, scale: float, bias=None, mask=None):
    """q, k, v [B, H, N, hd] (head dim contiguous) -> (out [B, H, N, hd],
    row0 [B, H, N] fp32, colsum [B, H, N] fp32), differentiable in q, k,
    v, the per-key bias [B, N] (or None) and all three outputs.
    ``launches`` counts the CUDA forwards and backwards,
    ``backward_launches`` the backwards alone."""
    refuse_mask("attention_core_train", mask)
    return _AttentionCore.apply(q, k, v, bias, scale)


attention_core_train.launches = 0
attention_core_train.backward_launches = 0
