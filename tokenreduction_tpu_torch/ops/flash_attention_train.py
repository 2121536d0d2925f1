"""The training attention core, with a hand-written backward.

``attention_core_train`` is the counterpart of
``tokenreduction_tpu/ops/flash_attention_train.py:172
attention_core_train``:

    (out, row0, colsum) = softmax(q k^T * scale [+ bias] [pair mask]) v

over q, k, v [B, H, N, hd] with an optional per-key additive bias [B, N]
(ToMe's log size), an optional validity mask [B, N] (heuristic's static
masks: -FLT_MAX after the scale and the bias where the query or the key
token is invalid, the JAX pair mask, so a fully masked query row is
uniform over its N keys), the CLS query row ``row0`` and the column mass
``colsum`` of the probabilities as fp32 [B, H, N] by-products. It is a
``torch.autograd.Function`` differentiable in q, k, v and the bias (the
mask takes no gradient), and it takes the cotangents of all three
outputs. The training blocks reach it through ``core/layers.py::
Attention`` wherever the attention half has a bias or a mask (ToMe after
its first merge, heuristic from its first active block on); the qkv and
out projections around it stay ``nn.Linear``, as the JAX package leaves
them to XLA.

Numerics (the TPU kernels' rounding points): the forward is
``fused_attention``'s eval recipe (the unnormalised exponentials rounded
before the value product, 1/sum after it). The backward takes the
normalised probabilities P (exact row max) and rounds P before
dV = P^T dO; dP = dO V^T plus the row0 cotangent on query row 0 and the
colsum cotangent on every query row; dS = P (dP - delta) in fp32 with
delta_i = sum_j P_ij dP_ij, whose column sums over the queries are the
per-head bias gradient (summed over the heads outside the kernel, as on
the TPU); with the mask the logits are capped as in the forward and dS is
zero at every masked pair (JAX ``flash_attention_train.py:80-84``: a
fully masked row's P is uniform, so dP - delta does not vanish by itself),
while dV = P^T dO keeps that uniform P; dS rounded, then
dq = round(dS) K scale and dk = round(dS)^T Q scale, rounded. The kernels
round dS after the scale: at head dim 64 the scale is 2^-3, a power of
two, so both orders give the same numbers.

Where it splits, and why: the TPU runs forward and backward as one Pallas
kernel each over groups of (image, head) slices in VMEM. On the card each
is one launch of a hand-written kernel, one block per (image, head) with
that head's operands in shared memory, read through their strides so the
views of the packed projection need no copy: ``short_attention`` forward,
``short_attention_bwd`` backward with the bias, the mask, both cotangents
and dbias. In bf16 they are ``csrc/attention_sm90.cu``'s (TMA, wgmma):
the forward also writes the row statistics (row max, 1/sum), which the
backward reads with the forward's output and row0, so P is computed once
per pair and delta takes the form rowsum(dO O) + [i = 0] row0 . drow0 +
P dcs; in fp32, the parity dtype, ``csrc/short_attention.cu``'s, which
recompute P and delta in full. The output is a view of merged heads, so
merging them afterwards copies nothing.

What bounds it: not the loads. The bf16 forward is held by its
elementwise softmax (row max, exponentials, sums and by-products) at two
warpgroups an SM; the backward, one block an SM, runs its loads, its
products and its elementwise work one after another (PERF.md §6).

On a CPU tensor the core runs ``fused_attention_ref`` forward and
``attention_core_train_bwd_ref`` backward; on a CUDA tensor it launches
the kernels or raises.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.ops.flash_attention import (
    MASK_VALUE,
    bias_operand,
    fused_attention_cuda,
    fused_attention_ref,
    mask_operand,
)


def attention_core_train_bwd_ref(q, k, v, bias, dout, drow0, dcs,
                                 scale: float, mask=None):
    """Plain hand-written backward of ``attention_core_train``: the TPU
    kernel's ``_bwd_kernel`` (flash_attention_train.py:38-99) with its
    rounding points. dout [B, H, N, hd]; bias [B, N], drow0 and dcs
    [B, H, N], and the validity mask [B, N] (bool) or None. Returns (dq,
    dk, dv in q's dtype, the per-head bias gradient [B, H, N] fp32)."""
    dt = q.dtype
    q32, k32, v32 = q.float(), k.float(), v.float()
    s = (q32 @ k32.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    if mask is not None:
        pair = mask.bool()[:, None, :, None] & mask.bool()[:, None, None, :]
        s = s.masked_fill(~pair, MASK_VALUE)
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
    if mask is not None:  # zero at every masked pair (a uniform row too)
        dsu = dsu.masked_fill(~pair, 0.0)
    ds = dsu.to(dt).float()
    return (((ds @ k32) * scale).to(dt),
            ((ds.transpose(-1, -2) @ q32) * scale).to(dt), dv, dsu.sum(2))


def _bwd_cuda(q, k, v, bias, mask, out, row0, stats, dout, drow0, dcs, scale,
              want_dbias):
    """Backward launch (out, row0, stats: the forward's, read by the bf16
    kernel); returns (dq, dk, dv, per-head dbias or None)."""
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
        q, k, v, out, dout, dq, dk, dv, scale, stats=stats, row0=row0,
        bias=bias_operand(name, bias, B, N, q.device), mask=mask,
        drow0=row(drow0), dcs=row(dcs), dbias=dbias)
    return dq, dk, dv, dbias


class _AttentionCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        ctx.scale = scale
        ctx.set_materialize_grads(False)  # an unused output's cotangent is 0
        if q.is_cuda:
            B, _, N, _ = q.shape
            mask = mask_operand("attention_core_train", mask, B, N, q.device)
            *res, stats = fused_attention_cuda(
                "attention_core_train", q, k, v, scale, bias, mask,
                want_stats=q.dtype == torch.bfloat16)
            attention_core_train.launches += 1
            # the bf16 backward reads the output, row0 and the row statistics
            ctx.save_for_backward(q, k, v, bias, mask, res[0], res[1], stats)
        else:
            res = fused_attention_ref(q, k, v, scale, bias=bias, mask=mask)
            ctx.save_for_backward(q, k, v, bias, mask, None, None, None)
        return tuple(res)

    @staticmethod
    def backward(ctx, dout, drow0, dcs):
        q, k, v, bias, mask, out, row0, stats = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(q)
        dout = dout.to(q.dtype)
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        if q.is_cuda:
            dq, dk, dv, dbias = _bwd_cuda(q, k, v, bias, mask, out, row0,
                                          stats, dout, drow0, dcs, ctx.scale,
                                          want_dbias)
            attention_core_train.launches += 1
            attention_core_train.backward_launches += 1
        else:
            dq, dk, dv, dbias = attention_core_train_bwd_ref(
                q, k, v, bias, dout, drow0, dcs, ctx.scale, mask)
        if want_dbias:
            # the bias is shared by the heads: sum their gradients
            dbias = dbias.sum(1).to(bias.dtype)
        return dq, dk, dv, dbias if want_dbias else None, None, None


def attention_core_train(q, k, v, scale: float, bias=None, mask=None):
    """q, k, v [B, H, N, hd] (head dim contiguous) -> (out [B, H, N, hd],
    row0 [B, H, N] fp32, colsum [B, H, N] fp32), differentiable in q, k,
    v, the per-key bias [B, N] (or None) and all three outputs; mask:
    None or the validity mask [B, N] (bool or uint8; no gradient).
    ``launches`` counts the CUDA forwards and backwards,
    ``backward_launches`` the backwards alone."""
    return _AttentionCore.apply(q, k, v, bias, mask, scale)


attention_core_train.launches = 0
attention_core_train.backward_launches = 0
