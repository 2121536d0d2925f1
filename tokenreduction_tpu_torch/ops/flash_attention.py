"""The attention half of a transformer block, with score by-products, and
the attention core it is made of.

``fused_block_attention`` is the counterpart of
``tokenreduction_tpu/ops/flash_attention.py:660 fused_block_attention``:

    out = x + proj(attn(qkv(LN1 x)))

with the CLS query row ``row0 [B, H, N]`` and the column mass
``colsum [B, H, N]`` of the probabilities as fp32 by-products (the top-k
score is ``row0[:, :, 1:].mean(1)``); optionally with a per-key additive
bias ``[B, N]`` on the logits (ToMe's log size) and, with ``want_keys``,
the head-mean keys ``[B, N, hd]`` (ToMe's merge metric) as a fourth
output: the fp32 sum of the rounded keys over the heads in head order,
divided by H and rounded. LayerNorm, softmax and accumulation are fp32;
the LN output, qkv, the probabilities fed to the value product and the
merged heads are rounded to the input dtype, as on the TPU.

``fused_attention`` is the counterpart of
``tokenreduction_tpu/ops/flash_attention.py:183 fused_attention``: the
same softmax attention, bias and by-products over q, k, v
``[B, H, N, hd]``, the eval recipe (the unnormalised exponentials rounded
before the value product, 1/sum applied after it). It is also the forward
of the training core (``ops/flash_attention_train.py``).

Where it splits, and why: the TPU kernel keeps the whole block's weights
and activations in 128 MB of VMEM. A Hopper SM has 227 KB of shared
memory, so on the card the block is four or five launches of the
hand-written kernels (``csrc/``):

1. ``layer_norm``, then ``gemm`` (``csrc/ln_gemm.cu``): LN1 rows once,
   then the qkv product [B*N, 3D] with its bias;
2. ``short_attention``: one block per (image, head) with that head's q,
   k and v in shared memory (read through strides, so the packed qkv and
   the [B, H, N, hd] layouts are one kernel), the bias added after the
   scale, writing merged heads and the by-products;
3. with ``want_keys``, ``head_mean_keys`` off the packed qkv;
4. ``gemm``: the out projection, with its bias and the residual fused
   into the epilogue.

What bounds it: at N <= 197 and D = 384 the products are small. The
attention is bound by reading qkv and by its exponentials, not by
tensor-core operations; the GEMMs at K = 384 lose a large share to each
output tile's fill and epilogue (the LN output and qkv each make one
round trip through device memory). This is a simple first version on
mma.sync; wgmma, TMA, persistent tiles and keeping qkv on chip are later
work.

The validity mask (heuristic) and the idx row-select prologue (DyViT)
raise ``NotImplementedError`` until their methods are ported.

On a CPU tensor each wrapper runs its plain PyTorch version
(``fused_block_attention_ref``, ``fused_attention_ref``); on a CUDA
tensor it launches the kernels or raises.
"""

from __future__ import annotations

import torch

# The short-attention kernel holds one head's q, k and v in shared memory
# (and its fp32 form gives each lane N / 32 keys): N <= 256 at head dim 64.
SHORT_ATTENTION_MAX_N = 256
HEAD_DIM = 64


def layer_norm_stats(x32, eps: float):
    """(x_hat, 1/sigma) of fp32 rows, two-pass (the kernels' recipe)."""
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return xc * rstd, rstd


def layer_norm_f32(x32, weight, bias, eps: float):
    """Two-pass fp32 LayerNorm over the last dim (the kernels' recipe)."""
    return layer_norm_stats(x32, eps)[0] * weight.float() + bias.float()


def layer_norm_bwd_ref(dln, x_hat, rstd, weight):
    """(dx, d weight, d bias) of an fp32 LayerNorm over rows [M, K], from
    the fp32 output gradient dln and the forward's x_hat and 1/sigma."""
    dxhat = dln * weight.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * x_hat).mean(-1, keepdim=True)
    return (rstd * (dxhat - m1 - x_hat * m2), (dln * x_hat).sum(0),
            dln.sum(0))


def linear_f32(x, weight, bias):
    """x @ weight.T + bias, operands as given, product in fp32."""
    return x.float() @ weight.float().T + bias.float()


def packed_heads(qkv, num_heads: int):
    """q, k, v [B, H, N, hd] views of a packed qkv [B, N, 3D] in timm's
    (3, H, hd) column order."""
    B, N, D3 = qkv.shape
    return qkv.view(B, N, 3, num_heads, D3 // 3 // num_heads) \
        .permute(2, 0, 3, 1, 4).unbind(0)


def merged_heads(x, num_heads: int):
    """The [B, H, N, hd] view of merged heads x [B, N, D]."""
    B, N, D = x.shape
    return x.view(B, N, num_heads, D // num_heads).transpose(1, 2)


def fused_attention_ref(q, k, v, scale: float, *, bias=None):
    """Plain softmax attention over q, k, v [B, H, N, hd] with an optional
    per-key bias [B, N]. Returns (out [B, H, N, hd] in q's dtype, row0
    [B, H, N] fp32, colsum [B, H, N] fp32)."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()[:, None, None, :]
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    rinv = 1.0 / e.sum(-1, keepdim=True)
    out = ((e.to(q.dtype).float() @ v.float()) * rinv).to(q.dtype)
    probs = e * rinv
    return out, probs[:, :, 0, :], probs.sum(2)


def attention_ref(qkv, num_heads: int, scale: float, bias=None):
    """``fused_attention_ref`` off a packed qkv [B, N, 3D]: (merged heads
    [B, N, D] in qkv's dtype, row0, colsum)."""
    B, N, D3 = qkv.shape
    out, row0, colsum = fused_attention_ref(*packed_heads(qkv, num_heads),
                                            scale, bias=bias)
    return out.transpose(1, 2).reshape(B, N, D3 // 3), row0, colsum


def head_mean_keys_ref(qkv, num_heads: int):
    """The head-mean keys [B, N, hd] of a packed qkv [B, N, 3D]: summed in
    fp32 in head order, divided by H, rounded to qkv's dtype."""
    k = packed_heads(qkv, num_heads)[1].float()
    acc = k[:, 0]
    for h in range(1, num_heads):
        acc = acc + k[:, h]
    return (acc / num_heads).to(qkv.dtype)


def attention_residual_ref(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                           num_heads: int, scale: float, eps: float,
                           bias=None):
    """x + proj(attn(qkv(LN1 x))) in fp32, before its final rounding,
    with row0, colsum and the rounded qkv."""
    x32 = x.float()
    ln = layer_norm_f32(x32, ln_scale, ln_bias, eps).to(x.dtype)
    qkv = linear_f32(ln, wqkv, bqkv).to(x.dtype)
    merged, row0, colsum = attention_ref(qkv, num_heads, scale, bias)
    return x32 + linear_f32(merged, wproj, bproj), row0, colsum, qkv


def fused_block_attention_ref(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                              bproj, num_heads: int, scale: float, *,
                              eps: float = 1e-6, bias=None,
                              want_keys: bool = False):
    """Plain PyTorch version of ``fused_block_attention``, same contract."""
    y32, row0, colsum, qkv = attention_residual_ref(
        x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, scale, eps,
        bias)
    out = (y32.to(x.dtype), row0, colsum)
    return out + (head_mean_keys_ref(qkv, num_heads),) if want_keys else out


def _check_width(name: str, N: int, hd: int):
    if hd != HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head dim {HEAD_DIM}, got "
                         f"{hd}")
    if not 1 <= N <= SHORT_ATTENTION_MAX_N:
        raise ValueError(f"{name}: N={N} is outside the kernel's 1.."
                         f"{SHORT_ATTENTION_MAX_N} tokens")


def bias_operand(name: str, bias, B: int, N: int, device):
    """The per-key bias [B, N] as the kernels take it: contiguous fp32 on
    the operands' device (None stays None)."""
    if bias is None:
        return None
    if tuple(bias.shape) != (B, N):
        raise ValueError(f"{name}: bias must be [B={B}, N={N}], got "
                         f"{tuple(bias.shape)}")
    if bias.device != device:
        raise ValueError(f"{name}: bias on {bias.device}, operands on "
                         f"{device}")
    return bias.float().contiguous()


def check_attention_operands(name: str, x, num_heads: int, ln_scale, ln_bias,
                             wqkv, bqkv, wproj, bproj):
    """Raise on anything the attention half's kernels do not take."""
    from tokenreduction_tpu_torch.ops import _build

    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, N, D], got {tuple(x.shape)}")
    _, N, D = x.shape
    if D % num_heads:
        raise ValueError(f"{name}: D={D} is not a multiple of {num_heads} "
                         "heads")
    _check_width(name, N, D // num_heads)
    _build.check_shapes(name, (ln_scale, (D,)), (ln_bias, (D,)),
                        (wqkv, (3 * D, D)), (bqkv, (3 * D,)),
                        (wproj, (D, D)), (bproj, (D,)))
    _build.check_operands(name, x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                          bproj)


def attention_half_cuda(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                        num_heads: int, scale: float, eps: float,
                        with_scores: bool, out_dtype=None, bias=None,
                        want_keys: bool = False):
    """Steps 1-4 of the module docstring on checked CUDA operands (bias:
    None or contiguous fp32 [B, N]). Returns (out, row0, colsum, keys):
    out in ``out_dtype`` (x's by default); the by-products are None
    without ``with_scores``, the keys without ``want_keys``."""
    from tokenreduction_tpu_torch.ops import _build

    B, N, D = x.shape
    rows = x.view(B * N, D)
    ln = torch.empty_like(rows)
    _build.layer_norm(rows, ln_scale, ln_bias, ln, eps=eps)
    qkv = torch.empty(B, N, 3 * D, dtype=x.dtype, device=x.device)
    _build.gemm(ln, wqkv, bqkv, qkv.view(B * N, 3 * D))
    merged = torch.empty_like(x)
    row0 = colsum = keys = None
    if with_scores:
        row0 = torch.empty(B, num_heads, N, dtype=torch.float32,
                           device=x.device)
        colsum = torch.empty_like(row0)
    _build.short_attention(qkv, merged, num_heads, scale, bias=bias,
                           row0=row0, colsum=colsum)
    if want_keys:
        keys = torch.empty(B, N, D // num_heads, dtype=x.dtype,
                           device=x.device)
        _build.head_mean_keys(qkv, keys, num_heads)
    out = torch.empty_like(x, dtype=out_dtype)
    _build.gemm(merged.view(B * N, D), wproj, bproj, out.view(B * N, D),
                res=rows)
    return out, row0, colsum, keys


def refuse_mask(name: str, mask):
    if mask is not None:
        raise NotImplementedError(
            f"{name}: the key-validity mask comes with the heuristic method "
            "and is not ported yet (ROADMAP Queue 2 item 5)")


def fused_block_attention(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                          num_heads: int, scale: float, *, eps: float = 1e-6,
                          bias=None, mask=None, idx=None,
                          want_keys: bool = False):
    """x [B, N, D] -> (x + proj(attn(LN1 x)), row0 [B, H, N],
    colsum [B, H, N]), plus the head-mean keys [B, N, hd] with
    ``want_keys``; bias: None or the per-key additive bias [B, N]. Weights
    in nn.Linear's [out, in] layout: wqkv [3D, D], wproj [D, D]."""
    name = "fused_block_attention"
    refuse_mask(name, mask)
    if idx is not None:
        raise NotImplementedError(
            f"{name}: the idx row-select prologue comes with DyViT and is not "
            "ported yet (ROADMAP Queue 2 item 5)")
    if not x.is_cuda:
        return fused_block_attention_ref(
            x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, scale,
            eps=eps, bias=bias, want_keys=want_keys)
    check_attention_operands(name, x, num_heads, ln_scale, ln_bias, wqkv,
                             bqkv, wproj, bproj)
    bias = bias_operand(name, bias, x.shape[0], x.shape[1], x.device)
    out, row0, colsum, keys = attention_half_cuda(
        x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, scale, eps,
        with_scores=True, bias=bias, want_keys=want_keys)
    fused_block_attention.launches += 1
    return (out, row0, colsum, keys) if want_keys else (out, row0, colsum)


fused_block_attention.launches = 0


def fused_attention_cuda(name: str, q, k, v, scale: float, bias):
    """``short_attention`` over checked-here CUDA q, k, v [B, H, N, hd]:
    (out, row0, colsum), out a [B, H, N, hd] view of merged heads
    [B, N, D], so that merging the heads afterwards copies nothing."""
    from tokenreduction_tpu_torch.ops import _build

    B, H, N, hd = q.shape
    _check_width(name, N, hd)
    _build.check_heads(name, q, k, v)
    bias = bias_operand(name, bias, B, N, q.device)
    out = torch.empty(B, N, H, hd, dtype=q.dtype, device=q.device) \
        .transpose(1, 2)
    row0 = torch.empty(B, H, N, dtype=torch.float32, device=q.device)
    colsum = torch.empty_like(row0)
    _build.short_attention_heads(q, k, v, out, scale, bias=bias, row0=row0,
                                 colsum=colsum)
    return out, row0, colsum


def fused_attention(q, k, v, scale: float, *, bias=None, mask=None):
    """q, k, v [B, H, N, hd] (head dim contiguous) -> (out [B, H, N, hd],
    row0 [B, H, N] fp32, colsum [B, H, N] fp32); bias: None or the per-key
    additive bias [B, N]."""
    refuse_mask("fused_attention", mask)
    if not q.is_cuda:
        return fused_attention_ref(q, k, v, scale, bias=bias)
    res = fused_attention_cuda("fused_attention", q, k, v, scale, bias)
    fused_attention.launches += 1
    return res


fused_attention.launches = 0
