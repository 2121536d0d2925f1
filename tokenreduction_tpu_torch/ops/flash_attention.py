"""The attention half of a transformer block, with score by-products.

``fused_block_attention`` is the counterpart of
``tokenreduction_tpu/ops/flash_attention.py:660 fused_block_attention``:

    out = x + proj(attn(qkv(LN1 x)))

with the CLS query row ``row0 [B, H, N]`` and the column mass
``colsum [B, H, N]`` of the probabilities as fp32 by-products (the top-k
score is ``row0[:, :, 1:].mean(1)``). LayerNorm, softmax and accumulation
are fp32; the LN output, qkv, the probabilities fed to the value product
and the merged heads are rounded to the input dtype, as on the TPU.

Where it splits, and why: the TPU kernel keeps the whole block's weights
and activations in 128 MB of VMEM. A Hopper SM has 227 KB of shared
memory, so on the card the counterpart is four launches of three
hand-written kernels (``csrc/``):

1. ``layer_norm``, then ``gemm`` (``csrc/ln_gemm.cu``): LN1 rows once,
   then the qkv product [B*N, 3D] with its bias;
2. ``short_attention``: one block per (image, head) with that head's q,
   k and v in shared memory, writing merged heads and the by-products;
3. ``gemm``: the out projection, with its bias and the residual fused
   into the epilogue.

What bounds it: at N <= 197 and D = 384 the products are small. The
attention is bound by reading qkv and by its exponentials, not by
tensor-core operations; the GEMMs at K = 384 lose a large share to each
output tile's fill and epilogue (the LN output and qkv each make one
round trip through device memory). This is a simple first version on
mma.sync; wgmma, TMA, persistent tiles and keeping qkv on chip are later
work.

Only the plain variant is ported. The per-key bias (ToMe), the validity
mask (heuristic), the idx row-select prologue (DyViT) and ``want_keys``
(ToMe) raise ``NotImplementedError``.

On a CPU tensor the wrapper runs ``fused_block_attention_ref``, the plain
PyTorch version; on a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import torch

# The short-attention kernel holds one head's q, k and v in shared memory
# (and its fp32 form gives each lane N / 32 keys): N <= 256 at head dim 64.
SHORT_ATTENTION_MAX_N = 256
HEAD_DIM = 64


def layer_norm_f32(x32, weight, bias, eps: float):
    """Two-pass fp32 LayerNorm over the last dim (the kernels' recipe)."""
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * weight.float() + bias.float()


def linear_f32(x, weight, bias):
    """x @ weight.T + bias, operands as given, product in fp32."""
    return x.float() @ weight.float().T + bias.float()


def attention_ref(qkv, num_heads: int, scale: float):
    """Plain softmax attention off a packed qkv [B, N, 3D] in timm's
    (3, H, hd) column order. Returns (merged heads [B, N, D] in qkv's
    dtype, row0 [B, H, N] fp32, colsum [B, H, N] fp32)."""
    B, N, D3 = qkv.shape
    D = D3 // 3
    q, k, v = qkv.float().reshape(B, N, 3, num_heads, D // num_heads) \
        .permute(2, 0, 3, 1, 4)
    logits = (q @ k.transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    rinv = 1.0 / e.sum(-1, keepdim=True)
    out = (e.to(qkv.dtype).float() @ v) * rinv
    probs = e * rinv
    merged = out.transpose(1, 2).reshape(B, N, D).to(qkv.dtype)
    return merged, probs[:, :, 0, :], probs.sum(2)


def attention_residual_ref(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                           num_heads: int, scale: float, eps: float):
    """x + proj(attn(qkv(LN1 x))) in fp32, before its final rounding,
    with row0 and colsum."""
    x32 = x.float()
    ln = layer_norm_f32(x32, ln_scale, ln_bias, eps).to(x.dtype)
    qkv = linear_f32(ln, wqkv, bqkv).to(x.dtype)
    merged, row0, colsum = attention_ref(qkv, num_heads, scale)
    return x32 + linear_f32(merged, wproj, bproj), row0, colsum


def fused_block_attention_ref(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                              bproj, num_heads: int, scale: float, *,
                              eps: float = 1e-6):
    """Plain PyTorch version of ``fused_block_attention``, same contract."""
    y32, row0, colsum = attention_residual_ref(
        x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, scale, eps)
    return y32.to(x.dtype), row0, colsum


def check_attention_operands(name: str, x, num_heads: int, ln_scale, ln_bias,
                             wqkv, bqkv, wproj, bproj):
    """Raise on anything the attention half's kernels do not take."""
    from tokenreduction_tpu_torch.ops import _build

    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, N, D], got {tuple(x.shape)}")
    _, N, D = x.shape
    if D != num_heads * HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head dim {HEAD_DIM}, got "
                         f"D={D} over {num_heads} heads")
    if not 1 <= N <= SHORT_ATTENTION_MAX_N:
        raise ValueError(f"{name}: N={N} is outside the kernel's 1.."
                         f"{SHORT_ATTENTION_MAX_N} tokens")
    _build.check_shapes(name, (ln_scale, (D,)), (ln_bias, (D,)),
                        (wqkv, (3 * D, D)), (bqkv, (3 * D,)),
                        (wproj, (D, D)), (bproj, (D,)))
    _build.check_operands(name, x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                          bproj)


def attention_half_cuda(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                        num_heads: int, scale: float, eps: float,
                        with_scores: bool, out_dtype=None):
    """Steps 1-3 of the module docstring on checked CUDA operands.
    Returns (out, row0, colsum): out in ``out_dtype`` (x's by default);
    the by-products are None without ``with_scores``."""
    from tokenreduction_tpu_torch.ops import _build

    B, N, D = x.shape
    rows = x.view(B * N, D)
    ln = torch.empty_like(rows)
    _build.layer_norm(rows, ln_scale, ln_bias, ln, eps=eps)
    qkv = torch.empty(B, N, 3 * D, dtype=x.dtype, device=x.device)
    _build.gemm(ln, wqkv, bqkv, qkv.view(B * N, 3 * D))
    merged = torch.empty_like(x)
    row0 = colsum = None
    if with_scores:
        row0 = torch.empty(B, num_heads, N, dtype=torch.float32,
                           device=x.device)
        colsum = torch.empty_like(row0)
    _build.short_attention(qkv, merged, num_heads, scale, row0=row0,
                           colsum=colsum)
    out = torch.empty_like(x, dtype=out_dtype)
    _build.gemm(merged.view(B * N, D), wproj, bproj, out.view(B * N, D),
                res=rows)
    return out, row0, colsum


def fused_block_attention(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                          num_heads: int, scale: float, *, eps: float = 1e-6,
                          bias=None, mask=None, idx=None,
                          want_keys: bool = False):
    """x [B, N, D] -> (x + proj(attn(LN1 x)), row0 [B, H, N],
    colsum [B, H, N]). Weights in nn.Linear's [out, in] layout: wqkv
    [3D, D], wproj [D, D]."""
    if bias is not None or mask is not None or idx is not None or want_keys:
        raise NotImplementedError(
            "fused_block_attention: the bias, mask, idx and want_keys "
            "extensions are not ported yet (ROADMAP Queue 2 item 5)")
    if not x.is_cuda:
        return fused_block_attention_ref(
            x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, scale,
            eps=eps)
    check_attention_operands("fused_block_attention", x, num_heads, ln_scale,
                             ln_bias, wqkv, bqkv, wproj, bproj)
    res = attention_half_cuda(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                              num_heads, scale, eps, with_scores=True)
    fused_block_attention.launches += 1
    return res


fused_block_attention.launches = 0
