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
divided by H and rounded. With ``idx [B, K]`` (absolute token ids, CLS
included; DyViT's kept tokens) the block first selects those rows and
runs at width K: the same as ``take_tokens(x, idx)`` then the block, with
outputs [B, K, D], [B, H, K] and keys [B, K, hd]; idx takes no bias and no
mask, as on the TPU. LayerNorm, softmax and accumulation are fp32;
the LN output, qkv, the probabilities fed to the value product and the
merged heads are rounded to the input dtype, as on the TPU.

``fused_attention`` is the counterpart of
``tokenreduction_tpu/ops/flash_attention.py:183 fused_attention``: the
same softmax attention, bias and by-products over q, k, v
``[B, H, N, hd]``, the eval recipe (the unnormalised exponentials rounded
before the value product, 1/sum applied after it). It is also the forward
of the training core (``ops/flash_attention_train.py``).
``fused_attention_qkv`` (``:313``) is the same attention straight off a
packed qkv ``[B, N, 3D]``, writing merged heads, with the normalised
probabilities rounded before the value product, as its TPU kernel does.

Each of them takes a validity mask ``[B, N]`` (ATS's pad slots): a logit
whose query or key token is invalid becomes -FLT_MAX after the scale and
the bias (the JAX pair mask, ``core/layers.py:70-73``), so a fully masked
query row is uniform over its N keys and adds to row0 and colsum like any
other row.

``fused_rect_attention`` (``:817``) and ``fused_rect_block`` (``:925``)
are ATS's sampling blocks: M kept query rows of a packed qkv attend over
all N keys under the same pair mask (a kept row's validity is the mask at
its token), and ``fused_rect_block`` adds the out projection and the
gathered residual ``take_tokens(x, idx)``.

Where it splits, and why: the TPU kernel keeps the whole block's weights
and activations in 128 MB of VMEM. A Hopper SM has 227 KB of shared
memory, so on the card the block is four or five launches of the
hand-written kernels (``csrc/``):

1. ``layer_norm``, then ``gemm`` (``csrc/ln_gemm.cu``): LN1 rows once,
   then the qkv product [B*N, 3D] with its bias;
2. ``short_attention``: one block per (image, head) with that head's q,
   k and v in shared memory (read through strides, so the packed qkv and
   the [B, H, N, hd] layouts are one kernel), the bias added after the
   scale and the mask after the bias, writing merged heads and the
   by-products; in bf16 ``csrc/attention_sm90.cu`` (TMA loads, QK^T and
   PV on wgmma). Above 256 tokens a head's keys no longer fit a block:
   ``csrc/attention_wide_sm90.cu`` (bf16) and
   ``csrc/attention_wide_tf32.cu`` (fp32) walk the query tiles and stream
   the keys in 64-key tiles, twice (the row statistics online, then P
   with the final row max), up to ``ATTENTION_MAX_N`` tokens;
3. with ``want_keys``, ``head_mean_keys`` off the packed qkv;
4. ``gemm``: the out projection, with its bias and the residual fused
   into the epilogue.

With idx, step 1's LayerNorm reads its rows through the ids and step 4's
epilogue adds the residual rows gathered through the same ids, so the
gathered tokens never make a round trip through device memory; steps 2
and 3 run at width K.

The rectangular block is steps 2 and 4 over the kept rows: the
rectangular ``short_attention`` variant (in bf16 the sm_90a forward of
``csrc/attention_sm90.cu``: a TMA box cannot gather rows, so its threads
copy the M query rows through their ids by cp.async into the same
swizzled tiles, while K and V come by TMA; no one-hot product: the card
gathers rows at no cost), and the out projection's epilogue adds the
residual rows gathered through the same ids, as the gathered MLP half
does.

What bounds it: at N <= 197 and D = 384 the products are small. The
attention is held by its elementwise softmax at two warpgroups an SM,
not by reading qkv nor by tensor-core operations (PERF.md §6); the GEMMs at K = 384 lose a large share to each
output tile's fill and epilogue (the LN output and qkv each make one
round trip through device memory). Keeping qkv on chip is the design
that ``tokenreduction_tpu_torch/tools/tune_kernels.py``'s ``attn_joint``
(csrc/attn_joint.cu) measures against this route: PERF.md §6, row #12.

On a CPU tensor each wrapper runs its plain PyTorch version (the same
name with ``_ref``); on a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.ops.gather import take_tokens

# The single-pass attention kernels (csrc/attention_sm90.cu, the fp32
# csrc/short_attention.cu and short_attention_bwd.cu) hold one head's q, k
# and v in shared memory and a whole row of S in registers: N <= 256 at head
# dim 64. Above that the wide kernels (csrc/attention_wide_sm90.cu, the fp32
# forward csrc/attention_wide_tf32.cu) stream the keys in 64-key tiles, up
# to ATTENTION_MAX_N tokens; there is no fp32 backward above 256.
SHORT_ATTENTION_MAX_N = 256
ATTENTION_MAX_N = 2048
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


# the JAX mask value, -finfo(float32).max
MASK_VALUE = -torch.finfo(torch.float32).max


def attention_probs_ref(q, k, v, scale: float, *, bias=None, q_valid=None,
                        k_valid=None, norm_p: bool = False):
    """Plain softmax attention of queries q [B, H, M, hd] over keys and
    values k, v [B, H, N, hd], with an optional per-key bias [B, N] and,
    with k_valid [B, N] and q_valid [B, M] (bool), the JAX pair mask:
    -FLT_MAX after the scale and the bias wherever the query or the key is
    invalid. Returns (out [B, H, M, hd] in q's dtype, the fp32
    probabilities [B, H, M, N]). The value product takes the unnormalised
    exponentials rounded to q's dtype and applies 1/sum after it (the eval
    recipe), or with ``norm_p`` the normalised probabilities rounded."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()[:, None, None, :]
    if k_valid is not None:
        pair = q_valid.bool()[:, None, :, None] & \
            k_valid.bool()[:, None, None, :]
        logits = logits.masked_fill(~pair, MASK_VALUE)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    rinv = 1.0 / e.sum(-1, keepdim=True)
    probs = e * rinv
    if norm_p:
        out = probs.to(q.dtype).float() @ v.float()
    else:
        out = (e.to(q.dtype).float() @ v.float()) * rinv
    return out.to(q.dtype), probs


def fused_attention_ref(q, k, v, scale: float, *, bias=None, mask=None,
                        norm_p: bool = False):
    """Plain softmax attention over q, k, v [B, H, N, hd] with an optional
    per-key bias [B, N] and validity mask [B, N]. Returns (out
    [B, H, N, hd] in q's dtype, row0 [B, H, N] fp32, colsum [B, H, N]
    fp32)."""
    out, probs = attention_probs_ref(q, k, v, scale, bias=bias, q_valid=mask,
                                     k_valid=mask, norm_p=norm_p)
    return out, probs[:, :, 0, :], probs.sum(2)


def attention_ref(qkv, num_heads: int, scale: float, bias=None, mask=None,
                  norm_p: bool = False):
    """``fused_attention_ref`` off a packed qkv [B, N, 3D]: (merged heads
    [B, N, D] in qkv's dtype, row0, colsum)."""
    B, N, D3 = qkv.shape
    out, row0, colsum = fused_attention_ref(*packed_heads(qkv, num_heads),
                                            scale, bias=bias, mask=mask,
                                            norm_p=norm_p)
    return out.transpose(1, 2).reshape(B, N, D3 // 3), row0, colsum


def fused_attention_qkv_ref(qkv, num_heads: int, scale: float, *, bias=None,
                            mask=None):
    """Plain PyTorch version of ``fused_attention_qkv``: the normalised
    probabilities rounded before the value product."""
    return attention_ref(qkv, num_heads, scale, bias, mask, norm_p=True)


def rect_attention_ref(qkv, idx, mask, num_heads: int, scale: float):
    """The merged heads [B, M, D] of the query rows idx [B, M] of a packed
    qkv [B, N, 3D] over all N keys, under the pair mask of mask [B, N]
    (a row's validity is the mask at its token)."""
    B, N, D3 = qkv.shape
    M = idx.shape[1]
    q, k, v = packed_heads(qkv, num_heads)
    ids = idx.long()
    q_kept = torch.gather(q, 2, ids[:, None, :, None].expand(
        B, num_heads, M, q.shape[-1]))
    out, _ = attention_probs_ref(q_kept, k, v, scale,
                                 q_valid=torch.gather(mask, 1, ids),
                                 k_valid=mask)
    return out.transpose(1, 2).reshape(B, M, D3 // 3)


def onehot_ids(onehot):
    """The row ids [B, M] of one-hot selectors [B, M, N]."""
    return onehot.argmax(-1)


def fused_rect_attention_ref(qkv, onehot, mask, num_heads: int,
                             scale: float):
    """Plain PyTorch version of ``fused_rect_attention``."""
    return rect_attention_ref(qkv, onehot_ids(onehot), mask.bool(), num_heads,
                              scale)


def fused_rect_block_ref(qkv, x, idx, mask, wproj, bproj, num_heads: int,
                         scale: float):
    """Plain PyTorch version of ``fused_rect_block``: take_tokens(x, idx) +
    proj(the rectangular attention), summed in fp32 and rounded once."""
    merged = rect_attention_ref(qkv, idx, mask.bool(), num_heads, scale)
    rows = torch.gather(x, 1, idx.long()[..., None].expand(-1, -1,
                                                          x.shape[-1]))
    return (rows.float() + linear_f32(merged, wproj, bproj)).to(x.dtype)


def head_mean_keys_ref(qkv, num_heads: int):
    """The head-mean keys [B, N, hd] of a packed qkv [B, N, 3D]: summed in
    fp32 in head order, divided by H, rounded to qkv's dtype."""
    k = packed_heads(qkv, num_heads)[1].float()
    acc = k[:, 0]
    for h in range(1, num_heads):
        acc = acc + k[:, h]
    # a true division, as JAX's and the kernel's: on a CUDA tensor PyTorch
    # multiplies by the reciprocal of a Python number divisor instead
    return (acc / acc.new_full((), num_heads)).to(qkv.dtype)


def ln_qkv_ref(x, ln_scale, ln_bias, wqkv, bqkv, eps: float):
    """qkv(LN1 x) [B, N, 3D], the LN output and qkv rounded to x's
    dtype."""
    ln = layer_norm_f32(x.float(), ln_scale, ln_bias, eps).to(x.dtype)
    return linear_f32(ln, wqkv, bqkv).to(x.dtype)


def attention_residual_ref(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                           num_heads: int, scale: float, eps: float,
                           bias=None, mask=None):
    """x + proj(attn(qkv(LN1 x))) in fp32, before its final rounding,
    with row0, colsum and the rounded qkv."""
    qkv = ln_qkv_ref(x, ln_scale, ln_bias, wqkv, bqkv, eps)
    merged, row0, colsum = attention_ref(qkv, num_heads, scale, bias, mask)
    return x.float() + linear_f32(merged, wproj, bproj), row0, colsum, qkv


def fused_block_attention_ref(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                              bproj, num_heads: int, scale: float, *,
                              eps: float = 1e-6, bias=None, mask=None,
                              want_keys: bool = False):
    """Plain PyTorch version of ``fused_block_attention``, same contract."""
    y32, row0, colsum, qkv = attention_residual_ref(
        x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, scale, eps,
        bias, mask)
    out = (y32.to(x.dtype), row0, colsum)
    return out + (head_mean_keys_ref(qkv, num_heads),) if want_keys else out


def backward_max_n(dtype) -> int:
    """The widest attention the training kernels take in ``dtype``: the
    bf16 backward streams its keys (csrc/attention_wide_sm90.cu); the fp32
    backward (csrc/short_attention_bwd.cu) holds a head in shared memory."""
    return ATTENTION_MAX_N if dtype == torch.bfloat16 \
        else SHORT_ATTENTION_MAX_N


def _check_width(name: str, N: int, hd: int, limit: int = ATTENTION_MAX_N):
    if hd != HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head dim {HEAD_DIM}, got "
                         f"{hd}")
    if not 1 <= N <= limit:
        raise ValueError(f"{name}: N={N} is outside the kernel's 1.."
                         f"{limit} tokens")


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


def mask_operand(name: str, mask, B: int, N: int, device):
    """The validity mask [B, N] (bool, or uint8 with non-zero = valid) as
    the kernels take it: contiguous bool, one byte per token, on the
    operands' device (None stays None)."""
    if mask is None:
        return None
    if tuple(mask.shape) != (B, N):
        raise ValueError(f"{name}: mask must be [B={B}, N={N}], got "
                         f"{tuple(mask.shape)}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"{name}: mask dtype {mask.dtype} is neither bool "
                        "nor uint8")
    if mask.device != device:
        raise ValueError(f"{name}: mask on {mask.device}, operands on "
                         f"{device}")
    return mask.bool().contiguous()


def check_attention_operands(name: str, x, num_heads: int, ln_scale, ln_bias,
                             wqkv, bqkv, wproj, bproj,
                             limit: int = ATTENTION_MAX_N):
    """Raise on anything the attention half's kernels do not take (N
    above ``limit`` tokens among it)."""
    from tokenreduction_tpu_torch.ops import _build

    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, N, D], got {tuple(x.shape)}")
    _, N, D = x.shape
    if D % num_heads:
        raise ValueError(f"{name}: D={D} is not a multiple of {num_heads} "
                         "heads")
    _check_width(name, N, D // num_heads, limit)
    _build.check_shapes(name, (ln_scale, (D,)), (ln_bias, (D,)),
                        (wqkv, (3 * D, D)), (bqkv, (3 * D,)),
                        (wproj, (D, D)), (bproj, (D,)))
    _build.check_operands(name, x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                          bproj)


def ln_qkv_cuda(x, ln_scale, ln_bias, wqkv, bqkv, eps: float, idx=None):
    """Step 1 of the module docstring on checked CUDA operands: LN1 rows,
    then qkv [B, N, 3D] in x's dtype; with idx (contiguous int32 [B, K])
    the LayerNorm reads rows idx[b, k] of image b, and qkv is [B, K, 3D]."""
    from tokenreduction_tpu_torch.ops import _build

    B, N, D = x.shape
    K = N if idx is None else idx.shape[1]
    ln = torch.empty(B * K, D, dtype=x.dtype, device=x.device)
    _build.layer_norm(x.view(B * N, D), ln_scale, ln_bias, ln, eps=eps,
                      idx=idx, rows_out=K, rows_in=N)
    qkv = torch.empty(B, K, 3 * D, dtype=x.dtype, device=x.device)
    _build.gemm(ln, wqkv, bqkv, qkv.view(B * K, 3 * D))
    return qkv


def ln_qkv(x, ln_scale, ln_bias, wqkv, bqkv, *, eps: float = 1e-6):
    """x [B, N, D] -> qkv(LN1 x) [B, N, 3D]: the prologue of ATS's
    sampling blocks (XLA's LN and product in the JAX package,
    ``reduction/ats.py:186-188``). On the card the layer_norm and gemm
    launches of ``fused_block_attention``'s step 1."""
    if not x.is_cuda:
        return ln_qkv_ref(x, ln_scale, ln_bias, wqkv, bqkv, eps)
    from tokenreduction_tpu_torch.ops import _build

    if x.dim() != 3:
        raise ValueError(f"ln_qkv: x must be [B, N, D], got {tuple(x.shape)}")
    D = x.shape[2]
    _build.check_shapes("ln_qkv", (ln_scale, (D,)), (ln_bias, (D,)),
                        (wqkv, (3 * D, D)), (bqkv, (3 * D,)))
    _build.check_operands("ln_qkv", x, ln_scale, ln_bias, wqkv, bqkv)
    return ln_qkv_cuda(x, ln_scale, ln_bias, wqkv, bqkv, eps)


def attention_half_cuda(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                        num_heads: int, scale: float, eps: float,
                        with_scores: bool, out_dtype=None, bias=None,
                        mask=None, idx=None, want_keys: bool = False):
    """Steps 1-4 of the module docstring on checked CUDA operands (bias:
    None or contiguous fp32 [B, N]; mask: None or contiguous bool
    [B, N]; idx: None or contiguous int32 [B, K], with no bias and no
    mask). Returns (out, row0, colsum, keys) at width K (N without idx):
    out in ``out_dtype`` (x's by default); the by-products are None
    without ``with_scores``, the keys without ``want_keys``. qkv makes a
    round trip through device memory between steps 1 and 2; the kernel
    tools' ``attn_joint`` keeps it on chip (PERF.md §6, row #12)."""
    from tokenreduction_tpu_torch.ops import _build

    B, N, D = x.shape
    K = N if idx is None else idx.shape[1]
    qkv = ln_qkv_cuda(x, ln_scale, ln_bias, wqkv, bqkv, eps, idx=idx)
    merged = torch.empty(B, K, D, dtype=x.dtype, device=x.device)
    row0 = colsum = keys = None
    if with_scores:
        row0 = torch.empty(B, num_heads, K, dtype=torch.float32,
                           device=x.device)
        colsum = torch.empty_like(row0)
    _build.short_attention(qkv, merged, num_heads, scale, bias=bias,
                           mask=mask, row0=row0, colsum=colsum)
    if want_keys:
        keys = torch.empty(B, K, D // num_heads, dtype=x.dtype,
                           device=x.device)
        _build.head_mean_keys(qkv, keys, num_heads)
    out = torch.empty(B, K, D, dtype=out_dtype or x.dtype, device=x.device)
    # the residual: rows idx[b, k] of x with idx, else x
    _build.gemm(merged.view(B * K, D), wproj, bproj, out.view(B * K, D),
                res=x.view(B * N, D), idx=idx, rows_out=K, rows_in=N)
    return out, row0, colsum, keys


def fused_block_attention(x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                          num_heads: int, scale: float, *, eps: float = 1e-6,
                          bias=None, mask=None, idx=None,
                          want_keys: bool = False):
    """x [B, N, D] -> (x + proj(attn(LN1 x)), row0 [B, H, N],
    colsum [B, H, N]), plus the head-mean keys [B, N, hd] with
    ``want_keys``; bias: None or the per-key additive bias [B, N]; mask:
    None or the validity mask [B, N] (bool or uint8); idx: None or the
    absolute token ids [B, K] (CLS included) of the rows to keep, which
    makes every output K wide: the block of ``take_tokens(x, idx)``. idx
    with a bias or a mask raises ``ValueError``; an id out of range raises
    on the CPU and faults the kernel on the card. Weights in nn.Linear's
    [out, in] layout: wqkv [3D, D], wproj [D, D]."""
    name = "fused_block_attention"
    if idx is not None and (bias is not None or mask is not None):
        raise ValueError(f"{name}: the idx prologue takes no bias and no "
                         "mask (as the JAX kernel asserts)")
    if not x.is_cuda:
        if idx is not None:
            x = take_tokens(x, idx)
        return fused_block_attention_ref(
            x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, scale,
            eps=eps, bias=bias, mask=mask, want_keys=want_keys)
    check_attention_operands(name, x, num_heads, ln_scale, ln_bias, wqkv,
                             bqkv, wproj, bproj)
    B, N = x.shape[:2]
    bias = bias_operand(name, bias, B, N, x.device)
    mask = mask_operand(name, mask, B, N, x.device)
    if idx is not None:
        from tokenreduction_tpu_torch.ops import _build

        idx = _build.check_idx(name, idx, x)
        _check_width(name, idx.shape[1], x.shape[2] // num_heads)
    out, row0, colsum, keys = attention_half_cuda(
        x, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, num_heads, scale, eps,
        with_scores=True, bias=bias, mask=mask, idx=idx, want_keys=want_keys)
    fused_block_attention.launches += 1
    return (out, row0, colsum, keys) if want_keys else (out, row0, colsum)


fused_block_attention.launches = 0


def fused_attention_cuda(name: str, q, k, v, scale: float, bias, mask=None,
                         want_stats: bool = False):
    """``short_attention`` over checked-here CUDA q, k, v [B, H, N, hd]:
    (out, row0, colsum, stats), out a [B, H, N, hd] view of merged heads
    [B, N, D], so that merging the heads afterwards copies nothing; stats
    is None, or with ``want_stats`` (bf16) the row statistics
    [B, H, N, 2] fp32 that the backward reads."""
    from tokenreduction_tpu_torch.ops import _build

    B, H, N, hd = q.shape
    _check_width(name, N, hd)
    _build.check_heads(name, q, k, v)
    bias = bias_operand(name, bias, B, N, q.device)
    mask = mask_operand(name, mask, B, N, q.device)
    out = torch.empty(B, N, H, hd, dtype=q.dtype, device=q.device) \
        .transpose(1, 2)
    row0 = torch.empty(B, H, N, dtype=torch.float32, device=q.device)
    colsum = torch.empty_like(row0)
    stats = torch.empty(B, H, N, 2, dtype=torch.float32, device=q.device) \
        if want_stats else None
    _build.short_attention_heads(q, k, v, out, scale, bias=bias, mask=mask,
                                 row0=row0, colsum=colsum, stats=stats)
    return out, row0, colsum, stats


def fused_attention(q, k, v, scale: float, *, bias=None, mask=None):
    """q, k, v [B, H, N, hd] (head dim contiguous) -> (out [B, H, N, hd],
    row0 [B, H, N] fp32, colsum [B, H, N] fp32); bias: None or the per-key
    additive bias [B, N]; mask: None or the validity mask [B, N]."""
    if not q.is_cuda:
        return fused_attention_ref(q, k, v, scale, bias=bias, mask=mask)
    res = fused_attention_cuda("fused_attention", q, k, v, scale, bias,
                               mask)[:3]
    fused_attention.launches += 1
    return res


fused_attention.launches = 0


def check_qkv(name: str, qkv, num_heads: int):
    """Raise unless qkv is a contiguous [B, N, 3D] operand of the
    attention kernels (float32 or bfloat16, head dim 64, N <=
    ATTENTION_MAX_N)."""
    from tokenreduction_tpu_torch.ops import _build

    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"{name}: qkv must be [B, N, 3D] with D a multiple "
                         f"of {num_heads} heads, got {tuple(qkv.shape)}")
    _check_width(name, qkv.shape[1], qkv.shape[2] // 3 // num_heads)
    _build.check_operands(name, qkv)


def fused_attention_qkv(qkv, num_heads: int, scale: float, *, bias=None,
                        mask=None):
    """qkv [B, N, 3D] (a packed projection, timm's (3, H, hd) column
    order) -> (merged heads [B, N, D], row0 [B, H, N] fp32, colsum
    [B, H, N] fp32); bias: None or the per-key additive bias [B, N];
    mask: None or the validity mask [B, N]."""
    name = "fused_attention_qkv"
    if not qkv.is_cuda:
        return fused_attention_qkv_ref(qkv, num_heads, scale, bias=bias,
                                       mask=mask)
    from tokenreduction_tpu_torch.ops import _build

    check_qkv(name, qkv, num_heads)
    B, N, D3 = qkv.shape
    bias = bias_operand(name, bias, B, N, qkv.device)
    mask = mask_operand(name, mask, B, N, qkv.device)
    out = torch.empty(B, N, D3 // 3, dtype=qkv.dtype, device=qkv.device)
    row0 = torch.empty(B, num_heads, N, dtype=torch.float32,
                       device=qkv.device)
    colsum = torch.empty_like(row0)
    _build.short_attention(qkv, out, num_heads, scale, bias=bias, mask=mask,
                           row0=row0, colsum=colsum, norm_p=True)
    fused_attention_qkv.launches += 1
    return out, row0, colsum


fused_attention_qkv.launches = 0


def rect_operands(name: str, qkv, idx, mask, num_heads: int):
    """Checked CUDA operands of the rectangular attention: (contiguous
    int32 ids [B, M], contiguous bool mask [B, N])."""
    from tokenreduction_tpu_torch.ops import _build

    check_qkv(name, qkv, num_heads)
    B, N = qkv.shape[:2]
    idx = _build.check_idx(name, idx, qkv)
    if not 1 <= idx.shape[1] <= ATTENTION_MAX_N:
        raise ValueError(f"{name}: M={idx.shape[1]} kept rows is outside "
                         f"the kernel's 1..{ATTENTION_MAX_N}")
    if mask is None:
        raise ValueError(f"{name}: the rectangular attention takes a mask")
    return idx, mask_operand(name, mask, B, N, qkv.device)


def rect_attention_cuda(qkv, idx, mask, num_heads: int, scale: float):
    """The rectangular ``short_attention`` on checked operands: merged
    heads [B, M, D] in qkv's dtype."""
    from tokenreduction_tpu_torch.ops import _build

    B, _, D3 = qkv.shape
    merged = torch.empty(B, idx.shape[1], D3 // 3, dtype=qkv.dtype,
                         device=qkv.device)
    _build.short_attention(qkv, merged, num_heads, scale, mask=mask, ids=idx)
    return merged


def fused_rect_attention(qkv, onehot, mask, num_heads: int, scale: float):
    """qkv [B, N, 3D], onehot [B, M, N] kept-row selectors, mask [B, N]
    key validity -> the merged heads [B, M, D] of the M kept query rows
    over all N keys (reference models/ats.py:117-120). Each selector row
    must be one-hot, as every caller's ``one_hot(sample_ids)`` is: the
    wrapper turns the selectors into row ids once (their argmax) and the
    kernel gathers those rows."""
    if not qkv.is_cuda:
        return fused_rect_attention_ref(qkv, onehot, mask, num_heads, scale)
    name = "fused_rect_attention"
    B, N = qkv.shape[:2]
    if onehot.dim() != 3 or onehot.shape[0] != B or onehot.shape[2] != N:
        raise ValueError(f"{name}: onehot must be [B={B}, M, N={N}], got "
                         f"{tuple(onehot.shape)}")
    idx, mask = rect_operands(name, qkv, onehot_ids(onehot), mask, num_heads)
    out = rect_attention_cuda(qkv, idx, mask, num_heads, scale)
    fused_rect_attention.launches += 1
    return out


fused_rect_attention.launches = 0


def fused_rect_block(qkv, x, idx, mask, wproj, bproj, num_heads: int,
                     scale: float):
    """take_tokens(x, idx) + proj(the rectangular attention of the kept
    rows): qkv [B, N, 3D], x [B, N, D], idx [B, M] absolute token ids in
    0..N-1, mask [B, N] -> [B, M, D] in x's dtype. Weights in nn.Linear's
    [out, in] layout: wproj [D, D]. An id out of range raises on the CPU
    and traps the kernel on the card."""
    if not qkv.is_cuda:
        return fused_rect_block_ref(qkv, x, idx, mask, wproj, bproj,
                                    num_heads, scale)
    from tokenreduction_tpu_torch.ops import _build

    name = "fused_rect_block"
    idx, mask = rect_operands(name, qkv, idx, mask, num_heads)
    B, N, D3 = qkv.shape
    D, M = D3 // 3, idx.shape[1]
    _build.check_shapes(name, (x, (B, N, D)), (wproj, (D, D)), (bproj, (D,)))
    _build.check_operands(name, qkv, x, wproj, bproj)
    merged = rect_attention_cuda(qkv, idx, mask, num_heads, scale)
    out = torch.empty(B, M, D, dtype=x.dtype, device=x.device)
    _build.gemm(merged.view(B * M, D), wproj, bproj, out.view(B * M, D),
                res=x.view(B * N, D), idx=idx, rows_out=M, rows_in=N)
    fused_rect_block.launches += 1
    return out


fused_rect_block.launches = 0
