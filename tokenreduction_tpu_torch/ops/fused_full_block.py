"""The whole pre-norm transformer block, for blocks that yield no score.

``fused_full_block`` is the counterpart of
``tokenreduction_tpu/ops/fused_full_block.py:118 fused_full_block``:

    y = x + proj(attn(qkv(LN1 x)));  out = y + fc2(gelu(fc1(LN2 y)))

Numerics are those of ``fused_block_attention`` followed by the MLP half
of ``fused_mlp_gather_residual`` without the gather: fp32 LayerNorm,
softmax, GELU and accumulation, operands rounded to the input dtype.
As in the TPU kernel, y stays fp32 between the halves: LN2 and the
second residual read it unrounded, and only the output is rounded.

Where it splits, and why: the TPU runs the block as one kernel with both
halves' weights resident in VMEM (4D^2 + 8D^2 elements, 3.5 MB in bf16 at
DeiT-S), which a Hopper SM's 227 KB of shared memory cannot hold. On the
card it is seven launches of the three hand-written kernels (``csrc/``):
LN1 ``layer_norm`` -> qkv ``gemm`` -> ``short_attention`` (no
by-products) -> proj ``gemm`` with bias and residual -> LN2
``layer_norm`` -> fc1 ``gemm`` with GELU -> fc2 ``gemm`` with bias and
residual. Both LN outputs, qkv, the merged heads, y and the hidden
tensor each make one round trip through device memory, y in fp32 (the
proj GEMM writes it so, and LN2 and the fc2 epilogue read it).

What bounds it: at N <= 197 and D = 384 the products are small, so the
attention and the LN/GELU passes weigh more than tensor-core operations,
and the K = 384 GEMMs lose a large share to each output tile's fill and
epilogue. The GEMM (``csrc/gemm_sm90.cu``) and the attention
(``csrc/attention_sm90.cu``) run on wgmma with TMA loads; keeping the
intermediates on chip is later work.

The TPU's VMEM plans (``full_block_supported``, ``_plan_group``) have no
counterpart: the limit on the card is the attention kernel's N <= 256,
and a CUDA tensor beyond it raises.

On a CPU tensor the wrapper runs ``fused_full_block_ref``; on a CUDA
tensor it launches the kernels or raises.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.ops.flash_attention import (
    attention_half_cuda,
    attention_residual_ref,
    check_attention_operands,
)
from tokenreduction_tpu_torch.ops.fused_mlp import (
    check_mlp_operands,
    mlp_half_cuda,
    mlp_residual_ref,
)


def fused_full_block_ref(x, ls1, lb1, wqkv, bqkv, wproj, bproj, ls2, lb2, w1,
                         b1, w2, b2, num_heads: int, scale: float, *,
                         eps: float = 1e-6):
    """Plain PyTorch version of ``fused_full_block``."""
    y32 = attention_residual_ref(x, ls1, lb1, wqkv, bqkv, wproj, bproj,
                                 num_heads, scale, eps)[0]
    return mlp_residual_ref(y32, ls2, lb2, w1, b1, w2, b2, eps).to(x.dtype)


def fused_full_block(x, ls1, lb1, wqkv, bqkv, wproj, bproj, ls2, lb2, w1, b1,
                     w2, b2, num_heads: int, scale: float, *,
                     eps: float = 1e-6):
    """x [B, N, D] -> the block's output [B, N, D]. Weights in nn.Linear's
    [out, in] layout."""
    if not x.is_cuda:
        return fused_full_block_ref(x, ls1, lb1, wqkv, bqkv, wproj, bproj,
                                    ls2, lb2, w1, b1, w2, b2, num_heads,
                                    scale, eps=eps)
    check_attention_operands("fused_full_block", x, num_heads, ls1, lb1,
                             wqkv, bqkv, wproj, bproj)
    check_mlp_operands("fused_full_block", x, ls2, lb2, w1, b1, w2, b2)
    y32 = attention_half_cuda(x, ls1, lb1, wqkv, bqkv, wproj, bproj,
                              num_heads, scale, eps, with_scores=False,
                              out_dtype=torch.float32)[0]
    out = mlp_half_cuda(y32, None, ls2, lb2, w1, b1, w2, b2, eps,
                        out_dtype=x.dtype)
    fused_full_block.launches += 1
    return out


fused_full_block.launches = 0
