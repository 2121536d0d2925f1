"""The MLP half of a transformer block with the top-k row gather fused in.

``fused_mlp_gather_residual`` is the counterpart of
``tokenreduction_tpu/ops/fused_mlp.py:192 fused_mlp_gather_residual``:

    g = x[b, idx[b]];  out = g + fc2(gelu(fc1(LN2 g)))

LayerNorm, the exact-erf GELU and accumulation are fp32; the LN output
and the hidden activations are rounded to the input dtype, as on the TPU.
(The TPU kernel's rational erf and its bf16 tanh GELU worked around the
TPU's vector unit; the card has ``erff``.)

Where it splits, and why: the TPU kernel keeps both weight matrices and
the [K, 4D] hidden tile in VMEM. On the card the counterpart is three
launches of the hand-written kernels in ``csrc/ln_gemm.cu``:

1. ``layer_norm``: gather through idx and LN2, writing the normalised
   rows [B*K, D];
2. ``gemm``: fc1 with its bias and GELU in the epilogue, the hidden
   tensor [B*K, 4D];
3. ``gemm``: fc2, with its bias and the residual, gathered through the
   same idx, in its epilogue.

The normalised rows and the hidden tensor each make one round trip
through device memory.

What bounds it: at K <= 197 rows per image and D = 384 the products are
small; the hidden tensor's round trip, the GELU and each output tile's
fill and epilogue weigh more than tensor-core operations. This is a
simple first version on mma.sync; wgmma, TMA and keeping the hidden
tensor on chip are later work.

On a CPU tensor the wrapper runs ``fused_mlp_gather_residual_ref``; on a
CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tokenreduction_tpu_torch.ops.flash_attention import (
    layer_norm_f32,
    linear_f32,
)
from tokenreduction_tpu_torch.ops.gather import take_tokens


def mlp_residual_ref(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float):
    """x + fc2(gelu(fc1(LN x))) over rows in fp32, before its final
    rounding, with the kernels' rounding of the LN output and the hidden
    tensor to the weights' dtype (x may be fp32 with bf16 weights)."""
    x32 = x.float()
    ln = layer_norm_f32(x32, ln_scale, ln_bias, eps).to(w1.dtype)
    h = F.gelu(linear_f32(ln, w1, b1)).to(w1.dtype)
    return x32 + linear_f32(h, w2, b2)


def fused_mlp_gather_residual_ref(x, idx, ln_scale, ln_bias, w1, b1, w2, b2,
                                  *, eps: float = 1e-6):
    """Plain PyTorch version of ``fused_mlp_gather_residual``."""
    return mlp_residual_ref(take_tokens(x, idx), ln_scale, ln_bias, w1, b1,
                            w2, b2, eps).to(x.dtype)


def check_mlp_operands(name: str, x, ln_scale, ln_bias, w1, b1, w2, b2):
    """Raise on anything the MLP half's kernels do not take."""
    from tokenreduction_tpu_torch.ops import _build

    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, N, D], got {tuple(x.shape)}")
    D = x.shape[2]
    H4 = w1.shape[0]
    if D % 8 or H4 % 8:
        raise ValueError(f"{name}: D={D} and the hidden width {H4} must be "
                         "multiples of 8")
    _build.check_shapes(name, (ln_scale, (D,)), (ln_bias, (D,)),
                        (w1, (H4, D)), (b1, (H4,)), (w2, (D, H4)), (b2, (D,)))
    _build.check_operands(name, x, ln_scale, ln_bias, w1, b1, w2, b2)


def mlp_half_cuda(x, idx, ln_scale, ln_bias, w1, b1, w2, b2, eps: float,
                  out_dtype=None):
    """Steps 1-3 of the module docstring on checked CUDA operands; idx
    is None (every row, in order) or contiguous int32 [B, K]. x has the
    weights' dtype or is fp32; the output is in ``out_dtype`` (x's by
    default) and the hidden tensor in the weights' dtype."""
    from tokenreduction_tpu_torch.ops import _build

    B, N, D = x.shape
    K = N if idx is None else idx.shape[1]
    H4 = w1.shape[0]
    rows = x.view(B * N, D)
    ln = torch.empty(B * K, D, dtype=w1.dtype, device=x.device)
    _build.layer_norm(rows, ln_scale, ln_bias, ln, eps=eps, idx=idx,
                      rows_out=K, rows_in=N)
    hidden = torch.empty(B * K, H4, dtype=w1.dtype, device=x.device)
    _build.gemm(ln, w1, b1, hidden, gelu=True)
    out = torch.empty(B, K, D, dtype=out_dtype or x.dtype, device=x.device)
    _build.gemm(hidden, w2, b2, out.view(B * K, D), res=rows, idx=idx,
                rows_out=K, rows_in=N)
    return out


def fused_mlp_gather_residual(x, idx, ln_scale, ln_bias, w1, b1, w2, b2, *,
                              eps: float = 1e-6):
    """x [B, N, D], idx [B, K] absolute token ids in 0..N-1 (0 is CLS) ->
    [B, K, D]. Weights in nn.Linear's [out, in] layout: w1 [4D, D], w2
    [D, 4D]. An id out of range raises on the CPU and faults the kernel
    on the card."""
    if not x.is_cuda:
        return fused_mlp_gather_residual_ref(x, idx, ln_scale, ln_bias, w1,
                                             b1, w2, b2, eps=eps)
    from tokenreduction_tpu_torch.ops import _build

    check_mlp_operands("fused_mlp_gather_residual", x, ln_scale, ln_bias, w1,
                       b1, w2, b2)
    idx = _build.check_idx("fused_mlp_gather_residual", idx, x)
    out = mlp_half_cuda(x, idx, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    fused_mlp_gather_residual.launches += 1
    return out


fused_mlp_gather_residual.launches = 0
