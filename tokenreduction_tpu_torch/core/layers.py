"""Core ViT building blocks (PyTorch), shared by all reduction models.

Counterpart of ``tokenreduction_tpu/core/layers.py``. Parameter names are
timm's VisionTransformer names (patch_embed.proj, blocks.N.{norm1,
attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}, norm, head), the same the
Flax tree uses, so a DeiT ``.pth`` state dict loads with plain
``load_state_dict``.

``Block`` keeps the JAX dispatch with the TPU gates removed. In eval
(``not self.training``) every path goes through a kernel wrapper:
``forward`` with no score -> ``fused_full_block``, ``attend`` ->
``fused_block_attention``, ``ffn_gather`` -> ``fused_mlp_gather_residual``.
The wrapper runs its plain PyTorch version on a CPU tensor and its
hand-written kernels on a CUDA tensor. In training the plain module
composition runs under autograd; on a CUDA tensor that raises until the
training kernels are ported (ROADMAP Queue 2 items 6-7).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tokenreduction_tpu_torch.ops.flash_attention import (
    SHORT_ATTENTION_MAX_N,
    fused_block_attention,
)
from tokenreduction_tpu_torch.ops.fused_full_block import fused_full_block
from tokenreduction_tpu_torch.ops.fused_mlp import fused_mlp_gather_residual
from tokenreduction_tpu_torch.ops.gather import take_tokens

# The kernels' documented width limit (the attention kernel holds one
# head's K and V in shared memory). A CUDA tensor beyond it raises.
FULL_BLOCK_MAX_N = SHORT_ATTENTION_MAX_N

_SCORES = (None, "cls")


def _check_score(score):
    if score not in _SCORES:
        raise NotImplementedError(
            f"score={score!r} is not ported yet; it comes with its method "
            "(ROADMAP Queue 1 item 6)")


def _check_train_device(module: nn.Module, x: torch.Tensor):
    if module.training and x.is_cuda:
        raise NotImplementedError(
            "training on the GPU needs the training kernels, not ported yet "
            "(ROADMAP Queue 2 items 6-7); call .eval() for inference")


class DropPath(nn.Module):
    """Stochastic depth per sample (timm drop_path semantics)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, dtype=x.dtype, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.drop = nn.Dropout(drop)

    def forward(self, x):
        x = self.drop(F.gelu(self.fc1(x)))
        return self.drop(self.fc2(x))


class PatchEmbed(nn.Module):
    """Image to patch embedding: NCHW -> conv (kernel = stride = patch)
    -> [B, N, D]."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size=patch_size,
                              stride=patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    """Multi-head self-attention, the plain composition.

    ``score="cls"`` also returns the head-mean CLS->patch attention column
    [B, N-1] (topk/evit score, reference models/topk.py:60-61). The other
    scores of the JAX module come with their methods."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x, *, score: Optional[str] = None):
        """Returns (x, (aux, None)), the JAX module's aux contract."""
        _check_score(score)
        B, N, D = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.num_heads, -1) \
            .permute(2, 0, 3, 1, 4)
        probs = ((q @ k.transpose(-1, -2)) * self.scale).softmax(-1)
        # dropout before the value product; the score reads the dropped
        # tensor, as the reference does (models/topk.py:48-49, 60-61)
        probs = self.attn_drop(probs)
        x = (probs @ v).transpose(1, 2).reshape(B, N, D)
        x = self.proj_drop(self.proj(x))
        aux = probs[:, :, 0, 1:].mean(1) if score == "cls" else None
        return x, (aux, None)


class Block(nn.Module):
    """Standard pre-norm transformer block with the reduction hooks."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 layer_norm_eps: float = 1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.eps = layer_norm_eps
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias,
                              attn_drop=attn_drop, proj_drop=drop)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop=drop)
        self.drop_path2 = DropPath(drop_path)

    def _attn_params(self):
        qkv = self.attn.qkv
        bqkv = qkv.bias if qkv.bias is not None else torch.zeros(
            qkv.out_features, dtype=qkv.weight.dtype,
            device=qkv.weight.device)
        return (self.norm1.weight, self.norm1.bias, qkv.weight, bqkv,
                self.attn.proj.weight, self.attn.proj.bias)

    def _mlp_params(self):
        return (self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias)

    def attend(self, x, *, score: Optional[str] = None):
        """norm1 -> attention -> droppath -> residual, returning
        (x, (aux, None)); in eval one ``fused_block_attention`` call."""
        _check_score(score)
        _check_train_device(self, x)
        if not self.training:
            out, row0, _ = fused_block_attention(
                x, *self._attn_params(), self.num_heads, self.attn.scale,
                eps=self.eps)
            aux = row0[:, :, 1:].mean(1) if score == "cls" else None
            return out, (aux, None)
        y, aux = self.attn(self.norm1(x), score=score)
        return x + self.drop_path1(y), aux

    def ffn(self, x):
        """norm2 -> mlp -> droppath -> residual, the plain composition.

        Off the main path (topk reaches it only when a stage keeps every
        token); its kernel, ``fused_mlp_residual``, is not ported yet."""
        if x.is_cuda:
            raise NotImplementedError(
                "Block.ffn on the GPU needs fused_mlp_residual in eval "
                "(ROADMAP Queue 2 item 4) and the training kernels in "
                "training (items 6-7); neither is ported yet")
        return x + self.drop_path2(self.mlp(self.norm2(x)))

    def ffn_gather(self, x, idx):
        """take_tokens(x, idx) -> ffn; in eval one
        ``fused_mlp_gather_residual`` call. idx: [B, K] absolute token ids
        including CLS."""
        _check_train_device(self, x)
        if not self.training:
            return fused_mlp_gather_residual(x, idx, *self._mlp_params(),
                                             eps=self.eps)
        return self.ffn(take_tokens(x, idx))

    def forward(self, x, *, score: Optional[str] = None):
        """Returns (x, (aux, None)); a score-less eval block is one
        ``fused_full_block`` call."""
        _check_train_device(self, x)
        if score is None and not self.training:
            out = fused_full_block(
                x, *self._attn_params(), *self._mlp_params(), self.num_heads,
                self.attn.scale, eps=self.eps)
            return out, (None, None)
        x, aux = self.attend(x, score=score)
        return self.ffn(x), aux
