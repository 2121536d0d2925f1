"""Core ViT building blocks (PyTorch), shared by all reduction models.

Counterpart of ``tokenreduction_tpu/core/layers.py``. Parameter names are
timm's VisionTransformer names (patch_embed.proj, blocks.N.{norm1,
attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}, norm, head), the same the
Flax tree uses, so a DeiT ``.pth`` state dict loads with plain
``load_state_dict``.

``Block`` keeps the JAX dispatch with the TPU gates removed. In eval
(``not self.training``) every path goes through a kernel wrapper:
``forward`` with no score -> ``fused_full_block``, ``attend`` ->
``fused_block_attention`` (with ToMe's per-key bias and head-mean keys),
``ffn`` -> ``fused_mlp_residual``, ``ffn_gather`` ->
``fused_mlp_gather_residual``. In training an attention half without a
bias goes through ``attend_branch_train`` and every MLP half through
``mlp_branch`` (each with a hand-written backward), then
``x + drop_path(branch)`` in x's dtype; where the JAX gate sends a half
to its XLA composition, ``Attention`` runs instead: for an attention half
with a bias, or with attention dropout or dropout above 0. Its qkv and
out projections are ``nn.Linear``, and between them, in training without
attention dropout, the attention core ``attention_core_train`` (again a
hand-written backward), else the plain composition. The MLP half takes
the plain composition only when dropout is above 0. A wrapper runs its
plain PyTorch version on a CPU tensor and its hand-written kernels on a
CUDA tensor.

Stochastic depth draws its masks from an explicit ``torch.Generator``
that the model's forward hands down (``generator=``), on the device of
the activations; training with a drop-path rate above 0 and no generator
raises.
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
from tokenreduction_tpu_torch.ops.flash_attention_train import (
    attention_core_train,
)
from tokenreduction_tpu_torch.ops.fused_block_train import (
    attend_branch_train,
)
from tokenreduction_tpu_torch.ops.fused_full_block import fused_full_block
from tokenreduction_tpu_torch.ops.fused_mlp import (
    fused_mlp_gather_residual,
    fused_mlp_residual,
)
from tokenreduction_tpu_torch.ops.fused_mlp_train import mlp_branch
from tokenreduction_tpu_torch.ops.gather import take_tokens

# The kernels' documented width limit (the attention kernel holds one
# head's K and V in shared memory). A CUDA tensor beyond it raises.
FULL_BLOCK_MAX_N = SHORT_ATTENTION_MAX_N

_SCORES = (None, "cls", "keys")


def _check_score(score):
    if score not in _SCORES:
        raise NotImplementedError(
            f"score={score!r} is not ported yet; it comes with its method "
            "(ROADMAP Queue 1 item 6)")


class DropPath(nn.Module):
    """Stochastic depth per sample (timm drop_path semantics): in training
    each sample's branch is kept with probability 1 - rate and then
    divided by it, else zeroed. The masks come from ``generator``."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError(
                "DropPath in training draws its masks from an explicit "
                "torch.Generator: pass generator= to the model's forward")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
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
    """Multi-head self-attention over pre-normed x, with an optional
    per-key additive bias [B, N] on the logits (ToMe's log size).

    ``score="cls"`` also returns the head-mean CLS->patch attention column
    [B, N-1] (topk/evit score, reference models/topk.py:60-61),
    ``score="keys"`` the head-mean keys [B, N, hd] (ToMe metric,
    models/tome.py:58). The other scores of the JAX module come with their
    methods.

    In training without attention dropout q, k and v go through
    ``attention_core_train`` (the JAX gate, core/layers.py:272-301);
    otherwise the plain composition runs, with attention dropout on the
    probabilities before the value product."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x, *, bias=None, score: Optional[str] = None):
        """Returns (x, (aux, None)), the JAX module's aux contract."""
        _check_score(score)
        B, N, D = x.shape
        q, k, v = self.qkv(x).view(B, N, 3, self.num_heads, -1) \
            .permute(2, 0, 3, 1, 4).unbind(0)
        if self.training and self.attn_drop.p == 0.0:
            out, row0, _ = attention_core_train(q, k, v, self.scale, bias)
            cls_row = row0[:, :, 1:]
        else:
            logits = (q @ k.transpose(-1, -2)) * self.scale
            if bias is not None:
                logits = logits + bias[:, None, None, :]
            # dropout before the value product; the score reads the
            # dropped tensor, as the reference does (models/topk.py:48-49,
            # 60-61)
            probs = self.attn_drop(logits.softmax(-1))
            out = probs @ v
            cls_row = probs[:, :, 0, 1:]
        x = self.proj_drop(self.proj(out.transpose(1, 2).reshape(B, N, D)))
        aux = None
        if score == "cls":
            aux = cls_row.mean(1)
        elif score == "keys":
            aux = k.mean(1)
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
        # the JAX gates of the training kernels: the attention branch
        # needs no bias, no attention dropout and no dropout
        # (core/layers.py:404-416), the MLP half only no dropout
        # (core/layers.py:512-520)
        self.attn_kernels = attn_drop == 0.0 and drop == 0.0
        self.mlp_kernels = drop == 0.0
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

    def attend(self, x, *, bias=None, score: Optional[str] = None,
               generator: Optional[torch.Generator] = None):
        """norm1 -> attention -> droppath -> residual, returning
        (x, (aux, None)); bias: None or ToMe's per-key bias [B, N]. In
        eval one ``fused_block_attention`` call; in training one
        ``attend_branch_train`` call where there is no bias (with the
        keys, their plain recompute, as JAX core/layers.py:438-445), else
        ``Attention``."""
        _check_score(score)
        if not self.training:
            res = fused_block_attention(
                x, *self._attn_params(), self.num_heads, self.attn.scale,
                eps=self.eps, bias=bias, want_keys=score == "keys")
            aux = None
            if score == "cls":
                aux = res[1][:, :, 1:].mean(1)
            elif score == "keys":
                aux = res[3]
            return res[0], (aux, None)
        if bias is None and self.attn_kernels:
            branch, row0 = attend_branch_train(
                x, *self._attn_params(), self.num_heads, self.attn.scale,
                self.eps)
            aux = None
            if score == "cls":
                aux = row0[:, :, 1:].mean(1)
            elif score == "keys":
                # differentiable plain recompute of the head-mean keys
                B, N, _ = x.shape
                aux = self.attn.qkv(self.norm1(x)) \
                    .view(B, N, 3, self.num_heads, -1)[:, :, 1].mean(2)
            return x + self.drop_path1(branch, generator), (aux, None)
        y, aux = self.attn(self.norm1(x), bias=bias, score=score)
        return x + self.drop_path1(y, generator), aux

    def ffn(self, x, generator: Optional[torch.Generator] = None):
        """norm2 -> mlp -> droppath -> residual; in eval one
        ``fused_mlp_residual`` call, in training one ``mlp_branch`` call
        (the plain composition when dropout is above 0)."""
        if not self.training:
            return fused_mlp_residual(x, *self._mlp_params(), eps=self.eps)
        if self.mlp_kernels:
            branch = mlp_branch(x, *self._mlp_params(), self.eps)
            return x + self.drop_path2(branch, generator)
        return x + self.drop_path2(self.mlp(self.norm2(x)), generator)

    def ffn_gather(self, x, idx, generator: Optional[torch.Generator] = None):
        """take_tokens(x, idx) -> ffn; in eval one
        ``fused_mlp_gather_residual`` call. idx: [B, K] absolute token ids
        including CLS."""
        if not self.training:
            return fused_mlp_gather_residual(x, idx, *self._mlp_params(),
                                             eps=self.eps)
        return self.ffn(take_tokens(x, idx), generator)

    def forward(self, x, *, score: Optional[str] = None,
                generator: Optional[torch.Generator] = None):
        """Returns (x, (aux, None)); a score-less eval block is one
        ``fused_full_block`` call."""
        if score is None and not self.training:
            out = fused_full_block(
                x, *self._attn_params(), *self._mlp_params(), self.num_heads,
                self.attn.scale, eps=self.eps)
            return out, (None, None)
        x, aux = self.attend(x, score=score, generator=generator)
        return self.ffn(x, generator), aux
