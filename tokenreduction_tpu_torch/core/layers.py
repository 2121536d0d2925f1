"""Core ViT building blocks (PyTorch), shared by all reduction models.

Counterpart of ``tokenreduction_tpu/core/layers.py``. Parameter names are
timm's VisionTransformer names (patch_embed.proj, blocks.N.{norm1,
attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}, norm, head), the same the
Flax tree uses, so a DeiT ``.pth`` state dict loads with plain
``load_state_dict``.

``Block`` keeps the JAX dispatch with the TPU gates removed
(``core/layers.py:384-490``, ``:564-621`` there). In eval (``not
self.training``) every path of a block the kernels take (see below) goes
through a kernel wrapper: ``forward``
with no score and no mask -> ``fused_full_block``; ``attend`` -> one
``fused_block_attention`` call, with ToMe's per-key bias and head-mean
keys, heuristic's validity mask [B, N] (the JAX pair mask), or DyViT's
kept ids ``idx`` [B, K] (the rows selected in the prologue, the block run
at width K); ``ffn`` -> ``fused_mlp_residual``, ``ffn_gather`` ->
``fused_mlp_gather_residual``. In training idx is first
``take_tokens(x, idx)``; an attention half without a bias or a mask
goes through ``attend_branch_train`` and every MLP half through
``mlp_branch`` (each with a hand-written backward), then
``x + drop_path(branch)`` in x's dtype; where the JAX gate sends a half
to its XLA composition, ``Attention`` runs instead: for an attention half
with a bias or a mask, or with attention dropout or dropout above 0, and
for every attention half under DyViT's policy (its policy softmax, in
eval too; the MLP half keeps its kernel). Its
qkv and out projections are ``nn.Linear``, and between them, in training
without attention dropout, the attention core ``attention_core_train``
(again a hand-written backward, the bias and the mask included), else the
plain composition. The MLP half takes the plain composition only when
dropout is above 0. A wrapper runs its plain PyTorch version on a CPU
tensor and its hand-written kernels on a CUDA tensor.

Two gates send a block, or its attention half, to the plain composition
(``Attention`` with ``attention_probs_ref`` in eval, its plain training
composition, and ``Mlp``) on every device, eval and training alike:

- the width gate, on the attention halves only: the attention kernels take
  at most ``FULL_BLOCK_MAX_N`` tokens at head dim 64 (they hold one head's
  keys and values in shared memory). JAX gates its full block at the same
  width (``core/layers.py:574-582`` there) and pads its attention kernels
  to any width; here a wider attention half, or another head dim, runs the
  plain ``Attention``, and a wrapper called directly with such a shape
  raises. The MLP halves have no such limit and keep their kernels at any
  width, as JAX's ``ffn`` and ``ffn_gather`` do (``core/layers.py:497-560``
  there, gated on ``force_xla`` and ``deterministic`` alone).
- ``force_plain``, the counterpart of JAX's ``force_xla``: set from
  ``cfg.viz_mode`` where the model builds its blocks (JAX
  ``models/deit.py:76``), so extraction artifacts come from the same
  composition on every device. It is a pin chosen by the config, not a
  fallback: no kernel wrapper runs, and their launch counts stay 0.

Stochastic depth and dropout draw their masks from an explicit
``torch.Generator`` that the model's forward hands down (``generator=``),
on the device of the activations; training with a drop-path or dropout
rate above 0 and no generator raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tokenreduction_tpu_torch.ops.dyvit import softmax_with_policy
from tokenreduction_tpu_torch.ops.flash_attention import (
    HEAD_DIM,
    SHORT_ATTENTION_MAX_N,
    attention_probs_ref,
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

# The attention kernels' width limit (they hold one head's K and V in
# shared memory), JAX's FULL_BLOCK_MAX_N: a wider attention half runs the
# plain composition.
FULL_BLOCK_MAX_N = SHORT_ATTENTION_MAX_N


def kernels_take(N: int, head_dim: int, force_plain: bool = False) -> bool:
    """Whether an attention half (or a whole fused block) of N tokens at
    this head dim runs on the kernel counterparts: no ``force_plain`` pin,
    N <= FULL_BLOCK_MAX_N and head dim 64. Else it takes the plain
    composition."""
    return (not force_plain and N <= FULL_BLOCK_MAX_N
            and head_dim == HEAD_DIM)


_SCORES = (None, "cls", "keys", "colsum")


def _check_score(score):
    if score not in _SCORES:
        raise NotImplementedError(
            f"score={score!r} is not ported: no model of the JAX package "
            "asks for it")


def _drop(x, rate: float, shape, generator, layer: str):
    """x with each block of the mask's shape kept with probability 1 - rate
    and divided by it, else zeroed; the mask from ``generator``."""
    if generator is None:
        raise ValueError(
            f"{layer} in training draws its masks from an explicit "
            "torch.Generator: pass generator= to the model's forward")
    keep = 1.0 - rate
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


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
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return _drop(x, self.rate, shape, generator, "DropPath")


class Dropout(nn.Module):
    """Inverted dropout (timm's ``nn.Dropout``): in training each element
    is kept with probability 1 - p and then divided by it, else zeroed. The
    masks come from ``generator``, as JAX draws them from the step's
    ``make_rng("dropout")`` (``core/layers.py:320-331`` there)."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.p == 0.0 or not self.training:
            return x
        return _drop(x, self.p, x.shape, generator, "Dropout")


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.drop = Dropout(drop)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.drop(F.gelu(self.fc1(x)), generator)
        return self.drop(self.fc2(x), generator)


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
    per-key additive bias [B, N] on the logits (ToMe's log size) and an
    optional validity mask [B, N] (heuristic's static masks: the JAX pair
    mask, -FLT_MAX after the scale and the bias where the query or the key
    is invalid).

    ``score="cls"`` also returns the head-mean CLS->patch attention column
    [B, N-1] (topk/evit score, reference models/topk.py:60-61),
    ``score="keys"`` the head-mean keys [B, N, hd] (ToMe metric,
    models/tome.py:58), ``score="colsum"`` the attention mass each key
    receives, summed over heads and queries [B, N] (k-medoids' token
    weights, models/kmedoids.py:237-251).

    With DyViT's ``policy`` [B, N, 1] (a soft keep mask of the keys) the
    logits are an unrounded fp32 product, the probabilities come from
    ``softmax_with_policy`` and go to the value product in v's dtype, with
    no attention dropout: the reference builds the module but never calls
    it (JAX core/layers.py:302-324). Else, in training without attention
    dropout, where the block's gates let the kernels take it
    (``kernels=True``: ``kernels_take``, decided by the block), q, k and v
    go through ``attention_core_train`` (the JAX gate, core/layers.py:
    272-301); otherwise the plain composition runs (fp32 probabilities,
    as the JAX ``attention_core``), with attention dropout on the
    probabilities before the value product."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.attn_drop = Dropout(attn_drop)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x, *, bias=None, mask=None, policy=None,
                score: Optional[str] = None,
                generator: Optional[torch.Generator] = None,
                kernels: bool = False):
        """Returns (x, (aux, None)), the JAX module's aux contract."""
        _check_score(score)
        B, N, D = x.shape
        q, k, v = self.qkv(x).view(B, N, 3, self.num_heads, -1) \
            .permute(2, 0, 3, 1, 4).unbind(0)
        if policy is not None:
            logits = (q.float() @ k.float().transpose(-2, -1)) * self.scale
            probs = softmax_with_policy(logits, policy)
            out = (probs.to(v.dtype).float() @ v.float()).to(v.dtype)
            cls_row = probs[:, :, 0, 1:]
            colsum = probs.sum(2) if score == "colsum" else None
        elif self.training and self.attn_drop.p == 0.0 and kernels:
            out, row0, colsum = attention_core_train(q, k, v, self.scale,
                                                     bias, mask)
            cls_row = row0[:, :, 1:]
        else:
            probs = attention_probs_ref(q, k, v, self.scale, bias=bias,
                                        q_valid=mask, k_valid=mask)[1]
            # dropout before the value product; the score reads the
            # dropped tensor, as the reference does (models/topk.py:48-49,
            # 60-61)
            probs = self.attn_drop(probs, generator)
            out = (probs.to(v.dtype).float() @ v.float()).to(v.dtype)
            cls_row = probs[:, :, 0, 1:]
            colsum = probs.sum(2) if score == "colsum" else None
        x = self.proj_drop(self.proj(out.transpose(1, 2).reshape(B, N, D)),
                           generator)
        aux = None
        if score == "cls":
            aux = cls_row.mean(1)
        elif score == "keys":
            aux = k.mean(1)
        elif score == "colsum":
            aux = colsum.sum(1)
        return x, (aux, None)


class Block(nn.Module):
    """Standard pre-norm transformer block with the reduction hooks."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 layer_norm_eps: float = 1e-6, force_plain: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.eps = layer_norm_eps
        self.force_plain = force_plain
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

    def kernels_take(self, N: int) -> bool:
        """Whether this block runs its attention half (or the whole fused
        block) at width N on the kernel counterparts (``kernels_take``: the
        width gate and the viz pin). The MLP halves need only no pin."""
        return kernels_take(N, self.attn.qkv.in_features // self.num_heads,
                            self.force_plain)

    def attend(self, x, *, bias=None, mask=None, policy=None, idx=None,
               score: Optional[str] = None,
               generator: Optional[torch.Generator] = None):
        """norm1 -> attention -> droppath -> residual, returning
        (x, (aux, None)); bias: None or ToMe's per-key bias [B, N]; mask:
        None or the validity mask [B, N]; policy: None or DyViT's keep
        policy [B, N, 1], which sends the half to ``Attention``'s policy
        branch in eval and training alike (JAX core/layers.py:302-315,
        :404-416, :448-490); idx: None or the absolute ids
        [B, K] of the tokens to keep (CLS included), the same as
        ``take_tokens(x, idx)`` first. Where the kernels take the block
        (``kernels_take`` at the width the attention runs at), in eval one
        ``fused_block_attention`` call (JAX core/layers.py:448-485); in
        training one ``attend_branch_train`` call where there is no bias
        and no mask (with the keys, their plain recompute, as JAX
        core/layers.py:404-447), else ``Attention`` (also for
        ``score="colsum"``, as the JAX gate admits only None, "cls" and
        "keys" to the branch). A block the kernels
        do not take runs ``Attention`` in eval too (the JAX composition
        past its gates, core/layers.py:486-490)."""
        _check_score(score)
        N = x.shape[1] if idx is None else idx.shape[1]
        kernels = self.kernels_take(N) and policy is None
        if not self.training and kernels:
            res = fused_block_attention(
                x, *self._attn_params(), self.num_heads, self.attn.scale,
                eps=self.eps, bias=bias, mask=mask, idx=idx,
                want_keys=score == "keys")
            aux = None
            if score == "cls":
                aux = res[1][:, :, 1:].mean(1)
            elif score == "colsum":
                aux = res[2].sum(1)
            elif score == "keys":
                aux = res[3]
            return res[0], (aux, None)
        if idx is not None:
            x = take_tokens(x, idx)
        if (self.training and kernels and bias is None and mask is None
                and score != "colsum" and self.attn_kernels):
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
        y, aux = self.attn(self.norm1(x), bias=bias, mask=mask,
                           policy=policy, score=score, generator=generator,
                           kernels=kernels)
        return x + self.drop_path1(y, generator), aux

    def ffn(self, x, generator: Optional[torch.Generator] = None):
        """norm2 -> mlp -> droppath -> residual; unless the viz pin holds,
        in eval one ``fused_mlp_residual`` call (JAX core/layers.py:497-511),
        in training one ``mlp_branch`` call unless dropout is above 0 (JAX
        core/layers.py:512-533), at any width; else the plain
        composition."""
        if not self.force_plain:
            if not self.training:
                return fused_mlp_residual(x, *self._mlp_params(),
                                          eps=self.eps)
            if self.mlp_kernels:
                branch = mlp_branch(x, *self._mlp_params(), self.eps)
                return x + self.drop_path2(branch, generator)
        return x + self.drop_path2(self.mlp(self.norm2(x), generator),
                                   generator)

    def ffn_gather(self, x, idx, generator: Optional[torch.Generator] = None):
        """take_tokens(x, idx) -> ffn; in eval, unless the viz pin holds,
        one ``fused_mlp_gather_residual`` call (JAX core/layers.py:543-560).
        idx: [B, K] absolute token ids including CLS."""
        if not self.training and not self.force_plain:
            return fused_mlp_gather_residual(x, idx, *self._mlp_params(),
                                             eps=self.eps)
        return self.ffn(take_tokens(x, idx), generator)

    def forward(self, x, *, mask=None, policy=None,
                score: Optional[str] = None,
                generator: Optional[torch.Generator] = None):
        """Returns (x, (aux, None)); a score-less eval block without a
        mask or a policy that the kernels take is one ``fused_full_block``
        call (JAX core/layers.py:574-616, its width gate included), any
        other block ``attend`` and ``ffn`` (under a policy the MLP half
        still takes its kernel, as JAX's ``ffn`` does not look at the
        policy, core/layers.py:497-533)."""
        if (score is None and mask is None and policy is None
                and not self.training and self.kernels_take(x.shape[1])):
            out = fused_full_block(
                x, *self._attn_params(), *self._mlp_params(), self.num_heads,
                self.attn.scale, eps=self.eps)
            return out, (None, None)
        x, aux = self.attend(x, mask=mask, policy=policy, score=score,
                             generator=generator)
        return self.ffn(x, generator), aux
