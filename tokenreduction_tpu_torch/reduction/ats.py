"""Adaptive Token Sampling (reference models/ats.py).

Counterpart of ``tokenreduction_tpu/reduction/ats.py``. The per-image
dynamic token count becomes a fixed-width masked representation (see
``ops/ats.py``): a sampling block keeps ``num_sample_steps(K) + 1`` slots,
CLS first, the sampled tokens sorted, and pad slots (CLS copies) masked
off. At keep 0.7 on DeiT-S the sample counts are 138, 97, 68 at blocks 3,
6, 9 and the widths 197 -> 138 -> 97 -> 68.

In eval every attention half that the kernels take (``kernels_take``: at
most ``ATTENTION_MAX_N`` tokens at head dim 64, and no viz pin), and every
MLP half but under the viz pin, goes through the kernel wrappers, the JAX
dispatch with its TPU gate removed (``reduction/ats.py:151-225``):

- a block that does not sample runs ``fused_block_attention`` with the
  mask (all ones before the first sampling block);
- a sampling block runs LN1 and the qkv product (``ln_qkv``), the CLS
  logits row, its softmax and the value norms in plain PyTorch, the
  sampler, then ``fused_rect_block``: the kept rows' attention over all
  keys, the out projection and the gathered residual;
- every MLP half runs ``fused_mlp_residual``.

ATS training has no kernel in the JAX package (its blocks take the XLA
composition whenever ``deterministic`` is false), so on any device the
training forward is plain PyTorch, autograd for the backward, with the
stochastic-depth and dropout masks from the forward's ``generator``. An
eval attention half the kernels do not take runs that same plain
composition, as JAX's does past its gate (with ``cfg.viz_mode``:
``force_xla``, which pins the MLP half too), and so does an eval forward
that autograd records (``Block.eval_kernels``).
"""

from __future__ import annotations

from typing import Optional

import torch

from tokenreduction_tpu_torch.core.config import reduction_schedule
from tokenreduction_tpu_torch.core.layers import Attention, Block
from tokenreduction_tpu_torch.models.deit import ViTBase
from tokenreduction_tpu_torch.ops.ats import sample_ids_from_scores
from tokenreduction_tpu_torch.ops.flash_attention import (
    MASK_VALUE,
    attention_probs_ref,
    fused_block_attention,
    fused_rect_block,
    ln_qkv,
    packed_heads,
)
from tokenreduction_tpu_torch.ops.fused_mlp import fused_mlp_residual
from tokenreduction_tpu_torch.ops.gather import take_tokens


@torch.no_grad()
def sample_tokens(q, k, v, mask, scale: float, sample_count: int,
                  eps: float):
    """(sample ids [B, K], new mask [B, K]) from the CLS query's softmax
    over the valid keys and the patch tokens' value norms, without the
    [B, H, N, N] tensor (JAX ``reduction/ats.py:47-59``). The ids are
    discrete: nothing here takes a gradient."""
    logits0 = torch.einsum("bhd,bhkd->bhk", q[:, :, 0].float(),
                           k.float()) * scale
    logits0 = logits0.masked_fill(~mask[:, None, :], MASK_VALUE)
    cls_attn = logits0.softmax(-1)[..., 1:]
    value_norms = torch.linalg.vector_norm(v[:, :, 1:, :], dim=-1)
    return sample_ids_from_scores(cls_attn, value_norms, mask, sample_count,
                                  eps)


class ATSAttention(Attention):
    """Masked attention that optionally resamples its own rows (reference
    models/ats.py:92-134): timm's qkv and proj, and the plain training
    composition."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 proj_drop: float = 0.0, sample_count: int = 0,
                 eps: float = 1e-6):
        super().__init__(dim, num_heads, qkv_bias=qkv_bias,
                         proj_drop=proj_drop)
        self.sample_count = sample_count
        self.eps = eps

    def forward(self, x, mask, generator: Optional[torch.Generator] = None):
        """Pre-normed x [B, N, D] and mask [B, N] -> (proj(attention)
        [B, K, D], the mask after this block [B, K], the sample ids
        [B, K] or None); K = N unless the block samples."""
        B, N, D = x.shape
        q, k, v = packed_heads(self.qkv(x), self.num_heads)
        sample_ids = None
        q_valid = mask
        if self.sample_count:
            sample_ids, new_mask = sample_tokens(q, k, v, mask, self.scale,
                                                 self.sample_count, self.eps)
            # a re-sampled dead slot keeps its invalid query: its row is
            # uniform over all N keys, as the reference computes it
            q_valid = torch.gather(mask, 1, sample_ids)
            q = torch.gather(q, 2, sample_ids[:, None, :, None].expand(
                B, self.num_heads, -1, q.shape[-1]))
        # the JAX XLA composition (core/layers.py:65-82,
        # reduction/ats.py:84-102): normalised probabilities rounded before
        # an fp32 value product
        out = attention_probs_ref(q, k, v, self.scale, q_valid=q_valid,
                                  k_valid=mask, norm_p=True)[0]
        x = self.proj_drop(self.proj(out.transpose(1, 2).flatten(2)),
                           generator)
        return x, (mask if sample_ids is None else new_mask), sample_ids


class ATSBlock(Block):
    """A pre-norm block whose attention samples ``sample_count`` tokens
    (0: a masked block that keeps its width)."""

    def __init__(self, dim: int, num_heads: int, *, sample_count: int = 0,
                 ats_eps: float = 1e-6, **kwargs):
        super().__init__(dim, num_heads, **kwargs)
        self.attn = ATSAttention(dim, num_heads,
                                 qkv_bias=self.attn.qkv.bias is not None,
                                 proj_drop=self.attn.proj_drop.p,
                                 sample_count=sample_count, eps=ats_eps)

    def forward(self, x, mask, generator: Optional[torch.Generator] = None):
        """(x, mask) -> (x, the mask after this block, the sample ids or
        None)."""
        eval_kernels = self.eval_kernels(x)
        if not eval_kernels or not self.kernels_take(x.shape[1]):
            y, mask, sample_ids = self.attn(self.norm1(x), mask, generator)
            if sample_ids is not None:
                x = take_tokens(x, sample_ids)
            x = x + self.drop_path1(y, generator)
        else:
            attn = self.attn
            sample_ids = None
            if attn.sample_count == 0:
                x = fused_block_attention(
                    x, *self._attn_params(), self.num_heads, attn.scale,
                    eps=self.eps, mask=mask)[0]
            else:
                ln_w, ln_b, wqkv, bqkv, wproj, bproj = self._attn_params()
                qkv = ln_qkv(x, ln_w, ln_b, wqkv, bqkv, eps=self.eps)
                sample_ids, new_mask = sample_tokens(
                    *packed_heads(qkv, self.num_heads), mask, attn.scale,
                    attn.sample_count, attn.eps)
                x = fused_rect_block(qkv, x, sample_ids, mask, wproj, bproj,
                                     self.num_heads, attn.scale)
                mask = new_mask
        if not eval_kernels:
            x = x + self.drop_path2(self.mlp(self.norm2(x), generator),
                                    generator)
        else:
            x = fused_mlp_residual(x, *self._mlp_params(), eps=self.eps)
        return x, mask, sample_ids


class ATSVisionTransformer(ViTBase):
    def __init__(self, cfg, **kwargs):
        if cfg.attn_drop_rate > 0.0:
            # The reference applies attention-prob dropout to the full
            # [B,H,N,N] tensor before ATS sampling reads it
            # (models/ats.py:122-127); the two-pass restructure never
            # materializes that tensor, so live attn_drop cannot be
            # reproduced exactly here. The paper protocol uses 0.0 --
            # refuse rather than silently train different math.
            raise NotImplementedError(
                "ATS does not support attn_drop_rate > 0: the reference "
                "drops the full attention-probability tensor before "
                "sampling (models/ats.py:122-127), which the fused "
                "two-pass ATS restructure never materializes.")
        super().__init__(cfg, **kwargs)

    def make_block(self, i: int, drop_path: float) -> ATSBlock:
        c = self.cfg
        counts = dict(zip(c.reduction_loc, reduction_schedule(c)))
        return ATSBlock(c.embed_dim, c.num_heads,
                        sample_count=counts.get(i, 0),
                        ats_eps=c.ats_eps, mlp_ratio=c.mlp_ratio,
                        qkv_bias=c.qkv_bias, drop=c.drop_rate,
                        drop_path=drop_path, layer_norm_eps=c.layer_norm_eps,
                        force_plain=c.viz_mode)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """Logits; in eval with ``cfg.viz_mode`` also
        {"Kept_Tokens": {block: [B, K - 1] patch-local sample ids, -1 for a
        pad slot}, "Features": {block: tokens after it}}. ``generator``:
        the stochastic-depth masks' generator in training."""
        c = self.cfg
        x = self.embed(x, generator)
        B, N = x.shape[:2]
        mask = torch.ones(B, N, dtype=torch.bool, device=x.device)
        decisions = {}
        features = {}
        for i, blk in enumerate(self.blocks):
            x, mask, sample_ids = blk(x, mask, generator)
            if c.viz_mode and sample_ids is not None:
                # -1 marks padding after the shift (reference ats.py:254)
                decisions[i] = sample_ids[:, 1:] - 1
                features[i] = x
        if c.viz_mode and (c.depth - 1) not in features:
            features[c.depth - 1] = x
        out = self.classify(x)
        if c.viz_mode and not self.training:
            return out, {"Kept_Tokens": decisions, "Features": features}
        return out
