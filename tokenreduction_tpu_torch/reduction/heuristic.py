"""Heuristic static pruning: fixed center-distance attention masks
(reference models/heuristic.py).

Counterpart of ``tokenreduction_tpu/reduction/heuristic.py``. Tokens are
never removed: from each active block on, a validity mask [B, N] sends
the block's attention through the JAX pair mask (a masked token's query
row attends uniformly over all N keys, and no valid row attends to it),
so every block runs at N = 197 on DeiT-S. The masks are computed once at
construction (``ops/heuristic.py``, pure numpy) and kept as non-persistent
buffers on the model's device; the forward only expands them to [B, N]
there. With the defaults (pattern l1, min_radius 1.0, contiguous) and
reduction_loc 3 6 9 the active blocks are 3-9, keeping 184, 156, 136, 84,
60, 24 and 12 patches; blocks 10 and 11 keep block 9's mask.

In eval a block before the first active one is one ``fused_full_block``
call, a masked block ``fused_block_attention`` with the mask and
``fused_mlp_residual``. In training the masked attention halves go
through ``Attention`` and ``attention_core_train`` with the mask (its
hand-written backward zeroes dS at every masked pair), the others
through ``attend_branch_train``; every MLP half through ``mlp_branch``.
"""

from __future__ import annotations

import numpy as np
import torch

from tokenreduction_tpu_torch.core.config import reduction_schedule
from tokenreduction_tpu_torch.models.deit import ViTBase
from tokenreduction_tpu_torch.ops.heuristic import (
    contiguous_thresholds,
    masks_per_block,
    subset_thresholds,
)


def heuristic_masks(cfg):
    """(active blocks, {block: token mask [N] bool}, {block: kept patch
    ids}): pure config-time numpy, as JAX ``heuristic_masks``."""
    c = cfg
    if c.not_contiguous:
        z, thr = subset_thresholds(
            c.num_patches, c.heuristic_pattern, list(reduction_schedule(c)),
            list(c.reduction_loc), c.depth)
        active_loc = list(c.reduction_loc)
    else:
        z, thr, active_loc = contiguous_thresholds(
            c.num_patches, c.heuristic_pattern, c.min_radius,
            int(min(c.reduction_loc)), int(max(c.reduction_loc)), c.depth)
    masks, kept = masks_per_block(z, thr, active_loc, c.depth,
                                  c.num_prefix_tokens)
    return active_loc, {i: np.asarray(m) for i, m in masks.items()}, kept


class HeuristicVisionTransformer(ViTBase):
    def make_modules(self):
        self.active_loc, masks, kept = heuristic_masks(self.cfg)
        for i in self.active_loc:
            self.register_buffer(f"mask_{i}", torch.from_numpy(masks[i]),
                                 persistent=False)
            self.register_buffer(f"kept_{i}", torch.from_numpy(kept[i]),
                                 persistent=False)

    def reduction_count(self):
        return list(self.active_loc)

    def forward(self, x, generator: torch.Generator | None = None):
        """Logits; in eval with ``cfg.viz_mode`` also
        {"Kept_Tokens_Abs": {block: [B, kept] patch ids}, "Features":
        {block: tokens after it}}. ``generator``: the stochastic-depth
        masks' generator in training."""
        c = self.cfg
        x = self.embed(x)
        B, N = x.shape[:2]
        decisions = {}
        features = {}
        mask = None
        for i, blk in enumerate(self.blocks):
            if i in self.active_loc:
                mask = getattr(self, f"mask_{i}")[None].expand(B, N)
                if c.viz_mode:
                    kept = getattr(self, f"kept_{i}")
                    decisions[i] = kept[None].expand(B, kept.shape[0])
            x, _ = blk(x, mask=mask, generator=generator)
            if c.viz_mode and i in self.active_loc:
                features[i] = x
        if c.viz_mode and (c.depth - 1) not in features:
            features[c.depth - 1] = x
        out = self.classify(x)
        if c.viz_mode and not self.training:
            return out, {"Kept_Tokens_Abs": decisions, "Features": features}
        return out
