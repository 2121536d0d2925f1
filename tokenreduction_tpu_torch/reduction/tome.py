"""ToMe: bipartite soft-matching token merging (reference models/tome.py).

Counterpart of ``tokenreduction_tpu/reduction/tome.py``. Per block:
proportional attention, a per-key bias ``log(size)`` on the logits
(tome.py:48-49); at a merging block the head-mean keys as the metric
(tome.py:58), then the size-weighted average merge. The per-stage removal
counts come from the cumulative keep targets as in the reference
constructor (tome.py:145-156): at keep 0.7 on DeiT-S, r = 59, 41, 29 at
blocks 3, 6, 9 and widths 197 -> 138 -> 97 -> 68.

Every block runs ``Block.attend`` then ``Block.ffn``: in eval
``fused_block_attention`` (with the bias after the first merge, with the
keys at a merge) and ``fused_mlp_residual``; in training
``attend_branch_train`` before the first merge and the attention core
``attention_core_train`` after it, and ``mlp_branch``.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.core.config import reduction_schedule
from tokenreduction_tpu_torch.models.deit import ViTBase
from tokenreduction_tpu_torch.ops.tome import (
    bipartite_soft_matching,
    merge_source_assignment,
    merge_wavg,
)


def per_block_removals(cfg):
    """Cumulative keep counts -> tokens removed at each reduction block."""
    sched = reduction_schedule(cfg)
    removals = [0] * cfg.depth
    prev = cfg.num_patches
    for stage, loc in enumerate(cfg.reduction_loc):
        removals[loc] = prev - sched[stage]
        prev = sched[stage]
    return removals


class ToMeVisionTransformer(ViTBase):
    def __init__(self, cfg, **kwargs):
        super().__init__(cfg, **kwargs)
        self.removals = per_block_removals(cfg)

    def forward(self, x, generator: torch.Generator | None = None):
        """Logits; in eval with ``cfg.viz_mode`` also
        {"Assignment_Maps": {block: [B, T - 1] int32 merged-token ids of
        the pre-merge patch tokens}, "Features": {block: tokens after
        it}}. ``generator``: the stochastic-depth masks' generator in
        training."""
        c = self.cfg
        x = self.embed(x, generator)
        size = None
        assignments = {}
        features = {}
        for i, blk in enumerate(self.blocks):
            # proportional attention: + log(size) on the key columns
            bias = None if size is None else torch.log(size)[..., 0]
            r = self.removals[i]
            # the metric is only consumed where this block merges
            x, (metric, _) = blk.attend(x, bias=bias,
                                        score="keys" if r > 0 else None,
                                        generator=generator)
            if r > 0:
                info = bipartite_soft_matching(metric, r, class_token=True,
                                               distill_token=c.distilled)
                if c.viz_mode:
                    assignments[i] = merge_source_assignment(info)
                x, size = merge_wavg(info, x, size)
            x = blk.ffn(x, generator)
            if c.viz_mode and i in c.reduction_loc:
                features[i] = x
        if c.viz_mode and (c.depth - 1) not in features:
            features[c.depth - 1] = x
        out = self.classify(x)
        if c.viz_mode and not self.training:
            return out, {"Assignment_Maps": assignments, "Features": features}
        return out
