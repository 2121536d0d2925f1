"""Top-K CLS-attention pruning (reference models/topk.py).

Counterpart of ``tokenreduction_tpu/reduction/topk.py``. The score is the
head-mean CLS->patch attention column, a by-product of the attention
kernel; the top-k survivors are gathered after the attention residual,
inside the MLP kernel. Widths shrink stage by stage (197 -> 138 -> 97 ->
68 at keep 0.7 on DeiT-S).
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.core.config import reduction_schedule
from tokenreduction_tpu_torch.models.deit import ViTBase


class TopKVisionTransformer(ViTBase):
    def __init__(self, cfg, **kwargs):
        super().__init__(cfg, **kwargs)
        self.schedule = reduction_schedule(cfg)

    def forward(self, x, generator: torch.Generator | None = None):
        """Logits; in eval with ``cfg.viz_mode`` also
        {"Kept_Tokens": {block: [B, k] patch-local ids in descending score
        order}, "Features": {block: tokens after it}}. ``generator``: the
        stochastic-depth masks' generator in training."""
        c = self.cfg
        x = self.embed(x, generator)
        decisions = {}
        features = {}
        for i, blk in enumerate(self.blocks):
            if i in c.reduction_loc:
                left = self.schedule[c.reduction_loc.index(i)]
                x, (cls_attn, _) = blk.attend(x, score="cls",
                                              generator=generator)
                if left < x.shape[1] - 1:
                    idx = torch.topk(cls_attn, left, dim=1, sorted=True)[1]
                    # one gather with CLS folded in: idx is over patch
                    # tokens, +1 shifts past CLS at position 0
                    full = torch.cat([torch.zeros_like(idx[:, :1]), idx + 1],
                                     dim=1)
                    if c.viz_mode:
                        decisions[i] = idx
                    x = blk.ffn_gather(x, full, generator)
                else:
                    x = blk.ffn(x, generator)
            else:
                x, _ = blk(x, generator=generator)
            if c.viz_mode and i in decisions:
                features[i] = x
        if c.viz_mode and (c.depth - 1) not in features:
            features[c.depth - 1] = x
        out = self.classify(x)
        if c.viz_mode and not self.training:
            return out, {"Kept_Tokens": decisions, "Features": features}
        return out
