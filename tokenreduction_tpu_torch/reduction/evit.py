"""EViT: CLS-attention top-k pruning and one fused "inattentive" token
(reference models/evit.py).

Counterpart of ``tokenreduction_tpu/reduction/evit.py``. Like top-k, but
the patches that are not kept are fused into one extra token, their sum
weighted by their CLS attention (reference evit.py:116-121): an fp32
product of the CLS row with the patch rows, cast to x's dtype and
appended as row N. The MLP half then gathers CLS, the kept patches and
that row. At keep 0.7 on DeiT-S the widths go 197 -> 139 -> 98 -> 69.

In eval the reduction block is one ``fused_block_attention`` call (its
CLS row the score) and one ``fused_mlp_gather_residual`` over the N + 1
rows; every other block is one ``fused_full_block``. In training the
fused token's gradient reaches the attention branch through the CLS row
(``attend_branch_train``'s row0 cotangent).

Viz mode records ``Kept_Tokens`` (the kept patch ids in descending score
order, then the ``-1`` sentinel of the fused token, reference
evit.py:123; the viz pipeline reads it, validate.py:213-216) and
``Fusion_Assign`` (the sorted ids of the fused patches).
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.core.config import reduction_schedule
from tokenreduction_tpu_torch.models.deit import ViTBase
from tokenreduction_tpu_torch.ops.gather import complement_idx


class EViTVisionTransformer(ViTBase):
    def __init__(self, cfg, **kwargs):
        super().__init__(cfg, **kwargs)
        self.schedule = reduction_schedule(cfg)

    def forward(self, x, generator: torch.Generator | None = None):
        """Logits; in eval with ``cfg.viz_mode`` also {"Kept_Tokens":
        {block: [B, k + 1]}, "Fusion_Assign": {block: [B, N - 1 - k]},
        "Features": {block: tokens after it}}. ``generator``: the
        stochastic-depth masks' generator in training."""
        c = self.cfg
        x = self.embed(x, generator)
        decisions, fusion, features = {}, {}, {}
        for i, blk in enumerate(self.blocks):
            if i in c.reduction_loc:
                left = self.schedule[c.reduction_loc.index(i)]
                x, (cls_attn, _) = blk.attend(x, score="cls",
                                              generator=generator)
                N = x.shape[1]
                if left < N - 1:
                    idx = torch.topk(cls_attn, left, dim=1, sorted=True)[1]
                    # the fused token: the patches' sum weighted by the
                    # CLS attention of those not kept
                    keep = torch.zeros_like(cls_attn).scatter(1, idx, 1.0)
                    weights = cls_attn * (1.0 - keep)
                    extra = torch.einsum("bn,bnd->bd", weights,
                                         x[:, 1:].to(weights.dtype))
                    x_ext = torch.cat([x, extra[:, None].to(x.dtype)], dim=1)
                    # CLS, the kept patches past it, the fused row N
                    full = torch.cat([torch.zeros_like(idx[:, :1]), idx + 1,
                                      torch.full_like(idx[:, :1], N)], dim=1)
                    if c.viz_mode:
                        decisions[i] = torch.cat(
                            [idx, torch.full_like(idx[:, :1], -1)], dim=1)
                        fusion[i] = complement_idx(idx, N - 1)
                    x = blk.ffn_gather(x_ext, full, generator)
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
            return out, {"Kept_Tokens": decisions, "Fusion_Assign": fusion,
                         "Features": features}
        return out
