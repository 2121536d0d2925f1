"""DynamicViT: learned token pruning (reference models/dyvit.py), eval.

Counterpart of ``tokenreduction_tpu/reduction/dyvit.py``. At each
reduction block a small predictor (``PredictorLG``) scores the patch
tokens; the ``int(N * keep_rate^(s+1))`` best by their keep
log-probability survive (stable descending order: ties keep the lower
id, as ``jnp.argsort``), and the block runs on them alone. At keep 0.7 on
DeiT-S that is 137, 96, 67 patches, widths 197 -> 138 -> 97 -> 68.

In eval the reduction block is one ``fused_block_attention`` call with
the kept ids as its idx prologue (the LayerNorm reads the kept rows and
the out projection adds them back, the block at width K) and one
``fused_mlp_residual``; every other block is one ``fused_full_block``.
The predictors are plain PyTorch (the JAX package leaves them to XLA).
The kept counts are Python ints, so nothing waits for the card.

Training (the Gumbel draw, the policy softmax, the teacher and the
4-term loss) raises ``NotImplementedError`` until it is ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tokenreduction_tpu_torch.core.config import expand_keep_rate
from tokenreduction_tpu_torch.models.deit import ViTBase
from tokenreduction_tpu_torch.ops.gather import take_tokens


class PredictorLG(nn.Module):
    """Local/global score predictor (reference dyvit.py:91-119): [B, N, C]
    tokens and the policy [B, N, 1] -> [B, N, 2] log-probabilities (keep,
    drop). Its LayerNorm has eps 1e-5 (not the blocks' 1e-6), its GELUs
    are exact (erf), and eps is added to the quotient, the reference's
    operator-precedence quirk (dyvit.py:117), kept for parity."""

    def __init__(self, embed_dim: int, eps: float = 1e-6):
        super().__init__()
        C = embed_dim
        self.eps = eps
        self.in_ln = nn.LayerNorm(C, eps=1e-5)
        self.in_fc = nn.Linear(C, C)
        self.out_fc1 = nn.Linear(C, C // 2)
        self.out_fc2 = nn.Linear(C // 2, C // 4)
        self.out_fc3 = nn.Linear(C // 4, 2)

    def forward(self, x, policy):
        B, N, C = x.shape
        x = F.gelu(self.in_fc(self.in_ln(x)))
        local_x = x[:, :, :C // 2]
        global_x = (x[:, :, C // 2:] * policy).sum(1, keepdim=True) \
            / policy.sum(1, keepdim=True) + self.eps
        x = torch.cat([local_x, global_x.expand(B, N, C // 2)], dim=-1)
        x = F.gelu(self.out_fc1(x))
        x = F.gelu(self.out_fc2(x))
        return F.log_softmax(self.out_fc3(x), dim=-1)


class DynamicVisionTransformer(ViTBase):
    def __init__(self, cfg, **kwargs):
        if cfg.distilled:
            # as the JAX registry refuses it: the reference's DyViT
            # forward never handles the dist token (models/dyvit.py:205-214)
            raise ValueError(
                "dyvit does not support the DeiT-distilled backbone (the "
                "reference's forward never handles the dist token, "
                "models/dyvit.py:205-214)")
        super().__init__(cfg, **kwargs)

    def make_modules(self):
        self.token_ratio = expand_keep_rate(self.cfg)
        self.score_predictor = nn.ModuleList(
            PredictorLG(self.cfg.embed_dim)
            for _ in self.cfg.reduction_loc)

    def reduction_count(self):
        return list(self.cfg.reduction_loc)

    def forward(self, x, generator: torch.Generator | None = None):
        """Logits; with ``cfg.viz_mode`` also {"Kept_Tokens": {block:
        [B, K] patch ids local to the block's input, in descending score
        order}, "Features": {block: tokens after it}}."""
        if self.training:
            raise NotImplementedError(
                "DyViT training (the Gumbel draw, the policy softmax, the "
                "teacher and the 4-term loss) is not ported yet (ROADMAP "
                "Queue 1, \"DyViT training and the teachers\")")
        c = self.cfg
        x = self.embed(x)
        B = x.shape[0]
        init_n = c.num_patches
        prev_decision = torch.ones(B, init_n, 1, dtype=x.dtype,
                                   device=x.device)
        decisions = {}
        features = {}
        stage = 0
        for i, blk in enumerate(self.blocks):
            if i not in c.reduction_loc:
                x, _ = blk(x)
                continue
            # the keep log-probability of each patch
            score = self.score_predictor[stage](x[:, 1:], prev_decision)
            num_keep = int(init_n * self.token_ratio[stage])
            keep_policy = torch.argsort(-score[..., 0], dim=1,
                                        stable=True)[:, :num_keep]
            # CLS first, then the kept patches shifted past it
            now_policy = torch.cat([torch.zeros_like(keep_policy[:, :1]),
                                    keep_policy + 1], dim=1)
            prev_decision = take_tokens(prev_decision, keep_policy)
            x, _ = blk.attend(x, idx=now_policy)
            x = blk.ffn(x)
            if c.viz_mode:
                decisions[i] = keep_policy
                features[i] = x
            stage += 1
        if c.viz_mode and (c.depth - 1) not in features:
            features[c.depth - 1] = x
        out = self.classify(x)
        if c.viz_mode:
            return out, {"Kept_Tokens": decisions, "Features": features}
        return out
