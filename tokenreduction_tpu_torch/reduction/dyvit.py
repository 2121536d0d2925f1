"""DynamicViT: learned token pruning (reference models/dyvit.py).

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

Training (JAX ``reduction/dyvit.py:74-146``) keeps every block at 197
tokens and prunes through a mask: at each reduction block the predictor
scores the patches, a straight-through hard Gumbel-softmax draws each
patch's keep decision (column 0), times the previous decision, and the
policy ``[1 for CLS; decision]`` goes to every block from there on (ones
before the first reduction). Under a policy the attention halves run
``Attention``'s policy softmax (plain PyTorch, as XLA computes it in
JAX) and the MLP halves ``mlp_branch``. The Gumbel uniforms come from the
forward's ``generator``, the generator of dropout and drop path; training
without one raises. The forward returns ``(logits, the [B, N] decision
of each stage)`` or, built with ``dyvit_distillation``, ``(logits,
post-norm patch tokens, the last decision [B, N, 1] (no gradient), the
decisions)`` for ``train/losses.py::dyvit_distillation_loss``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tokenreduction_tpu_torch.core.config import expand_keep_rate
from tokenreduction_tpu_torch.models.deit import ViTBase
from tokenreduction_tpu_torch.ops import dyvit as dyvit_ops
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
    def __init__(self, cfg, *, dyvit_distillation: bool = False, **kwargs):
        if cfg.distilled:
            # as the JAX registry refuses it: the reference's DyViT
            # forward never handles the dist token (models/dyvit.py:205-214)
            raise ValueError(
                "dyvit does not support the DeiT-distilled backbone (the "
                "reference's forward never handles the dist token, "
                "models/dyvit.py:205-214)")
        super().__init__(cfg, **kwargs)
        self.dyvit_distillation = dyvit_distillation

    @staticmethod
    def new_module_names():
        return ["score_predictor"]  # reference dyvit.py:194-195

    def make_modules(self):
        self.token_ratio = expand_keep_rate(self.cfg)
        self.score_predictor = nn.ModuleList(
            PredictorLG(self.cfg.embed_dim)
            for _ in self.cfg.reduction_loc)

    def reduction_count(self):
        return list(self.cfg.reduction_loc)

    def forward(self, x, generator: torch.Generator | None = None):
        """In eval the logits; with ``cfg.viz_mode`` also {"Kept_Tokens":
        {block: [B, K] patch ids local to the block's input, in descending
        score order}, "Features": {block: tokens after it}}. In training
        see ``forward_train``."""
        if self.training:
            return self.forward_train(x, generator)
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

    def forward_train(self, x, generator: torch.Generator | None):
        """The masked training forward (see the module docstring); the
        Gumbel uniforms, the dropout and the drop-path masks from
        ``generator``."""
        if generator is None:
            raise ValueError(
                "DyViT in training draws its Gumbel noise from an explicit "
                "torch.Generator: pass generator= to the model's forward")
        c = self.cfg
        x = self.embed(x, generator)
        B = x.shape[0]
        ones = dict(dtype=x.dtype, device=x.device)
        prev_decision = torch.ones(B, c.num_patches, 1, **ones)
        policy = torch.ones(B, c.num_patches + 1, 1, **ones)
        out_pred_prob = []
        stage = 0
        for i, blk in enumerate(self.blocks):
            if i in c.reduction_loc:
                score = self.score_predictor[stage](x[:, 1:], prev_decision)
                hard = dyvit_ops.gumbel_softmax_hard(score, generator)
                prev_decision = hard[:, :, 0:1] * prev_decision
                out_pred_prob.append(prev_decision.reshape(B, -1))
                policy = torch.cat([torch.ones(B, 1, 1, **ones),
                                    prev_decision], dim=1)
                stage += 1
            x, _ = blk(x, policy=policy, generator=generator)
        x = self.norm(x)
        logits = self.head(x[:, 0])
        if self.dyvit_distillation:
            return logits, x[:, 1:], prev_decision.detach(), out_pred_prob
        return logits, out_pred_prob
