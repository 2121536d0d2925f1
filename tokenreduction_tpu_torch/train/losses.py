"""Training losses (counterpart of tokenreduction_tpu/train/losses.py:19-60).

Pure functions of (logits, targets) -> scalar, computed in the logits'
dtype as the JAX functions are (the train step passes bf16 logits under
amp and casts the loss to fp32). The distillation and DyViT losses come
with DyViT's training (ROADMAP Queue 1, "DyViT training and the
teachers").
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits, labels):
    """Plain CE with integer labels."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def label_smoothing_ce(logits, labels, smoothing: float = 0.1):
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def soft_target_ce(logits, target_probs):
    logp = F.log_softmax(logits, dim=-1)
    return (-(target_probs * logp).sum(dim=-1)).mean()


def bce_with_logits(logits, targets):
    return torch.mean(logits.clamp(min=0) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def asymmetric_multilabel_loss(logits, targets, gamma_neg: float = 4.0,
                               gamma_pos: float = 0.0, clip: float = 0.05,
                               eps: float = 1e-8):
    """ASL (Ben-Baruch et al.) as used for COCO/NUS (reference
    train.py:433-440); the focusing weight carries no gradient."""
    xs_pos = torch.sigmoid(logits)
    xs_neg = 1.0 - xs_pos
    if clip and clip > 0:
        xs_neg = (xs_neg + clip).clamp(max=1.0)
    los_pos = targets * torch.log(xs_pos.clamp(min=eps))
    los_neg = (1.0 - targets) * torch.log(xs_neg.clamp(min=eps))
    pt = xs_pos * targets + xs_neg * (1.0 - targets)
    gamma = gamma_pos * targets + gamma_neg * (1.0 - targets)
    w = ((1.0 - pt) ** gamma).detach()
    return -((los_pos + los_neg) * w).sum()
