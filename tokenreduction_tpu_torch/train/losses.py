"""Training losses (counterpart of tokenreduction_tpu/train/losses.py).

Pure functions of (logits, targets, ...) -> scalar, computed in the
logits' dtype as the JAX functions are (the train step passes bf16 logits
under amp and casts the loss to fp32; a teacher's fp32 outputs promote a
distillation term to fp32 on both sides). Beside the base criteria: DeiT's
distillation loss (reference losses.py:4-69) and DynamicViT's (reference
losses.py:72-158), the teachers' forwards run outside them.
"""

from __future__ import annotations

from typing import Optional

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


def kl_div_log_target(student_logp, teacher_logp, avg: str = "batchmean"):
    """F.kl_div(student_logp, teacher_logp, log_target=True) semantics,
    written out as the JAX function does."""
    pointwise = torch.exp(teacher_logp) * (teacher_logp - student_logp)
    if avg == "batchmean":
        return pointwise.sum() / student_logp.shape[0]
    return pointwise.mean()


def deit_distillation_loss(base_loss, student_kd_logits, teacher_logits,
                           distillation_type: str, alpha: float, tau: float):
    """reference losses.py:21-69: ``none`` the base loss; ``soft`` the
    tau-softened KL times tau^2; ``hard`` the CE against the teacher's
    argmax; each blended as base * (1 - alpha) + distillation * alpha."""
    if distillation_type == "none":
        return base_loss
    if distillation_type == "soft":
        T = tau
        d = kl_div_log_target(F.log_softmax(student_kd_logits / T, dim=1),
                              F.log_softmax(teacher_logits / T, dim=1)) \
            * (T * T)
    elif distillation_type == "hard":
        d = cross_entropy(student_kd_logits, teacher_logits.argmax(dim=1))
    else:
        raise ValueError(distillation_type)
    return base_loss * (1.0 - alpha) + d * alpha


def dyvit_distillation_loss(base_loss, pred, token_pred, mask,
                            out_pred_score, keep_rate,
                            teacher_cls: Optional[torch.Tensor],
                            teacher_tokens: Optional[torch.Tensor], *,
                            ratio_weight: float = 2.0,
                            cls_distill_weight: float = 0.5,
                            token_distill_weight: float = 0.5,
                            cls_weight: float = 1.0, mse_token: bool = False):
    """reference losses.py:90-158: the weighted base loss, the keep-ratio
    loss over the stages' decisions, and with a teacher the CLS KL and the
    token loss (KL or, with ``mse_token``, MSE) over the patches the last
    decision keeps (mask [B, N, 1] > 0.5, divided by max(count, 1); zero
    when mask.sum() < 0.1)."""
    loss = base_loss * cls_weight
    pred_loss = 0.0
    for i, score in enumerate(out_pred_score):
        pred_loss = pred_loss + torch.mean(
            (score.mean(dim=1) - keep_rate[i]) ** 2)
    loss = loss + pred_loss / len(out_pred_score) * ratio_weight
    if teacher_cls is None:
        return loss
    cls_kl = kl_div_log_target(F.log_softmax(pred, dim=-1),
                               F.log_softmax(teacher_cls, dim=-1))
    loss = loss + cls_distill_weight * cls_kl
    B, N, C = token_pred.shape
    m = mask.reshape(B * N) > 0.5
    tp = token_pred.reshape(B * N, C)
    tt = teacher_tokens.reshape(B * N, C)
    denom = m.sum().clamp(min=1)
    if mse_token:
        token_loss = (((tp - tt) ** 2).mean(dim=-1) * m).sum() / denom
    else:
        t_logp = F.log_softmax(tt, dim=-1)
        s_logp = F.log_softmax(tp, dim=-1)
        pointwise = (torch.exp(t_logp) * (t_logp - s_logp)).sum(dim=-1)
        token_loss = (pointwise * m).sum() / denom
    # the reference's guard: no kept token, no token loss
    token_loss = torch.where(mask.sum() < 0.1,
                             torch.zeros_like(token_loss), token_loss)
    return loss + token_distill_weight * token_loss
