"""The training loop's loss assembly (counterpart of
``tokenreduction_tpu/train/loop.py:76-149`` and the teacher wiring at
``:404-481``, ``:565-572`` there).

``build_base_criterion`` and ``build_loss_fn`` read the same argparse
fields as the JAX functions (``smoothing``, ``bce_loss``,
``ratio_weight``, ``cls_distill_weight``, ``token_distill_weight``,
``cls_weight``, ``mse_token``, ``dyvit_distill``, ``distillation_type``,
``distillation_alpha``, ``distillation_tau``) and build the same
``loss_fn(out, targets, images, params)``: DyViT's keep-ratio loss, with
``dyvit_distill`` its distillation against the dense teacher; DeiT's
distillation (soft or hard) against any teacher; else the base criterion
of the logits. ``make_teacher_apply`` runs a teacher as JAX's
``teacher_apply``: under ``torch.no_grad()``, in eval mode, in its own
fp32 parameters, on the images the step was given before any amp cast.
The rest of the loop (data, schedule, checkpoints, the CLI) is still to
be ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from tokenreduction_tpu_torch.core.config import expand_keep_rate
from tokenreduction_tpu_torch.train import losses as L


def build_base_criterion(args, multilabel: bool, mixup_on: bool):
    if multilabel:
        def crit(logits, targets):
            return L.asymmetric_multilabel_loss(logits.float(), targets)
        return crit
    if mixup_on:
        return L.soft_target_ce
    if getattr(args, "bce_loss", False):
        def bce(logits, targets):
            onehot = F.one_hot(targets, logits.shape[-1]).float()
            return L.bce_with_logits(logits, onehot)
        return bce
    if getattr(args, "smoothing", 0.0):
        def smooth(logits, targets):
            return L.label_smoothing_ce(logits, targets, args.smoothing)
        return smooth
    return L.cross_entropy


def make_teacher_apply(teacher: torch.nn.Module) -> Callable:
    """``teacher_apply(images)``: the teacher's output on the uncast images,
    with no gradient and in eval mode. The teacher keeps its own fp32
    parameters (it is not the state the step casts under amp)."""
    teacher.eval()

    def teacher_apply(images):
        with torch.no_grad():
            return teacher(images)

    return teacher_apply


def build_loss_fn(args, model_cfg, base_crit,
                  teacher_apply: Optional[Callable] = None):
    """The final ``loss(out, targets, images, params)`` with the
    distillation wrappers (reference train.py:507-513). ``images`` are
    the step's images before its amp cast, which the teacher reads.
    Refuses ``train_mode=False`` (--no-train-mode) with DyViT or with DeiT
    distillation: the eval forward returns bare (or dist-averaged)
    logits, and these losses need the training outputs (JAX
    train/loop.py:565-572; the reference fails the same way, train.py:599
    with losses.py:31, :90)."""
    method = model_cfg.method
    dyvit_distill = bool(getattr(args, "dyvit_distill", False)) and \
        method == "dyvit"
    deit_type = getattr(args, "distillation_type", "none")
    if not getattr(args, "train_mode", True) and (
            method == "dyvit" or deit_type != "none"):
        raise ValueError("--no-train-mode is incompatible with dyvit "
                         "and with --distillation-type != none")

    if method == "dyvit":
        keep_rate = expand_keep_rate(model_cfg)

        def dyvit_loss(out, targets, images, params):
            if dyvit_distill:
                logits, feats, mask, scores = out
                tcls, ttok = (teacher_apply(images)
                              if teacher_apply else (None, None))
                return L.dyvit_distillation_loss(
                    base_crit(logits, targets), logits, feats, mask, scores,
                    keep_rate, tcls, ttok,
                    ratio_weight=args.ratio_weight,
                    cls_distill_weight=args.cls_distill_weight,
                    token_distill_weight=args.token_distill_weight,
                    cls_weight=args.cls_weight, mse_token=args.mse_token)
            logits, scores = out
            ratio = 0.0
            for i, s in enumerate(scores):
                ratio = ratio + torch.mean((s.mean(dim=1) - keep_rate[i]) ** 2)
            return base_crit(logits, targets) + \
                (ratio / max(len(scores), 1)) * args.ratio_weight

        return dyvit_loss

    if deit_type != "none" and teacher_apply is not None:

        def deit_loss(out, targets, images, params):
            logits, logits_kd = out if isinstance(out, tuple) else (out, out)
            tlogits = teacher_apply(images)
            if isinstance(tlogits, tuple):
                tlogits = tlogits[0]
            return L.deit_distillation_loss(
                base_crit(logits, targets), logits_kd, tlogits, deit_type,
                args.distillation_alpha, args.distillation_tau)

        return deit_loss

    def loss_fn(out, targets, images, params):
        logits = out[0] if isinstance(out, tuple) else out
        return base_crit(logits, targets)

    return loss_fn
