"""Grouped optimizer with the reference's 4-way param grouping
(counterpart of tokenreduction_tpu/train/optim.py:25-75, 335-388,
405-408; reference optim.py:39-100, 123-227).

Groups:
  new_param / new_param_no_decay : head, pos_embed, patch_embed + the
      model's `new_module_names()` -- full LR, never frozen
  decay / no_decay               : backbone -- LR x backbone_lr_scale,
      LR forced to 0 while epoch < backbone_freeze_steps
      (reference engine.py:35-37)
constant_cls / constant_pos / attn_only freeze params entirely
(label "frozen": no update).

Only AdamW is ported; the JAX package's other optimizers come with
``ROADMAP.md`` Queue 1 item 4b (the rest of the flags). The update equals
the JAX package's optax chain: ``clip_by_global_norm`` (g * max / |g|
only when |g| >= max; unlike ``torch.nn.utils.clip_grad_norm_`` nothing
is added to the norm), then per group ``optax.adamw`` (eps outside the
square root, bias corrections in fp32, decoupled decay scaled by the
learning rate, the learning rate of update t taken from schedule(t) with
t counted from 0). Params are the names of ``model.named_parameters()``;
the update works in place on the fp32 masters and the moments, and never
synchronises with the host: the learning rates and bias corrections are
host floats of the step count, the clip factor stays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    opt: str = "adamw"
    lr: float = 5e-4
    weight_decay: float = 0.05
    momentum: float = 0.9
    opt_eps: float = 1e-8
    opt_betas: Optional[tuple] = None
    clip_grad: Optional[float] = None
    backbone_lr_scale: float = 1.0
    backbone_freeze_steps: int = 0  # epochs, despite the name (reference)
    constant_cls: bool = False
    constant_pos: bool = False
    # reference train.py:372-392 --attn-only: freeze every param except
    # the blocks' attention modules, the classifier head (head.weight /
    # head.bias only -- head_dist stays frozen), and pos_embed
    attn_only: bool = False


# where the refusals of what is not ported yet point
ITEM_4B = ('ROADMAP.md Queue 1 item 4b, "Full training loop and CLI": the '
           'rest of the flags')

BASE_NEW_NAMES = ["head", "head_dist", "pos_embed", "patch_embed"]
GROUPS = ("new_param", "new_param_no_decay", "decay", "no_decay")


def label_for_path(path: Sequence[str], param, new_names: List[str],
                   cfg: OptimConfig) -> str:
    name = ".".join(path)
    if cfg.constant_cls and ("cls_token" in name or "dist_token" in name):
        return "frozen"
    if cfg.constant_pos and "pos_embed" in name:
        return "frozen"
    if cfg.attn_only and ".attn." not in name \
            and not name.startswith("head.") and "pos_embed" not in name:
        return "frozen"
    is_new = any(n in name for n in new_names)
    no_decay = param.ndim <= 1 or path[-1] == "bias"
    if is_new:
        return "new_param_no_decay" if no_decay else "new_param"
    return "no_decay" if no_decay else "decay"


def param_labels(params: Mapping[str, torch.Tensor],
                 new_module_names: List[str], cfg: OptimConfig):
    """{param name: group label}."""
    new_names = BASE_NEW_NAMES + list(new_module_names)
    return {name: label_for_path(tuple(name.split(".")), p, new_names, cfg)
            for name, p in params.items()}


def group_lr_fn(base_schedule: Callable[[int], float], scale: float,
                freeze_epochs: int, steps_per_epoch: int):
    """Per-group LR as a function of the optimizer step counter."""

    def lr(step: int) -> float:
        t = base_schedule(step)
        if freeze_epochs > 0 and step // max(steps_per_epoch, 1) < \
                freeze_epochs:
            t = 0.0
        return t * scale

    return lr


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over every element of every tensor, on the
    device."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(list(tensors))))


@dataclasses.dataclass
class GroupedAdamW:
    """clip_by_global_norm, then AdamW per group with its own learning
    rate and weight decay; "frozen" params get no update."""

    labels: dict
    lr_fns: dict  # group -> step -> lr
    weight_decay: dict  # group -> decay
    b1: float
    b2: float
    eps: float
    clip_grad: Optional[float]

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        live = [n for n in params if self.labels[n] != "frozen"]
        return {"mu": {n: torch.zeros_like(params[n]) for n in live},
                "nu": {n: torch.zeros_like(params[n]) for n in live}}

    @torch.no_grad()
    def update(self, params, grads, state, count: int,
               grad_norm: Optional[torch.Tensor] = None):
        """Apply update number ``count`` (0 for the first) in place on
        params and state. grad_norm: the global norm of grads, if the
        caller has it."""
        names = [n for n in params if self.labels[n] != "frozen"]
        g = [grads[n] for n in names]
        if self.clip_grad is not None:
            if grad_norm is None:
                grad_norm = global_norm(grads.values())
            factor = torch.where(grad_norm < self.clip_grad,
                                 torch.ones_like(grad_norm),
                                 self.clip_grad / grad_norm)
            g = torch._foreach_mul(g, factor)
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1.0 - self.b2)
        # optax's bias corrections: 1 - b**t in fp32
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count + 1))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count + 1))
        for group in GROUPS:
            idx = [i for i, n in enumerate(names) if self.labels[n] == group]
            if not idx:
                continue
            p = [params[names[i]] for i in idx]
            den = torch._foreach_div([nu[i] for i in idx], bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div([mu[i] for i in idx], bc1)
            torch._foreach_div_(u, den)
            wd = self.weight_decay[group]
            if wd:
                torch._foreach_add_(u, p, alpha=wd)
            torch._foreach_add_(p, u, alpha=-self.lr_fns[group](count))


def create_optimizer(params: Mapping[str, torch.Tensor], cfg: OptimConfig,
                     base_schedule: Callable[[int], float],
                     new_module_names: List[str], steps_per_epoch: int = 1):
    """(optimizer, labels). `base_schedule` maps optimizer step -> lr
    (see train/scheduler.py)."""
    if cfg.opt.lower() != "adamw":
        raise NotImplementedError(
            f"optimizer {cfg.opt!r} is not ported yet; AdamW is "
            f"({ITEM_4B})")
    labels = param_labels(params, new_module_names, cfg)
    b1, b2 = cfg.opt_betas or (0.9, 0.999)
    full = group_lr_fn(base_schedule, 1.0, 0, steps_per_epoch)
    backbone = group_lr_fn(base_schedule, cfg.backbone_lr_scale,
                           cfg.backbone_freeze_steps, steps_per_epoch)
    clip = cfg.clip_grad if cfg.clip_grad is not None and cfg.clip_grad > 0 \
        else None
    opt = GroupedAdamW(
        labels=labels,
        lr_fns={"new_param": full, "new_param_no_decay": full,
                "decay": backbone, "no_decay": backbone},
        weight_decay={"new_param": cfg.weight_decay, "decay": cfg.weight_decay,
                      "new_param_no_decay": 0.0, "no_decay": 0.0},
        b1=b1, b2=b2, eps=cfg.opt_eps, clip_grad=clip)
    return opt, labels


@torch.no_grad()
def project_params(params: Mapping[str, torch.Tensor]):
    """The projection the reference makes inside its forward
    (models/sinkhorn.py:73-76), after the update and in place (JAX
    train/optim.py:391-402): every Sinkhorn cluster vector
    ``cluster_layers.{k}.v`` renormalised onto the unit sphere."""
    for name, p in params.items():
        if name.split(".")[-1] == "v" and "cluster_layers" in name:
            p.div_(torch.linalg.vector_norm(p, dim=-1, keepdim=True))


@torch.no_grad()
def ema_update(ema_params, params, decay: float):
    """ModelEmaV2 semantics (timm), in place: ema = decay*ema +
    (1-decay)*param."""
    ema = list(ema_params.values())
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [params[n] for n in ema_params], alpha=1.0 - decay)
