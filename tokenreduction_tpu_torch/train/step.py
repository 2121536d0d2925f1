"""The train step (counterpart of tokenreduction_tpu/train/step.py:89-196).

One ``train_step`` call covers ``grad_accum_steps`` microbatch forwards
and backwards with the mean loss, the global gradient norm (taken before
clipping), the clipped grouped update, with ``project_sinkhorn`` the
Sinkhorn cluster vectors renormalised (JAX step.py:179-180), and the EMA
of the fp32 params, with no host synchronisation inside: the metrics
stay on the device.

AMP is the JAX recipe, not ``torch.autocast``: every fp32 master is cast
to bf16 and so are the images (JAX step.py:114-115), and the model runs
through ``torch.func.functional_call`` over those bf16 copies. Autograd
through ``.to(bfloat16)`` delivers fp32 gradients to the masters, as the
JAX VJP of ``astype`` does; the training kernels' weight gradients are
bf16 before that cast. The loss is computed from the bf16 logits and
returned in fp32. No loss scaling: bf16 has fp32's exponent range.

The state keeps the fp32 masters as {parameter name: tensor}, the names
of ``model.named_parameters()``. JAX's arrays are immutable; here the
step updates the masters, the optimizer moments and the EMA in place,
which saves one copy of each, and returns the state with its step
counted up.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import functional_call

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.train.optim import (
    ema_update,
    global_norm,
    project_params,
)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    grad_accum_steps: int = 1
    ema_decay: float = 0.0  # 0 = disabled
    amp: bool = False  # bf16 forward over bf16 copies of the fp32 masters
    # reference --no-train-mode (train.py:111-113): run the training
    # forward with the model in eval mode
    train_mode: bool = True
    # Sinkhorn's cluster vectors back onto the unit sphere after each
    # update (train/optim.py project_params)
    project_sinkhorn: bool = False
    watch_norms: bool = False
    hutchinson: bool = False


@dataclasses.dataclass
class TrainState:
    step: int  # updates done; the host counts it
    params: dict  # {name: fp32 master}
    opt_state: dict
    ema_params: Optional[dict] = None


def init_train_state(model: torch.nn.Module, optimizer, *, ema: bool = False,
                     device=None) -> TrainState:
    """fp32 masters copied from the model's parameters onto ``device``
    (the card unless the caller passes ``device="cpu"``), the optimizer's
    moments and, with ``ema``, a copy of the masters."""
    device = resolve_device(device)
    params = {n: p.detach().to(device=device, dtype=torch.float32).clone()
              .requires_grad_(True) for n, p in model.named_parameters()}
    ema_params = ({n: p.detach().clone() for n, p in params.items()}
                  if ema else None)
    return TrainState(0, params, optimizer.init(params), ema_params)


def loss_and_grads(model: torch.nn.Module, loss_fn: Callable, params: dict,
                   images: torch.Tensor, targets: torch.Tensor,
                   cfg: StepConfig,
                   generator: Optional[torch.Generator] = None):
    """(fp32 loss, {name: fp32 gradient}) of one microbatch, the model run
    over ``params`` (bf16 copies of them under amp)."""
    with torch.enable_grad():
        p = ({n: t.to(torch.bfloat16) for n, t in params.items()}
             if cfg.amp else params)
        x = images.to(torch.bfloat16) if cfg.amp else images
        out = functional_call(model, p, (x,), {"generator": generator})
        loss = loss_fn(out, targets, images, params).float()
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def make_train_step(model: torch.nn.Module, loss_fn: Callable, optimizer,
                    cfg: StepConfig,
                    generator: Optional[torch.Generator] = None,
                    mixup_fn: Optional[Callable] = None,
                    aug_fn: Optional[Callable] = None):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    loss_fn(output, targets, images, params) -> scalar loss; output is
      the model's, a tuple for DyViT and a distilled DeiT, and images are
      the microbatch before the amp cast (a teacher's input)
    generator: the generator of the drop-path and dropout masks and of
      DyViT's Gumbel draw, on the model's device (needed when a rate is
      above 0, and for DyViT)
    Batch: dict(image=[A*M, C, H, W], label=[A*M, ...]) where A =
    grad_accum_steps; microbatches are the leading-axis splits.
    Metrics: {"loss", "grad_norm"} as device scalars."""
    loop = '(ROADMAP Queue 1, "Full training loop and CLI")'
    if cfg.hutchinson:
        raise NotImplementedError(
            f"hutchinson (adahessian) comes with the optimizers {loop}")
    if cfg.watch_norms:
        raise NotImplementedError(f"watch_norms comes with the train loop "
                                  f"{loop}")
    if mixup_fn is not None or aug_fn is not None:
        raise NotImplementedError(
            f"mixup_fn and aug_fn come with the train loop and the device "
            f"augmentation {loop}")
    accum = cfg.grad_accum_steps

    def train_step(state: TrainState, batch):
        model.train(cfg.train_mode)
        images, labels = batch["image"], batch["label"]
        micro = images.shape[0] // accum
        grads, loss_sum = None, None
        for i in range(accum):
            rows = slice(i * micro, (i + 1) * micro)
            loss, g = loss_and_grads(model, loss_fn, state.params,
                                     images[rows], labels[rows], cfg,
                                     generator)
            if grads is None:
                grads, loss_sum = g, loss
            else:
                for n in grads:
                    grads[n] = grads[n] + g[n]
                loss_sum = loss_sum + loss
        grads = {n: g / accum for n, g in grads.items()}
        grad_norm = global_norm(grads.values())
        optimizer.update(state.params, grads, state.opt_state, state.step,
                         grad_norm)
        if cfg.project_sinkhorn:
            project_params(state.params)
        if cfg.ema_decay > 0 and state.ema_params is not None:
            ema_update(state.ema_params, state.params, cfg.ema_decay)
        state = dataclasses.replace(state, step=state.step + 1)
        return state, {"loss": loss_sum / accum, "grad_norm": grad_norm}

    return train_step
