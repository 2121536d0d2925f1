"""The train and eval steps (counterpart of
tokenreduction_tpu/train/step.py:89-196 and :227-266).

One ``train_step`` call covers the augmentation on the card (``aug_fn``,
``data/device_aug.py``), mixup (once for the whole batch),
``grad_accum_steps`` microbatch forwards and backwards with the mean
loss, the global gradient norm (taken before clipping), the clipped
grouped update, with ``project_sinkhorn`` the
Sinkhorn cluster vectors renormalised (JAX step.py:179-180), and the EMA
of the fp32 params, with no host synchronisation inside: the metrics
stay on the device. With ``watch_norms`` the metrics add each top-level
module's param and gradient norms (JAX step.py:189-194); with
``hutchinson`` (AdaHessian) each microbatch also gives the Hutchinson
estimate of the Hessian diagonal, z * (H z) for a Rademacher probe z drawn
from the step's generator: a backward that records its graph, then
``autograd.grad(grads, params, grad_outputs=z)``, timm's route (JAX
step.py:75-85 takes the jvp of the gradient). The kernels'
``autograd.Function``s have no double backward, so a Hutchinson step pins
every block to the plain composition (``pin_plain_composition``), as
JAX's loop forces its XLA path.

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
    # wandb.watch equivalent (reference train.py:561): each top-level
    # module's param and gradient L2 norms in the metrics
    watch_norms: bool = False
    # AdaHessian: the Hutchinson diagonal a microbatch, handed to the
    # optimizer's update as hessian_diag
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


def module_of(name: str) -> str:
    """The Flax top-level module of a parameter name, the key of JAX's
    per-module norms: ``blocks.3.attn.qkv.weight`` -> ``blocks_3``,
    ``patch_embed.proj.bias`` -> ``patch_embed``, ``cls_token`` ->
    ``cls_token``."""
    parts = name.split(".")
    if len(parts) > 1 and parts[1].isdigit():
        return f"{parts[0]}_{parts[1]}"
    return parts[0]


@torch.no_grad()
def watch_metrics(params: dict, grads: dict) -> dict:
    """{"param_norm/<module>", "grad_norm/<module>"}: the L2 norms of each
    top-level module's params and gradients, device scalars."""
    groups = {}
    for n in params:
        groups.setdefault(module_of(n), []).append(n)
    out = {}
    for key, names in groups.items():
        out[f"param_norm/{key}"] = global_norm(params[n] for n in names)
        out[f"grad_norm/{key}"] = global_norm(grads[n] for n in names)
    return out


def pin_plain_composition(model: torch.nn.Module):
    """Pin every block of ``model`` to the plain composition (the
    ``force_plain`` route of ``core/layers.py``): no kernel runs, so
    autograd can differentiate the backward again."""
    for m in model.modules():
        if hasattr(m, "force_plain"):
            m.force_plain = True


def rademacher_like(params: dict, generator: torch.Generator) -> dict:
    """One +-1 fp32 probe a param, drawn from ``generator``."""
    return {n: torch.randint(0, 2, p.shape, generator=generator,
                             device=p.device).to(torch.float32) * 2 - 1
            for n, p in params.items()}


def hutchinson_grads_and_diag(model: torch.nn.Module, loss_fn: Callable,
                              params: dict, images: torch.Tensor,
                              targets: torch.Tensor, cfg: StepConfig,
                              z: dict,
                              generator: Optional[torch.Generator] = None):
    """(fp32 loss, {name: gradient}, {name: z * (H z)}) of one microbatch
    for the probe z ({name: +-1 tensor}): the backward keeps its graph,
    and a second backward of the gradients along z gives H z (JAX
    ``hutchinson_grads_and_diag``)."""
    names = list(params)
    with torch.enable_grad():
        p = ({n: t.to(torch.bfloat16) for n, t in params.items()}
             if cfg.amp else params)
        x = images.to(torch.bfloat16) if cfg.amp else images
        out = functional_call(model, p, (x,), {"generator": generator})
        loss = loss_fn(out, targets, images, params).float()
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    create_graph=True)
        live = [i for i, g in enumerate(grads) if g.requires_grad]
        hz = torch.autograd.grad(
            [grads[i] for i in live], [params[n] for n in names],
            grad_outputs=[z[names[i]] for i in live], allow_unused=True,
            materialize_grads=True)
    diag = {n: z[n] * h.detach() for n, h in zip(names, hz)}
    return loss.detach(), {n: g.detach() for n, g in zip(names, grads)}, \
        diag


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
    mixup_fn(images, labels) -> (images, targets): applied once to the
      whole batch before the microbatch split (JAX step.py:125-127), e.g.
      ``train/mixup.py::make_mixup_fn``
    aug_fn(uint8 images, generator) -> fp32 NCHW images: the augmentation
      on the card (``data/device_aug.py::make_device_augment``), ahead of
      mixup (JAX step.py:121-124), drawing from ``generator``
    Batch: dict(image=[A*M, C, H, W], label=[A*M, ...]) where A =
    grad_accum_steps (with aug_fn, image is the uint8 [A*M, S, S, 3]);
    microbatches are the leading-axis splits.
    Metrics: {"loss", "grad_norm"} as device scalars, with
    ``watch_norms`` also "param_norm/<module>" and "grad_norm/<module>"."""
    accum = cfg.grad_accum_steps
    if cfg.hutchinson:
        if generator is None:
            raise ValueError("the Hutchinson probe draws from an explicit "
                             "torch.Generator: pass generator=")
        pin_plain_composition(model)

    def train_step(state: TrainState, batch):
        model.train(cfg.train_mode)
        images, labels = batch["image"], batch["label"]
        if aug_fn is not None:
            images = aug_fn(images, generator)
        if mixup_fn is not None:
            images, labels = mixup_fn(images, labels)
        micro = images.shape[0] // accum
        grads, loss_sum, hdiag = None, None, None
        for i in range(accum):
            rows = slice(i * micro, (i + 1) * micro)
            if cfg.hutchinson:
                z = rademacher_like(state.params, generator)
                loss, g, h = hutchinson_grads_and_diag(
                    model, loss_fn, state.params, images[rows],
                    labels[rows], cfg, z, generator)
                hdiag = h if hdiag is None else \
                    {n: hdiag[n] + h[n] for n in h}
            else:
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
        extra = ({"hessian_diag": {n: h / accum for n, h in hdiag.items()}}
                 if cfg.hutchinson else {})
        optimizer.update(state.params, grads, state.opt_state, state.step,
                         grad_norm, **extra)
        if cfg.project_sinkhorn:
            project_params(state.params)
        if cfg.ema_decay > 0 and state.ema_params is not None:
            ema_update(state.ema_params, state.params, cfg.ema_decay)
        state = dataclasses.replace(state, step=state.step + 1)
        metrics = {"loss": loss_sum / accum, "grad_norm": grad_norm}
        if cfg.watch_norms:
            metrics.update(watch_metrics(state.params, grads))
        return state, metrics

    return train_step


def make_eval_step(model: torch.nn.Module, multilabel: bool = False,
                   generator: Optional[torch.Generator] = None,
                   transform_fn: Optional[Callable] = None):
    """``eval_step(params, batch)``: the model in eval mode over ``params``
    ({name: tensor}, the fp32 masters or the EMA) on batch["image"] (NCHW),
    under ``torch.no_grad()`` and in fp32 whatever the training precision,
    as JAX's eval step runs its params (JAX step.py:227-266).

    Multiclass: {"correct1", "correct5", "loss_sum", "count"}, the
    weighted sums of correct top-1 and top-5 and of the cross-entropy,
    and the weight; batch["weight"] (1 a real row, 0 a loader pad;
    default all 1) masks the pads. Multilabel: (sigmoid probabilities,
    batch["label"]) for the host's mAP. Every result stays on the device:
    no host synchronisation. ``generator`` goes to the forward (None, as
    JAX's eval passes no RNG, but for a model whose eval draws, such as
    equal-weight k-medoids' first medoid). ``transform_fn``: the eval
    transform on the card (uint8 squares -> normalised NCHW,
    ``data/device_aug.py::make_device_eval_transform``), applied to
    batch["image"] first (JAX step.py:228-241)."""

    def eval_step(params, batch):
        model.eval()
        with torch.no_grad():
            images = batch["image"]
            if transform_fn is not None:
                images = transform_fn(images)
            out = functional_call(model, params, (images,),
                                  {"generator": generator})
        logits = (out[0] if isinstance(out, tuple) else out).float()
        labels = batch["label"]
        if multilabel:
            return torch.sigmoid(logits), labels
        w = batch.get("weight")
        if w is None:
            w = torch.ones(labels.shape, dtype=torch.float32,
                           device=logits.device)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -(logp.gather(-1, labels[:, None].long())[:, 0] * w).sum()
        top5 = torch.topk(logits, min(5, logits.shape[-1]), dim=-1).indices
        hit = top5 == labels[:, None]
        return {"correct1": (hit[:, 0] * w).sum(),
                "correct5": (hit.any(dim=-1) * w).sum(),
                "loss_sum": loss, "count": w.sum()}

    return eval_step
