"""LR schedules (reference scheduler_factory.py:10-97, timm semantics).

A copy of ``tokenreduction_tpu/train/scheduler.py`` without JAX: pure
functions step -> lr, evaluated on the host at each step (no device
synchronisation). ``sched_in_steps`` switches the time base from epochs
to optimizer steps exactly like the reference flag. lr noise raises
until ``ROADMAP.md`` Queue 1 item 4b brings it: the JAX version draws it
from ``jax.random``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    sched: str = "cosine"
    lr: float = 5e-4
    min_lr: float = 1e-5
    warmup_lr: float = 1e-6
    warmup_epochs: int = 5
    epochs: int = 300
    cooldown_epochs: int = 0
    decay_epochs: float = 30
    decay_rate: float = 0.1
    sched_in_steps: bool = False
    steps_per_epoch: int = 1
    # lr noise (reference scheduler_factory.py:13-22, 46-48): fractions of
    # the run at which multiplicative noise turns on ([start] or
    # [start, end)); noise ~ truncated normal, |noise| < lr_noise_pct
    lr_noise: Optional[Tuple[float, ...]] = None
    lr_noise_pct: float = 0.67
    lr_noise_std: float = 1.0
    seed: int = 42


def make_schedule(cfg: SchedConfig) -> Callable[[float], float]:
    """Returns lr(t) where t is the epoch (or step if sched_in_steps,
    pre-scaled by the caller via `t_of_step`)."""
    if cfg.lr_noise is not None:
        raise NotImplementedError(
            "lr_noise is not ported yet (ROADMAP.md Queue 1 item 4b, \"Full "
            "training loop and CLI\": the rest of the flags)")
    mult = cfg.steps_per_epoch if cfg.sched_in_steps else 1
    t_initial = (cfg.epochs - cfg.cooldown_epochs) * mult
    warmup_t = cfg.warmup_epochs * mult
    decay_t = cfg.decay_epochs * mult

    def cosine(t):
        if warmup_t and t < warmup_t:
            return cfg.warmup_lr + (cfg.lr - cfg.warmup_lr) * t / warmup_t
        tt = min(t - warmup_t, t_initial - warmup_t)
        span = max(t_initial - warmup_t, 1)
        return cfg.min_lr + 0.5 * (cfg.lr - cfg.min_lr) * (
            1 + math.cos(math.pi * tt / span)
        )

    def tanh(t):
        if warmup_t and t < warmup_t:
            return cfg.warmup_lr + (cfg.lr - cfg.warmup_lr) * t / warmup_t
        tt = min(t - warmup_t, t_initial - warmup_t)
        span = max(t_initial - warmup_t, 1)
        # timm TanhLRScheduler default bounds [-7, 3] -> [lb, ub]
        lb, ub = -7.0, 3.0
        frac = tt / span
        return cfg.min_lr + (cfg.lr - cfg.min_lr) * 0.5 * (
            1 - math.tanh(lb + (ub - lb) * frac)
        ) / (0.5 * (1 - math.tanh(lb)))

    def step(t):
        if warmup_t and t < warmup_t:
            return cfg.warmup_lr + (cfg.lr - cfg.warmup_lr) * t / warmup_t
        return cfg.lr * cfg.decay_rate ** ((t - warmup_t) // max(decay_t, 1))

    table = {"cosine": cosine, "tanh": tanh, "step": step,
             "constant": lambda t: cfg.lr,
             # plateau: constant base; the metric-driven decay is applied
             # host-side by the train loop (rebuilds the optimizer)
             "plateau": lambda t: cfg.lr}
    if cfg.sched not in table:
        raise ValueError(f"unknown sched {cfg.sched}")
    return table[cfg.sched]


def t_of_step(cfg: SchedConfig, total_step: int, epoch: int) -> float:
    """Reference behavior: per-step `step_update(total_step)` when
    sched_in_steps, else per-epoch `step(epoch)` (engine.py:108-109,
    train.py:606)."""
    return float(total_step) if cfg.sched_in_steps else float(epoch)
