"""LR schedules (reference scheduler_factory.py:10-97, timm semantics).

A copy of ``tokenreduction_tpu/train/scheduler.py`` without JAX: pure
functions step -> lr, evaluated on the host at each step (no device
synchronisation). ``sched_in_steps`` switches the time base from epochs
to optimizer steps exactly like the reference flag.

lr noise (``lr_noise_factor``) is JAX's: a factor 1 + a truncated normal
(|noise| < lr_noise_pct, scale lr_noise_std) on [start * T, end * T), or
from start * T with one value, one draw per (seed, floor t). JAX draws it
with ``jax.random``, which the port cannot reproduce; here it comes from a
CPU ``torch.Generator`` seeded from (seed, floor t): the draws differ,
their distribution is the same. The plateau schedule's base is constant;
the train loop applies its decay on the host (``train/loop.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch


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


def noise_seed(seed: int, ti: int) -> int:
    """The generator seed of the noise at floor(t) = ti."""
    return (int(seed) * 1_000_003 + int(ti)) % (2 ** 63)


@functools.lru_cache(maxsize=4096)
def _truncated_normal(seed: int, ti: int, bound: float) -> float:
    """One standard normal truncated to (-bound, bound), drawn by the
    inverse CDF from a CPU generator seeded from (seed, ti)."""
    out = torch.empty(1, dtype=torch.float32)
    torch.nn.init.trunc_normal_(
        out, 0.0, 1.0, -bound, bound,
        generator=torch.Generator().manual_seed(noise_seed(seed, ti)))
    return float(out[0])


def lr_noise_factor(cfg: SchedConfig, t) -> float:
    """The multiplicative (1 + noise) lr factor at schedule time t (JAX
    ``lr_noise_factor``): 1 outside the noise range, which is
    [start * T, end * T) for two fractions and t >= start * T for one,
    T the run's epochs (or steps with ``sched_in_steps``)."""
    if cfg.lr_noise is None:
        return 1.0
    mult = cfg.steps_per_epoch if cfg.sched_in_steps else 1
    rng = [float(n) * cfg.epochs * mult for n in cfg.lr_noise]
    ti = math.floor(np.float32(t))
    active = rng[0] <= ti < rng[1] if len(rng) >= 2 else ti >= rng[0]
    if not active:
        return 1.0
    std = max(cfg.lr_noise_std, 1e-12)
    noise = _truncated_normal(cfg.seed, ti, cfg.lr_noise_pct / std) * std
    return float(np.float32(1.0) + np.float32(noise))


def make_schedule(cfg: SchedConfig) -> Callable[[float], float]:
    """Returns lr(t) where t is the epoch (or step if sched_in_steps,
    pre-scaled by the caller via `t_of_step`), times the lr noise."""
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
             # plateau: constant base; the train loop scales the
             # optimizer's learning rates on the eval metric
             "plateau": lambda t: cfg.lr}
    if cfg.sched not in table:
        raise ValueError(f"unknown sched {cfg.sched}")
    base = table[cfg.sched]
    if cfg.lr_noise is None:
        return base
    return lambda t: base(t) * lr_noise_factor(cfg, t)


def t_of_step(cfg: SchedConfig, total_step: int, epoch: int) -> float:
    """Reference behavior: per-step `step_update(total_step)` when
    sched_in_steps, else per-epoch `step(epoch)` (engine.py:108-109,
    train.py:606)."""
    return float(total_step) if cfg.sched_in_steps else float(epoch)
