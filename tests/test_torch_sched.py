"""The port's plateau schedule and lr noise (train/scheduler.py, the
plateau decay in train/loop.py) against the JAX package's, on the CPU.

plateau: the base schedule is JAX's constant, and the optimizer's
``lr_scale`` (the host decay the loop applies) scales every group's
learning rate while the state carries over, as JAX's rebuilt transform
does. The loop's decision rule is held against JAX's CLI in
tests/test_torch_train_cli_flags.py. lr noise: the port draws from a CPU
``torch.Generator`` seeded from (seed, floor t) where JAX draws from
``jax.random``, so the values differ; what must agree is where the noise
is on (the same range rule as JAX's factor), that it is 1 elsewhere,
bounded by lr_noise_pct inside, deterministic per (seed, floor t), and a
truncated normal (scipy's KS test against ``truncnorm``).
"""

import numpy as np
import pytest
import torch
from scipy import stats

from tokenreduction_tpu.train import scheduler as jax_sched
from tokenreduction_tpu_torch.train import optim, scheduler
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-6, warmup_epochs=3, epochs=20,
          decay_epochs=4, decay_rate=0.5)
TIMES = (0, 1, 2.5, 3, 4, 7, 11.5, 17, 20, 25)


def test_plateau_base_matches_jax():
    want = jax_sched.make_schedule(jax_sched.SchedConfig(sched="plateau",
                                                         **KW))
    got = scheduler.make_schedule(scheduler.SchedConfig(sched="plateau",
                                                        **KW))
    assert [got(t) for t in TIMES] == [float(want(t)) for t in TIMES]


def test_plateau_scale_scales_every_group_and_keeps_the_state():
    """After a first update, an AdamW update at lr_scale 0.1 equals one of
    an optimizer whose schedule is 0.1 times the first's, from the same
    params and state (JAX rebuilds its transform with the scaled schedule
    and keeps the state), in the backbone groups too."""
    rng = np.random.default_rng(0)
    shapes = {"blocks.0.mlp.fc1.weight": (8, 4), "head.weight": (3, 8),
              "head.bias": (3,), "blocks.0.norm1.weight": (4,)}
    params = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for n, s in shapes.items()}
    grads = [{n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for n, s in shapes.items()} for _ in range(2)]
    cfg = optim.OptimConfig(backbone_lr_scale=0.5)
    opt, _ = optim.create_optimizer(params, cfg, lambda s: 1e-3, [])
    state = opt.init(params)
    opt.update(params, grads[0], state, 0)
    p2 = {n: t.clone() for n, t in params.items()}
    s2 = {k: {n: t.clone() for n, t in v.items()} for k, v in state.items()}
    opt.lr_scale = 0.1
    opt.update(params, grads[1], state, 1)
    opt2, _ = optim.create_optimizer(p2, cfg, lambda s: 1e-4, [])
    opt2.update(p2, grads[1], s2, 1)
    for n in params:
        torch.testing.assert_close(params[n], p2[n], rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(state["nu"][n], s2["nu"][n], rtol=0,
                                   atol=0)


NOISE = dict(sched="cosine", lr=1e-3, epochs=100, warmup_epochs=0,
             lr_noise_pct=0.67, lr_noise_std=1.0, seed=42)


@pytest.mark.parametrize("lr_noise,steps", [((0.3, 0.6), False),
                                            ((0.5,), False),
                                            ((0.2, 0.9), True)])
def test_lr_noise_range_bound_and_determinism(lr_noise, steps):
    """Where JAX's factor is 1, the port's is 1; inside the range the
    factor is 1 + noise with |noise| < pct, the same for two times with
    one floor and for two schedules of one seed, and another seed draws
    other values."""
    kw = dict(NOISE, lr_noise=lr_noise, sched_in_steps=steps,
              steps_per_epoch=3)
    jcfg = jax_sched.SchedConfig(**kw)
    cfg = scheduler.SchedConfig(**kw)
    span = 300 if steps else 100
    times = np.arange(0, span + 5, 0.5)
    want = np.array([float(jax_sched.lr_noise_factor(jcfg, t))
                     for t in times[::7]])
    got = np.array([scheduler.lr_noise_factor(cfg, t) for t in times])
    assert ((got[::7] == 1.0) == (want == 1.0)).all()
    inside = got != 1.0
    assert inside.sum() > 0.2 * len(times)
    assert (np.abs(got - 1) < cfg.lr_noise_pct).all()
    assert np.array_equal(got[::2], got[1::2])  # t and t + 0.5: one floor
    base = scheduler.make_schedule(scheduler.SchedConfig(
        **dict(kw, lr_noise=None)))
    noisy = scheduler.make_schedule(cfg)
    for t in times[::13]:
        assert noisy(t) == pytest.approx(
            base(t) * scheduler.lr_noise_factor(cfg, t), rel=1e-12)
    other = scheduler.SchedConfig(**dict(kw, seed=43))
    again = np.array([scheduler.lr_noise_factor(other, t) for t in times])
    assert ((again == 1.0) == (got == 1.0)).all()
    assert not np.array_equal(again[inside], got[inside])


def test_lr_noise_is_a_truncated_normal():
    """4000 factors (one a floor t) against scipy's truncnorm at
    pct / std, std 0.5: KS p > 1e-3."""
    cfg = scheduler.SchedConfig(**dict(NOISE, lr_noise=(0.0,), epochs=4000,
                                       lr_noise_std=0.5))
    noise = np.array([scheduler.lr_noise_factor(cfg, t) - 1.0
                      for t in range(4000)]) / 0.5
    bound = 0.67 / 0.5
    assert stats.kstest(noise, stats.truncnorm(-bound, bound).cdf
                        ).pvalue > 1e-3
    assert np.abs(noise).max() < bound
