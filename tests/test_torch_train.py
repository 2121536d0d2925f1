"""The port's training pieces against the JAX package, fp32 on the CPU.

Param groups, schedules and losses are compared value by value. The train
step is held against the JAX ``make_train_step`` over three steps of the
tiny topk model (the ``DIMS`` of tests/test_torch_models.py, loc (1, 2),
keep 0.7, drop_path 0) with bench.py's recipe: grouped AdamW lr 1e-3,
backbone_lr_scale 0.01, clip 1.0, EMA 0.99996, label smoothing 0.1. Both
sides start from one Flax init, converted by the weight bridge, and see
the same seeded numpy batches. On the JAX side the CPU runs the XLA
composition; on the port's the training branches' plain forward and
hand-written backward.

Bounds: loss and grad norm per step within 1e-5 relative; the step-1
gradients, and the params and EMA params after step 3, with the bounds of
tests/torch_trajectory.py: within 1e-5 of each leaf's max (fp32 sums in
other orders, and the port's exact erf against the JAX CPU path's), and
AdamW's update range where the clipped step-1 gradient is within 100 eps
of zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.train import losses as jax_losses
from tokenreduction_tpu.train import optim as jax_optim
from tokenreduction_tpu.train import scheduler as jax_sched
from tokenreduction_tpu.train import step as jax_step
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.core.layers import DropPath
from tokenreduction_tpu_torch.models.convert import (
    state_dict_from_flax,
    torch_names_from_flax,
)
from tokenreduction_tpu_torch.train import losses, optim, scheduler, step
from torch_trajectory import assert_params_close, assert_step1_grads_close

DIMS = dict(num_classes=11, img_size=32, embed_dim=64, num_heads=1, depth=4,
            patch_size=8)
TOPK = dict(reduction_loc=(1, 2), keep_rate=(0.7,))
RECIPE = dict(lr=1e-3, clip_grad=1.0, backbone_lr_scale=0.01)
EMA = 0.99996
STEPS, BATCH = 3, 4


@pytest.fixture(scope="module")
def flax_params():
    module, _ = jax_create_model("topk_small_patch16_224", **DIMS, **TOPK)
    variables = module.init({"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 32, 32, 3)), train=False)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.fixture(scope="module")
def start_params(flax_params):
    """The init with seeded noise on every leaf, so no leaf starts at zero.
    (The key bias's gradient is zero up to rounding, a constant shift of
    each softmax row, and Adam normalises that rounding noise into a full
    step: from zero biases it would be all the leaf holds.)"""
    rng = np.random.default_rng(5)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(a.dtype),
        flax_params)


def port_model(flax_params, **kw):
    model, _ = create_model("topk_small_patch16_224", device="cpu", **DIMS,
                            **TOPK, **kw)
    model.load_state_dict(state_dict_from_flax(flax_params), strict=True)
    return model


@pytest.mark.parametrize("flags", [{}, dict(constant_cls=True),
                                   dict(constant_pos=True),
                                   dict(attn_only=True)])
def test_param_labels_match_jax(flax_params, flags):
    jcfg = jax_optim.OptimConfig(**flags)
    want = torch_names_from_flax(jax_optim.param_labels(flax_params, [], jcfg))
    model = port_model(flax_params)
    got = optim.param_labels(dict(model.named_parameters()), [],
                             optim.OptimConfig(**flags))
    assert got == want


@pytest.mark.parametrize("sched", ["cosine", "tanh", "step", "constant"])
def test_schedules_match_jax(sched):
    kw = dict(sched=sched, lr=1e-3, min_lr=1e-5, warmup_lr=1e-6,
              warmup_epochs=3, epochs=20, decay_epochs=4, decay_rate=0.5)
    want = jax_sched.make_schedule(jax_sched.SchedConfig(**kw))
    got = scheduler.make_schedule(scheduler.SchedConfig(**kw))
    for t in (0, 1, 2.5, 3, 4, 7, 11.5, 17, 20, 25):
        assert got(t) == pytest.approx(float(want(t)), rel=1e-12, abs=0.0)
    cfg = scheduler.SchedConfig(sched_in_steps=True, steps_per_epoch=5)
    assert scheduler.t_of_step(cfg, 12, 2) == jax_sched.t_of_step(
        jax_sched.SchedConfig(sched_in_steps=True, steps_per_epoch=5), 12, 2)


@pytest.mark.parametrize("name", ["cross_entropy", "label_smoothing_ce",
                                  "soft_target_ce", "bce_with_logits",
                                  "asymmetric_multilabel_loss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((6, 11))).astype(np.float32)
    if name in ("cross_entropy", "label_smoothing_ce"):
        targets = rng.integers(0, 11, 6)
        t_targets = torch.from_numpy(targets)
    elif name == "soft_target_ce":
        targets = rng.dirichlet(np.ones(11), 6).astype(np.float32)
        t_targets = torch.from_numpy(targets)
    else:
        targets = (rng.random((6, 11)) < 0.3).astype(np.float32)
        t_targets = torch.from_numpy(targets)
    want = getattr(jax_losses, name)(jnp.asarray(logits), jnp.asarray(targets))
    got = getattr(losses, name)(torch.from_numpy(logits), t_targets)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _batches(seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BATCH, 3, 32, 32)).astype(np.float32),
             rng.integers(0, 11, BATCH)) for _ in range(STEPS)]


def _jax_trajectory(flax_params, accum):
    module, _ = jax_create_model("topk_small_patch16_224", **DIMS, **TOPK)
    params = jax.tree_util.tree_map(jnp.asarray, flax_params)
    tx, _ = jax_optim.create_optimizer(
        params, jax_optim.OptimConfig(**RECIPE), lambda s: 1e-3, [],
        steps_per_epoch=100)
    train_step = jax.jit(jax_step.make_train_step(
        lambda p, im, train, rngs: module.apply({"params": p}, im,
                                                train=train, rngs=rngs),
        lambda out, t, i, p: jax_losses.label_smoothing_ce(out, t, 0.1), tx,
        jax_step.StepConfig(grad_accum_steps=accum, ema_decay=EMA)))
    state = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params))
    metrics = []
    for i, (x, y) in enumerate(_batches()):
        state, m = train_step(
            state, {"image": jnp.asarray(x.transpose(0, 2, 3, 1)),
                    "label": jnp.asarray(y)}, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.fixture(scope="module")
def step1_grads(start_params):
    """Both sides' gradients of the first batch's loss at the start, as
    {torch name: array}: the gradient function alone (with accumulation
    the step's gradient is the mean of the halves' instead)."""
    module, _ = jax_create_model("topk_small_patch16_224", **DIMS, **TOPK)
    x, y = _batches()[0]
    want = jax.jit(jax.grad(lambda p: jax_losses.label_smoothing_ce(
        module.apply({"params": p}, jnp.asarray(x.transpose(0, 2, 3, 1)),
                     train=True, rngs={}), jnp.asarray(y), 0.1)))(
        jax.tree_util.tree_map(jnp.asarray, start_params))
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want))
    model = port_model(start_params).train()
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.named_parameters()}
    _, got = step.loss_and_grads(
        model, lambda out, t, i, p: losses.label_smoothing_ce(out, t, 0.1),
        params, torch.from_numpy(x), torch.from_numpy(y), step.StepConfig())
    return ({n: g.numpy() for n, g in want.items()},
            {n: g.numpy() for n, g in got.items()})


@pytest.mark.parametrize("accum", [1, 2])
def test_train_trajectory_matches_jax(start_params, step1_grads, accum):
    jstate, jmetrics = _jax_trajectory(start_params, accum)
    model = port_model(start_params)
    opt, _ = optim.create_optimizer(dict(model.named_parameters()),
                                    optim.OptimConfig(**RECIPE),
                                    lambda s: 1e-3, [], steps_per_epoch=100)
    state = step.init_train_state(model, opt, ema=True, device="cpu")
    train_step = step.make_train_step(
        model, lambda out, t, i, p: losses.label_smoothing_ce(out, t, 0.1),
        opt, step.StepConfig(grad_accum_steps=accum, ema_decay=EMA))
    jgrads, grads = step1_grads
    assert_step1_grads_close(grads, jgrads)
    for (x, y), want in zip(_batches(), jmetrics):
        state, m = train_step(state, {"image": torch.from_numpy(x),
                                      "label": torch.from_numpy(y)})
        for k in ("loss", "grad_norm"):
            assert float(m[k]) == pytest.approx(want[k], rel=1e-5), k
    assert want["grad_norm"] > RECIPE["clip_grad"]  # the clip was live
    assert state.step == STEPS
    for got, tree in ((state.params, jstate.params),
                      (state.ema_params, jstate.ema_params)):
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        assert_params_close(
            {n: t.detach().numpy() for n, t in got.items()},
            {n: t.numpy() for n, t in want.items()}, jgrads,
            jmetrics[0]["grad_norm"], RECIPE["clip_grad"], RECIPE["lr"],
            STEPS)


def test_drop_path_step_follows_its_generator(flax_params):
    """A drop_path 0.1 step draws its masks from the generator handed to
    the step: the same seed gives the same loss and gradients, another
    seed other ones."""
    model = port_model(flax_params, drop_path_rate=0.1)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (8, 3, 32, 32)).astype(np.float32))
    y = torch.arange(8) % 11
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.named_parameters()}
    model.train()

    def run(seed):
        return step.loss_and_grads(
            model, lambda out, t, i, p: losses.label_smoothing_ce(out, t),
            params, x, y, step.StepConfig(),
            torch.Generator().manual_seed(seed))

    (la, ga), (lb, gb), (lc, gc) = run(0), run(0), run(1)
    assert la == lb and all(torch.equal(ga[n], gb[n]) for n in ga)
    assert la != lc and not torch.equal(ga["blocks.3.mlp.fc2.weight"],
                                        gc["blocks.3.mlp.fc2.weight"])


@pytest.mark.parametrize("attn_drop,drop,n_attend,n_mlp", [
    (0.0, 0.0, 4, 4), (0.1, 0.0, 0, 4), (0.0, 0.1, 0, 0)])
def test_training_halves_follow_the_jax_gates(flax_params, monkeypatch,
                                               attn_drop, drop, n_attend,
                                               n_mlp):
    """The attention half takes ``attend_branch_train`` only with no
    attention dropout and no dropout; the MLP half takes ``mlp_branch``
    whenever dropout is 0, attention dropout or not (the JAX gates,
    core/layers.py:404-416 and 512-520)."""
    from tokenreduction_tpu_torch.core import layers

    calls = {"attend": 0, "mlp": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(layers, "attend_branch_train",
                        counted("attend", layers.attend_branch_train))
    monkeypatch.setattr(layers, "mlp_branch",
                        counted("mlp", layers.mlp_branch))
    model = port_model(flax_params, attn_drop_rate=attn_drop, drop_rate=drop)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    model.train()(x, generator=torch.Generator().manual_seed(0))
    assert calls == {"attend": n_attend, "mlp": n_mlp}


def test_drop_path_refuses_the_global_rng():
    layer = DropPath(0.1).train()
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        layer(torch.ones(4, 3, 2))
    # eval and rate 0 draw nothing
    assert torch.equal(layer.eval()(torch.ones(2, 3)), torch.ones(2, 3))


def test_unported_options_raise(flax_params):
    """What the JAX package refuses, the port refuses too (an unknown
    optimizer, ``lookahead_adahessian``); the draws the port makes raise
    without their explicit generator (the Hutchinson probe). The options
    of ROADMAP.md Queue 1 item 4b that raised here until the port had
    them build: every optimizer name, lr noise, the per-module norms."""
    with pytest.raises(ValueError, match="unsupported optimizer"):
        optim.create_optimizer({}, optim.OptimConfig(opt="lamb"),
                               lambda s: 1e-3, [])
    with pytest.raises(ValueError, match="lookahead_adahessian"):
        optim.create_optimizer({}, optim.OptimConfig(
            opt="lookahead_adahessian"), lambda s: 1e-3, [])
    model = port_model(flax_params)
    opt, _ = optim.create_optimizer(dict(model.named_parameters()),
                                    optim.OptimConfig(opt="adahessian"),
                                    lambda s: 1e-3, [])
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        step.make_train_step(model, None, opt,
                             step.StepConfig(hutchinson=True))
    assert scheduler.make_schedule(scheduler.SchedConfig(
        lr_noise=(0.5,)))(200) > 0
    step.make_train_step(model, None, opt, step.StepConfig(watch_norms=True),
                         aug_fn=lambda *a: a)


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """Without CUDA and with no device named, the entry points raise
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("deit_tiny_patch16_224_local", **DIMS)
    model, _ = create_model("deit_tiny_patch16_224_local", device="cpu",
                            **DIMS)
    opt, _ = optim.create_optimizer(dict(model.named_parameters()),
                                    optim.OptimConfig(), lambda s: 1e-3, [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        step.init_train_state(model, opt)
