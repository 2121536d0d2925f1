"""The port's optimizers (train/optim.py) against optax through the JAX
package's ``create_optimizer``, on the CPU.

One Flax init of a small topk model (embed 128, so that Adafactor
factors its kernels of at least 128 and AdamP/SGDP see channels of both
layouts), with seeded noise on every leaf, goes to the port through the
weight bridge; both sides take the same seeded gradients (and, for
AdaHessian, the same Hessian diagonals) for three updates with
``clip_grad`` 1.0 (live: the gradients' norm is far above it),
``backbone_lr_scale`` 0.01 and weight decay 0.05. Bound: every param
within 1e-6 of its leaf's max|JAX| (fp32 sums in other orders), except
that at most one param in 10^4 may reach 1e-5: where a decayed gradient
g + wd p cancels to a few ulps, Adam's step g / (|g| + eps) there is
ill-conditioned (1 or 2 of 425,227 params, up to 1.5e-6, for adam,
adabelief and nadam). ``lookahead_<name>`` is held
against ``optax.lookahead`` given ``LookaheadParams``, per group, over six
updates (a sync at the fifth), because the JAX package's own
``lookahead_*`` raises at its first update (the last test shows it). The
Hutchinson diagonal of the port's step is held against JAX's
``hutchinson_grads_and_diag`` on the same probe.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.train import losses as jax_losses
from tokenreduction_tpu.train import optim as jax_optim
from tokenreduction_tpu.train import step as jax_step
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.models.convert import state_dict_from_flax
from tokenreduction_tpu_torch.train import losses, optim, step
from tokenreduction_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_train_state,
    save_checkpoint,
)
from torch_threads import one_torch_thread  # noqa: F401

DIMS = dict(num_classes=11, img_size=32, embed_dim=128, num_heads=2,
            depth=2, patch_size=8)
TOPK = dict(reduction_loc=(1,), keep_rate=(0.7,))
RECIPE = dict(lr=1e-3, clip_grad=1.0, backbone_lr_scale=0.01,
              weight_decay=0.05)
NAMES = ["sgd", "nesterov", "momentum", "adam", "adamw", "adabelief",
         "nadam", "radam", "adadelta", "adafactor", "rmsprop", "rmsproptf",
         "novograd", "nvnovograd", "adamp", "sgdp", "adahessian"]
BOUND = 1e-6


def lr(step):
    return 1e-3


@pytest.fixture(scope="module")
def flax_params():
    module, _ = jax_create_model("topk_small_patch16_224", **DIMS, **TOPK)
    v = jax.jit(lambda: module.init({"params": jax.random.PRNGKey(0)},
                                    jnp.zeros((1, 32, 32, 3)),
                                    train=False))()
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape))
        .astype(np.float32), v["params"])


@pytest.fixture(scope="module")
def noise(flax_params):
    """Six gradients and six Hessian diagonals, Flax trees."""
    rng = np.random.default_rng(2)

    def tree():
        return jax.tree_util.tree_map(
            lambda a: (0.1 * rng.standard_normal(a.shape)).astype(
                np.float32), flax_params)
    return [tree() for _ in range(6)], [tree() for _ in range(6)]


def assert_params_close(got: dict, flax_tree, bound=BOUND):
    """Each param within bound of its leaf's max|JAX|, at most one in
    10^4 of the tree within 10 x bound (the module docstring)."""
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, flax_tree))
    assert sorted(got) == sorted(want)
    outside, total = 0, 0
    for n, w in want.items():
        err = (got[n] - w).abs() / float(w.abs().max())
        assert float(err.max()) <= 10 * bound, (n, float(err.max()))
        outside += int((err > bound).sum())
        total += w.numel()
    assert outside <= total * 1e-4, (outside, total)


def port_run(flax_params, grads, diags, cfg, steps):
    params = {n: t.clone() for n, t in state_dict_from_flax(
        flax_params).items()}
    opt, _ = optim.create_optimizer(params, cfg, lr, [], steps_per_epoch=100)
    state = opt.init(params)
    for i in range(steps):
        extra = ({"hessian_diag": state_dict_from_flax(diags[i])}
                 if opt.needs_diag else {})
        opt.update(params, state_dict_from_flax(grads[i]), state, i, **extra)
    return params, state, opt


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_optax(flax_params, noise, name):
    grads, diags = noise
    jcfg = jax_optim.OptimConfig(opt=name, **RECIPE)
    tx, _ = jax_optim.create_optimizer(flax_params, jcfg, lr, [],
                                       steps_per_epoch=100)
    update = jax.jit(lambda g, s, p, d: tx.update(
        g, s, p, **({"hessian_diag": d} if name == "adahessian" else {})))
    p = jax.tree_util.tree_map(jnp.asarray, flax_params)
    s = tx.init(p)
    for i in range(3):
        u, s = update(grads[i], s, p, diags[i])
        p = optax.apply_updates(p, u)
    got, _, _ = port_run(flax_params, grads, diags,
                         optim.OptimConfig(opt=name, **RECIPE), 3)
    assert_params_close(got, p)


def optax_lookahead_reference(flax_params, grads, name, steps):
    """The JAX chain of ``lookahead_<name>`` as optax.lookahead defines it:
    clip over all leaves, then per group ``optax.lookahead`` of the JAX
    package's ``_base_opt`` over (fast, slow) params; frozen leaves none
    here. Returns the fast and the slow Flax trees."""
    cfg = jax_optim.OptimConfig(opt=name, **RECIPE)
    flat_labels = jax.tree_util.tree_leaves(
        jax_optim.param_labels(flax_params, [], cfg))
    leaves, treedef = jax.tree_util.tree_flatten(flax_params)
    groups = {}
    for i, lab in enumerate(flat_labels):
        groups.setdefault(lab, []).append(i)
    scale = {"new_param": 1.0, "new_param_no_decay": 1.0,
             "decay": cfg.backbone_lr_scale,
             "no_decay": cfg.backbone_lr_scale}
    txs, states, fast, slow = {}, {}, {}, {}
    for lab, idx in groups.items():
        wd = cfg.weight_decay if lab in ("new_param", "decay") else 0.0
        inner = jax_optim._base_opt(
            cfg, jax_optim.group_lr_fn(lr, scale[lab], 0, 100), wd)
        txs[lab] = optax.lookahead(inner, 5, 0.5)
        txs[lab] = txs[lab]._replace(update=jax.jit(txs[lab].update))
        sub = {i: jnp.asarray(leaves[i]) for i in idx}
        states[lab] = txs[lab].init(optax.LookaheadParams.init_synced(sub))
        fast[lab], slow[lab] = sub, dict(sub)
    clip = jax.jit(lambda g: optax.clip_by_global_norm(cfg.clip_grad).update(
        g, optax.EmptyState())[0])
    for i in range(steps):
        g = clip(grads[i])
        gl = jax.tree_util.tree_leaves(g)
        for lab, idx in groups.items():
            params = optax.LookaheadParams(fast[lab], slow[lab])
            u, states[lab] = txs[lab].update({j: gl[j] for j in idx},
                                             states[lab], params)
            params = optax.apply_updates(params, u)
            fast[lab], slow[lab] = params.fast, params.slow
    merged = [None] * len(leaves)
    merged_slow = [None] * len(leaves)
    for lab, idx in groups.items():
        for j in idx:
            merged[j], merged_slow[j] = fast[lab][j], slow[lab][j]
    return (jax.tree_util.tree_unflatten(treedef, merged),
            jax.tree_util.tree_unflatten(treedef, merged_slow))


@pytest.mark.parametrize("name", ["lookahead_adamw", "lookahead_sgd",
                                  "lookahead_adafactor"])
def test_lookahead_matches_optax_lookahead(flax_params, noise, name):
    """Six updates: the fast weights after the sync at the fifth and one
    more, and the slow weights in the state."""
    inner = name.split("_", 1)[1]
    want_fast, want_slow = optax_lookahead_reference(flax_params, noise[0],
                                                     inner, 6)
    got, state, _ = port_run(flax_params, noise[0], None,
                             optim.OptimConfig(opt=name, **RECIPE), 6)
    assert_params_close(got, want_fast)
    assert_params_close(state["slow"], want_slow)
    # the slow weights moved at the sync
    start = state_dict_from_flax(flax_params)
    assert all(not torch.equal(state["slow"][n], start[n]) for n in start)


def test_jax_lookahead_raises_where_the_port_trains(flax_params, noise):
    """The reference's lookahead_* wraps each group of
    optax.multi_transform in optax.lookahead, which then receives plain
    params where it expects LookaheadParams."""
    cfg = jax_optim.OptimConfig(opt="lookahead_adamw", **RECIPE)
    tx, _ = jax_optim.create_optimizer(flax_params, cfg, lr, [], 100)
    p = jax.tree_util.tree_map(jnp.asarray, flax_params)
    with pytest.raises(AttributeError, match="fast"):
        tx.update(noise[0][0], tx.init(p), p)
    got, _, _ = port_run(flax_params, noise[0], None,
                         optim.OptimConfig(opt="lookahead_adamw", **RECIPE),
                         1)
    assert all(torch.isfinite(t).all() for t in got.values())


def test_adahessian_refusals_match_jax(flax_params, noise):
    for mod in (jax_optim, optim):
        with pytest.raises(ValueError, match="lookahead_adahessian"):
            mod.create_optimizer(
                flax_params if mod is jax_optim else
                state_dict_from_flax(flax_params),
                mod.OptimConfig(opt="lookahead_adahessian"), lr, [])
        with pytest.raises(ValueError, match="unsupported optimizer"):
            mod.create_optimizer(
                flax_params if mod is jax_optim else
                state_dict_from_flax(flax_params),
                mod.OptimConfig(opt="lamb"), lr, [])
    params = state_dict_from_flax(flax_params)
    opt, _ = optim.create_optimizer(params, optim.OptimConfig(
        opt="adahessian"), lr, [])
    with pytest.raises(ValueError, match="Hutchinson diagonal"):
        opt.update(params, state_dict_from_flax(noise[0][0]),
                   opt.init(params), 0)


@pytest.mark.parametrize("name", ["adafactor", "lookahead_novograd"])
def test_state_round_trips_through_a_checkpoint(tmp_path, flax_params,
                                                noise, name):
    """Every part of the state (Adafactor's factored rows and columns,
    NovoGrad's scalar moments, lookahead's slow weights) is saved and put
    back by restore_train_state."""
    params, state, _ = port_run(flax_params, noise[0], None,
                                optim.OptimConfig(opt=name, **RECIPE), 2)
    path = str(tmp_path / "c")
    save_checkpoint(path, params=params, opt_state=state, epoch=0, step=2)
    fresh = {n: torch.zeros_like(t) for n, t in params.items()}
    opt, _ = optim.create_optimizer(fresh, optim.OptimConfig(opt=name,
                                                             **RECIPE),
                                    lr, [])
    live = step.TrainState(0, fresh, opt.init(fresh))
    tree, meta = load_checkpoint(path)
    live = restore_train_state(live, tree, meta)
    assert live.step == 2 and sorted(live.opt_state) == sorted(state)
    for part, d in state.items():
        for n, t in d.items():
            assert torch.equal(live.opt_state[part][n], t), (part, n)


@pytest.fixture(scope="module")
def tiny():
    """A tiny topk model at head dim 64 (both sides' training kernels'
    gates open) and its params with seeded noise."""
    dims = dict(num_classes=11, img_size=32, embed_dim=64, num_heads=1,
                depth=3, patch_size=8)
    module, _ = jax_create_model("topk_small_patch16_224", **dims,
                                 reduction_loc=(1,), keep_rate=(0.7,))
    v = jax.jit(lambda: module.init({"params": jax.random.PRNGKey(3)},
                                    jnp.zeros((1, 32, 32, 3)),
                                    train=False))()
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape))
        .astype(np.float32), v["params"])
    return module, dims, params


def test_hutchinson_diagonal_matches_jax(tiny, monkeypatch):
    """loss, gradients and z * (H z) of one batch for one Rademacher probe
    z, JAX's jvp of the gradient against the port's double backward
    (the port's model pinned to the plain composition, JAX's forced to
    XLA as its loop forces it): within 1e-5 of each leaf's max|JAX|."""
    monkeypatch.setenv("TOKENREDUCTION_USE_PALLAS_TRAIN", "0")
    module, dims, params = tiny
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 11, 4)
    z = jax_step.rademacher_like(jax.random.PRNGKey(6), params)

    def loss_fn(p):
        out = module.apply({"params": p}, jnp.asarray(x.transpose(0, 2, 3, 1)),
                           train=True, rngs={})
        return jax_losses.label_smoothing_ce(out, jnp.asarray(y), 0.1)

    vg = jax.value_and_grad(loss_fn)
    loss, grads, diag = jax.jit(
        lambda p, z: jax_step.hutchinson_grads_and_diag(vg, p, z))(
            jax.tree_util.tree_map(jnp.asarray, params), z)
    model, _ = create_model("topk_small_patch16_224", device="cpu", **dims,
                            reduction_loc=(1,), keep_rate=(0.7,))
    step.pin_plain_composition(model)
    model.train()
    p = {n: t.clone().requires_grad_(True)
         for n, t in state_dict_from_flax(params).items()}
    got_loss, got_grads, got_diag = step.hutchinson_grads_and_diag(
        model, lambda out, t_, i, p_: losses.label_smoothing_ce(out, t_, 0.1),
        p, torch.from_numpy(x), torch.from_numpy(y), step.StepConfig(),
        state_dict_from_flax(jax.tree_util.tree_map(np.asarray, z)),
        torch.Generator().manual_seed(0))
    assert float(got_loss) == pytest.approx(float(loss), rel=1e-5)
    assert_params_close(got_grads, grads, 1e-5)
    assert_params_close(got_diag, diag, 1e-5)
    assert any(float(np.abs(np.asarray(d)).max()) > 0
               for d in jax.tree_util.tree_leaves(diag))


def test_adahessian_step_pins_the_plain_composition(tiny):
    """make_train_step with hutchinson pins every block, draws its probe
    from the step's generator (refusing none) and trains."""
    _, dims, params = tiny
    model, _ = create_model("topk_small_patch16_224", device="cpu", **dims,
                            reduction_loc=(1,), keep_rate=(0.7,))
    model.load_state_dict(state_dict_from_flax(params))
    opt, _ = optim.create_optimizer(dict(model.named_parameters()),
                                    optim.OptimConfig(opt="adahessian"), lr,
                                    [])
    cfg = step.StepConfig(hutchinson=True)
    loss_fn = lambda out, t_, i, p_: losses.cross_entropy(out, t_)  # noqa
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        step.make_train_step(model, loss_fn, opt, cfg)
    train_step = step.make_train_step(model, loss_fn, opt, cfg,
                                      torch.Generator().manual_seed(0))
    assert all(b.force_plain for b in model.blocks)
    state = step.init_train_state(model, opt, device="cpu")
    rng = np.random.default_rng(7)
    batch = {"image": torch.from_numpy(rng.standard_normal(
        (4, 3, 32, 32)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 11, 4))}
    before = {n: t.detach().clone() for n, t in state.params.items()}
    state, m = train_step(state, batch)
    assert torch.isfinite(m["loss"]) and state.step == 1
    assert any(not torch.equal(before[n], t) for n, t in state.params.items())
    assert dataclasses.asdict(cfg)["hutchinson"]
