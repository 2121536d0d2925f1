"""The port's ToMe against the JAX package, fp32 on the CPU.

The merge ops get the same seeded numpy metrics and tokens on both sides:
merge indices and assignment maps must be equal, merged values within
rtol = atol = 1e-5. The model is held as tests/test_torch_models.py holds
topk: one Flax init through the weight bridge, the same seeded images,
logits and features within 2e-4 and ``Assignment_Maps`` exactly, at keep
0.7, at keep 0.25 (where the clamp r <= (t - 1) // 2 binds) and with the
dist token. The train step is held against JAX's ``make_train_step`` over
three steps as tests/test_torch_train.py holds topk's: loss and grad norm
within 1e-5 relative, step-1 gradients, params and EMA with the bounds of
tests/torch_trajectory.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.models.convert import convert_torch_state_dict
from tokenreduction_tpu.ops import tome as jax_tome
from tokenreduction_tpu.train import losses as jax_losses
from tokenreduction_tpu.train import optim as jax_optim
from tokenreduction_tpu.train import step as jax_step
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.models.convert import state_dict_from_flax
from tokenreduction_tpu_torch.ops import tome
from tokenreduction_tpu_torch.train import losses, optim, step
from torch_trajectory import assert_params_close, assert_step1_grads_close

DIMS = dict(num_classes=11, img_size=32, embed_dim=64, num_heads=1, depth=4,
            patch_size=8)
LOC = (1, 2)
TOL = dict(rtol=2e-4, atol=2e-4)
MERGE_TOL = dict(rtol=1e-5, atol=1e-5)
CASES = {
    "keep 0.7": dict(keep_rate=(0.7,)),
    "keep 0.25": dict(keep_rate=(0.25,)),
    "distilled": dict(keep_rate=(0.7,), distilled=True),
}


def merge_case(T, r, class_token, distill_token, ties, seed=0):
    """Both sides' merges of one seeded metric [2, T, 8] and tokens
    [2, T, 5]; ``ties``: every metric row one of three rows whose
    normalised dot products are exact (0, 0.5 or 1) in any order of
    summation, so that scores tie exactly and the first maximum and the
    sort's stability decide."""
    rng = np.random.default_rng(seed + T + r)
    if ties:
        rows = np.zeros((3, 8), np.float32)
        rows[0, 0], rows[1, 1], rows[2, :4] = 2.0, 4.0, 1.0
        metric = rows[rng.integers(0, 3, (2, T))]
    else:
        metric = rng.standard_normal((2, T, 8)).astype(np.float32)
    x = rng.standard_normal((2, T, 5)).astype(np.float32)
    size = rng.integers(1, 4, (2, T, 1)).astype(np.float32)
    kw = dict(class_token=class_token, distill_token=distill_token)
    return (jax_tome.bipartite_soft_matching(jnp.asarray(metric), r, **kw),
            tome.bipartite_soft_matching(torch.from_numpy(metric), r, **kw),
            x, size)


@pytest.mark.parametrize("T,r,class_token,distill_token,ties", [
    (17, 5, True, False, False), (17, 12, True, False, False),
    (18, 4, True, True, False), (16, 6, False, False, False),
    (17, 6, True, False, True), (12, 5, True, True, True)])
def test_merges_match_jax(T, r, class_token, distill_token, ties):
    want, got, x, size = merge_case(T, r, class_token, distill_token, ties)
    assert (got.r, got.t) == (want.r, want.t)
    for name in ("unm_idx", "src_idx", "dst_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for s in (None, size):
        ref = jax_tome.merge_wavg(want, jnp.asarray(x),
                                  None if s is None else jnp.asarray(s))
        out = tome.merge_wavg(got, torch.from_numpy(x),
                              None if s is None else torch.from_numpy(s))
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **MERGE_TOL)
    np.testing.assert_array_equal(
        tome.merge_source_assignment(got, class_token).numpy(),
        np.asarray(jax_tome.merge_source_assignment(want, class_token)))


def test_no_merge_when_the_clamp_leaves_none():
    info = tome.bipartite_soft_matching(torch.ones(1, 2, 4), 3)
    assert (info.r, info.t, info.unm_idx) == (0, 2, None)
    x = torch.ones(1, 2, 4)
    assert tome.merge_tokens_tome(info, x) is x


def jax_model(**kw):
    return jax_create_model("tome_small_patch16_224", **DIMS,
                            reduction_loc=LOC, **kw)[0]


@functools.lru_cache(maxsize=None)
def init_params(distilled: bool = False):
    """One Flax init per backbone (the keep rate adds no parameters)."""
    module = jax_model(keep_rate=(0.7,), distilled=distilled)
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)),
        train=False))()
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def port_model(params, **kw):
    model, _ = create_model("tome_small_patch16_224", device="cpu", **DIMS,
                            reduction_loc=LOC, **kw)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def images(b=2, seed=7):
    x = np.random.default_rng(seed).standard_normal((b, 3, 32, 32)) \
        .astype(np.float32)
    return x, x.transpose(0, 2, 3, 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_and_assignment_maps_match_jax(case):
    kw = dict(CASES[case], viz_mode=True)
    jmodel = jax_model(**kw)
    params = init_params(kw.get("distilled", False))
    model = port_model(params, **kw).eval()
    x_nchw, x_nhwc = images()
    ref, ref_viz = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, train=False))(params, jnp.asarray(x_nhwc))
    with torch.no_grad():
        out, viz = model(torch.from_numpy(x_nchw))
    assert sorted(viz["Assignment_Maps"]) == sorted(ref_viz["Assignment_Maps"])
    for i, amap in ref_viz["Assignment_Maps"].items():
        np.testing.assert_array_equal(viz["Assignment_Maps"][i].numpy(),
                                      np.asarray(amap))
    assert sorted(viz["Features"]) == sorted(ref_viz["Features"])
    for i, feat in ref_viz["Features"].items():
        np.testing.assert_allclose(viz["Features"][i].numpy(),
                                   np.asarray(feat), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_bridge_round_trips_tome_params():
    """ToMe adds no parameters: the Flax tree maps onto the port's module
    (strict load) and back unchanged."""
    params = init_params()
    model = port_model(params, keep_rate=(0.7,))
    back, skipped = convert_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    assert not skipped

    def flat(tree):
        return {jax.tree_util.keystr(path): leaf for path, leaf in
                jax.tree_util.tree_leaves_with_path(tree)}

    flat, flat_back = flat(params), flat(back)
    assert sorted(flat) == sorted(flat_back)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf)


def test_training_attention_halves_follow_the_jax_gates(monkeypatch):
    """In training the attention halves before the first merge take
    ``attend_branch_train``, those after it (with the size bias) the
    attention core; every MLP half takes ``mlp_branch``."""
    from tokenreduction_tpu_torch.core import layers

    calls = {"attend": 0, "core": 0, "mlp": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    for name, attr in (("attend", "attend_branch_train"),
                       ("core", "attention_core_train"),
                       ("mlp", "mlp_branch")):
        monkeypatch.setattr(layers, attr, counted(name, getattr(layers, attr)))
    model = port_model(init_params(), keep_rate=(0.7,))
    model.train()(torch.from_numpy(images()[0]))
    assert calls == {"attend": 2, "core": 2, "mlp": 4}


RECIPE = dict(lr=1e-3, clip_grad=1.0, backbone_lr_scale=0.01)
EMA, STEPS, BATCH = 0.99996, 3, 4


def test_train_trajectory_matches_jax():
    """Three fp32 steps of bench.py's recipe from one noisy init (no leaf
    at zero; see tests/test_torch_train.py): the same step-1 gradients,
    losses, grad norms, params and EMA params as JAX's make_train_step,
    with tests/torch_trajectory.py's bounds. The patch embedding holds
    elements whose clipped step-1 gradient is near 1e-8 (AdamW's eps):
    AdamW turns their rounding gaps into update gaps of 2e-3 to 3e-3 of
    lr, 1.7e-6 to 3.0e-6 by the CPU's rounding, around 1e-5 max|w| =
    2.1e-6."""
    module = jax_model(keep_rate=(0.7,))
    rng = np.random.default_rng(5)
    start = jax.tree_util.tree_map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(a.dtype),
        init_params())
    data = np.random.default_rng(11)
    batches = [(data.standard_normal((BATCH, 3, 32, 32)).astype(np.float32),
                data.integers(0, 11, BATCH)) for _ in range(STEPS)]

    params = jax.tree_util.tree_map(jnp.asarray, start)
    tx, _ = jax_optim.create_optimizer(
        params, jax_optim.OptimConfig(**RECIPE), lambda s: 1e-3, [],
        steps_per_epoch=100)
    train_step = jax.jit(jax_step.make_train_step(
        lambda p, im, train, rngs: module.apply({"params": p}, im,
                                                train=train, rngs=rngs),
        lambda out, t, i, p: jax_losses.label_smoothing_ce(out, t, 0.1), tx,
        jax_step.StepConfig(ema_decay=EMA)))
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params))

    model = port_model(start, keep_rate=(0.7,))
    opt, _ = optim.create_optimizer(dict(model.named_parameters()),
                                    optim.OptimConfig(**RECIPE),
                                    lambda s: 1e-3, [], steps_per_epoch=100)
    state = step.init_train_state(model, opt, ema=True, device="cpu")
    port_step = step.make_train_step(
        model, lambda out, t, i, p: losses.label_smoothing_ce(out, t, 0.1),
        opt, step.StepConfig(ema_decay=EMA))
    x, y = batches[0]
    jgrads = jax.jit(jax.grad(lambda p: jax_losses.label_smoothing_ce(
        module.apply({"params": p}, jnp.asarray(x.transpose(0, 2, 3, 1)),
                     train=True, rngs={}), jnp.asarray(y), 0.1)))(params)
    jgrads = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    model.train()
    _, grads = step.loss_and_grads(
        model, lambda out, t, i, p: losses.label_smoothing_ce(out, t, 0.1),
        state.params, torch.from_numpy(x), torch.from_numpy(y),
        step.StepConfig())
    assert_step1_grads_close({n: g.numpy() for n, g in grads.items()},
                             {n: g.numpy() for n, g in jgrads.items()})
    grad_norms = []
    for i, (x, y) in enumerate(batches):
        jstate, jm = train_step(
            jstate, {"image": jnp.asarray(x.transpose(0, 2, 3, 1)),
                     "label": jnp.asarray(y)}, jax.random.PRNGKey(i))
        state, m = port_step(state, {"image": torch.from_numpy(x),
                                     "label": torch.from_numpy(y)})
        for k in ("loss", "grad_norm"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
        grad_norms.append(float(jm["grad_norm"]))
    assert state.step == STEPS
    for got, tree in ((state.params, jstate.params),
                      (state.ema_params, jstate.ema_params)):
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        assert_params_close(
            {n: t.detach().numpy() for n, t in got.items()},
            {n: t.numpy() for n, t in want.items()},
            {n: g.numpy() for n, g in jgrads.items()}, grad_norms[0],
            RECIPE["clip_grad"], RECIPE["lr"], STEPS)
