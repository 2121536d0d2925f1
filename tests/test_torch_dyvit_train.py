"""DyViT's training on the port against the JAX package, fp32 on the CPU.

The Gumbel draw cannot be equal across frameworks (JAX draws from its own
``gumbel`` stream, the port from the forward's generator), so both sides
take the same seeded numpy uniforms, stage by stage: JAX's
``jax.random.uniform`` and the port's ``ops/dyvit.py::gumbel_uniform`` are
patched for the test, and each side's own ``gumbel_softmax_hard`` runs on
them. Held against JAX, each tensor within 1e-4 of its max unless
stated: ``softmax_with_policy`` (a policy with zeros and a fully zero
row) and its gradients; ``gumbel_softmax_hard``'s values exactly and its
gradient through the soft values; the training forward (logits, the
post-norm tokens, the last decision, each stage's decisions), the loss
that ``build_loss_fn`` builds from one ``argparse.Namespace`` on each
side and every gradient, without and with ``dyvit_distill`` (KL and
``mse_token`` token losses, the dense teacher through the weight
bridge); two train steps with the teacher against JAX's
``make_train_step``. The gates: under a policy no attention half takes
``attend_branch_train`` or the attention core, and every MLP half takes
``mlp_branch``.
"""

import argparse
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.ops import dyvit as jax_dyvit_ops
from tokenreduction_tpu.train import loop as jax_loop
from tokenreduction_tpu.train import optim as jax_optim
from tokenreduction_tpu.train import step as jax_step
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.core import layers
from tokenreduction_tpu_torch.models.convert import state_dict_from_flax
from tokenreduction_tpu_torch.ops import dyvit as dyvit_ops
from tokenreduction_tpu_torch.train import loop, optim, step
from torch_threads import one_torch_thread  # noqa: F401

DIMS = dict(num_classes=11, img_size=32, embed_dim=64, num_heads=1, depth=4,
            patch_size=8)
LOC = (1, 2)
KEEP = (0.7,)
B, PATCHES = 4, 16
OP_TOL = dict(rtol=1e-5, atol=1e-5)
RECIPE = dict(lr=1e-3, clip_grad=1.0, backbone_lr_scale=0.01)


def gumbel_draws(seed, shape=(B, PATCHES, 2), stages=len(LOC)):
    """One seeded fp32 uniform array on [tiny, 1) a stage."""
    rng = np.random.default_rng(seed)
    tiny = np.finfo(np.float32).tiny
    return [np.maximum(rng.random(shape, dtype=np.float32), tiny)
            for _ in range(stages)]


def share_uniforms(monkeypatch, draws):
    """Both sides' Gumbel uniforms from ``draws``, stage after stage (a
    jitted JAX function draws once, when it is traced)."""
    jax_draws, port_draws = itertools.cycle(draws), itertools.cycle(draws)

    def jax_uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = next(jax_draws)
        assert tuple(shape) == u.shape
        return jnp.asarray(u, dtype)

    def port_uniform(shape, dtype, device, generator):
        u = next(port_draws)
        assert tuple(shape) == u.shape
        return torch.from_numpy(u).to(device=device, dtype=dtype)

    monkeypatch.setattr(jax.random, "uniform", jax_uniform)
    monkeypatch.setattr(dyvit_ops, "gumbel_uniform", port_uniform)


def assert_close(got, want, err_msg=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, err_msg
    tol = 1e-4 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=err_msg)


def test_softmax_with_policy_matches_jax():
    """Values and the gradients of attn and policy, with a policy that has
    zeros and a sample whose policy is all zero (each query keeps only
    itself)."""
    rng = np.random.default_rng(0)
    attn = (3 * rng.standard_normal((3, 2, 7, 7))).astype(np.float32)
    policy = (rng.random((3, 7, 1)) > 0.4).astype(np.float32)
    policy[1] = 0.0
    cot = rng.standard_normal(attn.shape).astype(np.float32)
    want, vjp = jax.vjp(jax_dyvit_ops.softmax_with_policy,
                        jnp.asarray(attn), jnp.asarray(policy))
    want_grads = vjp(jnp.asarray(cot))
    a, p = (torch.from_numpy(t).requires_grad_() for t in (attn, policy))
    got = dyvit_ops.softmax_with_policy(a, p)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OP_TOL)
    for g, w in zip((a.grad, p.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OP_TOL)
    # the all-zero policy's rows: off the query itself only the eps / N
    # terms, each below every diagonal entry
    zero = got.detach().numpy()[1]
    diag = np.diagonal(zero, 0, 1, 2)
    off = zero[:, ~np.eye(7, dtype=bool)].reshape(2, 7, 6)
    assert (off < diag[..., None]).all()


@pytest.mark.parametrize("classes", [2, 3])
def test_gumbel_softmax_hard_matches_jax(monkeypatch, classes):
    """With the same uniforms: the one-hot decisions bit for bit (the same
    argmax), the straight-through values, (y_hard + y_soft) - y_soft,
    within an fp32 ulp of 1 (the two softmaxes round apart by an ulp), and
    the gradient through the soft values."""
    rng = np.random.default_rng(classes)
    logits = rng.standard_normal((3, 9, classes)).astype(np.float32)
    cot = rng.standard_normal(logits.shape).astype(np.float32)
    share_uniforms(monkeypatch, gumbel_draws(1, logits.shape, 1))
    want, vjp = jax.vjp(lambda z: jax_dyvit_ops.gumbel_softmax_hard(
        jax.random.PRNGKey(0), z), jnp.asarray(logits))
    leaf = torch.from_numpy(logits).requires_grad_()
    got = dyvit_ops.gumbel_softmax_hard(leaf, generator=None)
    got.backward(torch.from_numpy(cot))
    values, want = got.detach().numpy(), np.asarray(want)
    np.testing.assert_array_equal(values.round(), want.round())
    assert set(np.unique(values.round())) == {0.0, 1.0}
    np.testing.assert_allclose(values, want, rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(vjp(
        jnp.asarray(cot))[0]), **OP_TOL)


def test_gumbel_uniform_range():
    """The uniforms lie on [tiny, 1) in the logits' dtype, from the
    generator: the same seed, the same draw."""
    for dtype in (torch.float32, torch.bfloat16):
        draw = [dyvit_ops.gumbel_uniform(
            (64, 197, 2), dtype, "cpu", torch.Generator().manual_seed(3))
            for _ in range(2)]
        assert draw[0].dtype == dtype and torch.equal(*draw)
        assert float(draw[0].min()) >= torch.finfo(dtype).tiny
        assert float(draw[0].max()) < 1.0


@functools.lru_cache(maxsize=None)
def flax_params(name, seed):
    module = jax_create_model(name, **DIMS, **(
        dict(reduction_loc=LOC, keep_rate=KEEP) if "teacher" not in name
        else {}))[0]
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 32, 32, 3)),
        train=False))()
    rng = np.random.default_rng(seed + 5)
    # off the init's zero biases and unit scales
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape))
        .astype(np.float32), variables["params"])


def args_for(distill: bool, mse_token: bool = False):
    return argparse.Namespace(
        smoothing=0.1, ratio_weight=2.0, cls_distill_weight=0.5,
        token_distill_weight=0.5, cls_weight=1.0, mse_token=mse_token,
        dyvit_distill=distill, distillation_type="none")


def jax_side(args):
    """(JAX student, its loss_fn with the teacher where distilling)."""
    module, cfg = jax_create_model(
        "dyvit_small_patch16_224", **DIMS, reduction_loc=LOC, keep_rate=KEEP,
        dyvit_distillation=args.dyvit_distill)
    teacher_apply = None
    if args.dyvit_distill:
        tmodule = jax_create_model("dyvit_small_patch16_224_teacher",
                                   **DIMS)[0]
        tparams = flax_params("dyvit_small_patch16_224_teacher", 1)

        def teacher_apply(images):
            return jax.lax.stop_gradient(
                tmodule.apply({"params": tparams}, images, train=False))

    base = jax_loop.build_base_criterion(args, False, False)
    return module, jax_loop.build_loss_fn(args, cfg, base, teacher_apply)


def port_side(args, params):
    """(port student over ``params``, its loss_fn with the teacher, which
    takes the JAX teacher's weights through the bridge)."""
    model, cfg = create_model(
        "dyvit_small_patch16_224", device="cpu", **DIMS, reduction_loc=LOC,
        keep_rate=KEEP, dyvit_distillation=args.dyvit_distill)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    teacher_apply = None
    if args.dyvit_distill:
        teacher, _ = create_model("dyvit_small_patch16_224_teacher",
                                  device="cpu", **DIMS)
        teacher.load_state_dict(state_dict_from_flax(
            flax_params("dyvit_small_patch16_224_teacher", 1)), strict=True)
        teacher_apply = loop.make_teacher_apply(teacher)
    base = loop.build_base_criterion(args, False, False)
    return model, loop.build_loss_fn(args, cfg, base, teacher_apply)


def batch(seed=11):
    data = np.random.default_rng(seed)
    x = data.standard_normal((B, 3, 32, 32)).astype(np.float32)
    return x, data.integers(0, 11, B)


def rngs():
    return {name: jax.random.PRNGKey(i)
            for i, name in enumerate(("dropout", "droppath", "gumbel"))}


@pytest.mark.parametrize("case", ["plain", "distill", "distill mse_token"])
def test_training_forward_loss_and_gradients_match_jax(monkeypatch, case):
    """The forward's outputs, the loss and every gradient leaf; the
    decisions' one-hots equal exactly (the same uniforms, the same
    argmax)."""
    args = args_for("distill" in case, "mse_token" in case)
    share_uniforms(monkeypatch, gumbel_draws(2))
    params = flax_params("dyvit_small_patch16_224", 0)
    x, y = batch()
    module, jax_loss_fn = jax_side(args)

    def jax_loss(p):
        out = module.apply({"params": p}, jnp.asarray(x.transpose(0, 2, 3, 1)),
                           train=True, rngs=rngs())
        return jax_loss_fn(out, jnp.asarray(y),
                           jnp.asarray(x.transpose(0, 2, 3, 1)), p), out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(jax_loss,
                                                       has_aux=True))(params)
    model, loss_fn = port_side(args, params)
    model.train()
    outs = []

    def port_loss(out, *rest):
        outs.append(out)
        return loss_fn(out, *rest)

    p = {n: t.detach().clone().requires_grad_()
         for n, t in model.named_parameters()}
    loss, grads = step.loss_and_grads(
        model, port_loss, p, torch.from_numpy(x), torch.from_numpy(y),
        step.StepConfig(), torch.Generator().manual_seed(0))
    out = outs[0]
    assert len(out) == len(jout) == (4 if args.dyvit_distill else 2)
    decisions, jdecisions = out[-1], jout[-1]
    assert len(decisions) == len(jdecisions) == len(LOC)
    for d, jd in zip(decisions, jdecisions):
        np.testing.assert_array_equal(d.detach().numpy().round(),
                                      np.asarray(jd).round())
        assert_close(d, jd)
    kept = sum(float(d.detach().round().sum()) for d in decisions)
    assert 0 < kept < len(LOC) * B * PATCHES
    for i, (o, jo) in enumerate(zip(out[:-1], jout[:-1])):
        assert_close(o, jo, err_msg=f"output {i}")
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(grads) == sorted(want)
    for n, w in want.items():
        assert_close(grads[n], w.numpy(), err_msg=n)


def test_two_train_steps_match_jax(monkeypatch):
    """Two steps of bench.py's recipe (the score predictors at full LR)
    with dyvit_distill and the teacher, the same uniforms in each step:
    the losses, grad norms, params and EMA params of JAX's
    make_train_step."""
    args = args_for(True)
    share_uniforms(monkeypatch, gumbel_draws(3))
    start = flax_params("dyvit_small_patch16_224", 0)
    module, jax_loss_fn = jax_side(args)
    params = jax.tree_util.tree_map(jnp.asarray, start)
    tx, _ = jax_optim.create_optimizer(
        params, jax_optim.OptimConfig(**RECIPE), lambda s: 1e-3,
        module.new_module_names(), steps_per_epoch=100)
    cfg = dict(ema_decay=0.99996)
    train_step = jax.jit(jax_step.make_train_step(
        lambda p, im, train, r: module.apply({"params": p}, im, train=train,
                                             rngs=r),
        jax_loss_fn, tx, jax_step.StepConfig(
            **cfg, rng_streams=("dropout", "droppath", "gumbel"))))
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params))

    model, loss_fn = port_side(args, start)
    opt, _ = optim.create_optimizer(dict(model.named_parameters()),
                                    optim.OptimConfig(**RECIPE),
                                    lambda s: 1e-3, model.new_module_names(),
                                    steps_per_epoch=100)
    state = step.init_train_state(model, opt, ema=True, device="cpu")
    port_step = step.make_train_step(model, loss_fn, opt,
                                     step.StepConfig(**cfg),
                                     torch.Generator().manual_seed(0))
    for i in range(2):
        x, y = batch(20 + i)
        jstate, jm = train_step(
            jstate, {"image": jnp.asarray(x.transpose(0, 2, 3, 1)),
                     "label": jnp.asarray(y)}, jax.random.PRNGKey(i))
        state, m = port_step(state, {"image": torch.from_numpy(x),
                                     "label": torch.from_numpy(y)})
        for k in ("loss", "grad_norm"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), \
                (i, k)
    assert state.step == 2
    for got, tree in ((state.params, jstate.params),
                      (state.ema_params, jstate.ema_params)):
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        for n, w in want.items():
            assert_close(got[n], w.numpy(), err_msg=n)


def test_policy_halves_follow_the_jax_gates(monkeypatch):
    """Under a policy (every block of a DyViT training forward) the
    attention halves take the policy softmax, never
    ``attend_branch_train`` or the attention core, and every MLP half
    takes ``mlp_branch``; in eval the policy-free path is unchanged."""
    calls = {"attend": 0, "core": 0, "mlp": 0, "policy": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    for name, attr in (("attend", "attend_branch_train"),
                       ("core", "attention_core_train"),
                       ("mlp", "mlp_branch"),
                       ("policy", "softmax_with_policy")):
        monkeypatch.setattr(layers, attr, counted(name, getattr(layers, attr)))
    model, _ = port_side(args_for(False),
                         flax_params("dyvit_small_patch16_224", 0))
    x = torch.from_numpy(batch()[0])
    model.train()(x, generator=torch.Generator().manual_seed(0))
    assert calls == {"attend": 0, "core": 0, "mlp": 4, "policy": 4}
    with torch.no_grad():
        model.eval()(x)
    assert calls == {"attend": 0, "core": 0, "mlp": 4, "policy": 4}
