"""The port's heuristic pruning and masked training core against the JAX
package, fp32 on the CPU.

``attention_core_train`` with the validity mask (alone, and with a
per-key bias) runs its plain forward and its plain hand-written backward
on CPU tensors; the JAX custom-VJP Pallas kernel runs in interpret mode
through ``jax.vjp``. Both get the same seeded inputs, a mask with a fully
masked query row (uniform over all N keys) and non-zero cotangents of
out, row0 and colsum: every output and gradient within rtol = atol =
1e-5. The plain backward is also held against torch.autograd of the
plain forward at 1e-5.

The model is held as tests/test_torch_ats.py holds ATS: one Flax init
through the weight bridge, the same seeded images, logits and
``Features`` within 1e-4 and ``Kept_Tokens_Abs`` exactly, in every
pattern (l1, l2, linf) and both modes (contiguous, not_contiguous), and
on an odd-sided patch grid (P = 5, where the reference's grid
``linspace((-P)//2, P//2, P)`` is asymmetric). One train step: the loss
and every gradient leaf within 1e-4 of its max, then the updated params.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.ops import heuristic as jax_heuristic_ops
from tokenreduction_tpu.ops.flash_attention_train import (
    attention_core_train as jax_attention_core,
)
from tokenreduction_tpu.reduction.heuristic import (
    heuristic_masks as jax_heuristic_masks,
)
from tokenreduction_tpu.train import losses as jax_losses
from tokenreduction_tpu.train import optim as jax_optim
from tokenreduction_tpu.train import step as jax_step
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.core.config import ViTConfig
from tokenreduction_tpu_torch.models.convert import state_dict_from_flax
from tokenreduction_tpu_torch.ops import heuristic as heuristic_ops
from tokenreduction_tpu_torch.ops.flash_attention import fused_attention_ref
from tokenreduction_tpu_torch.ops.flash_attention_train import (
    attention_core_train,
    attention_core_train_bwd_ref,
)
from tokenreduction_tpu_torch.reduction.heuristic import heuristic_masks
from tokenreduction_tpu_torch.train import losses, optim, step
from torch_threads import one_torch_thread  # noqa: F401

DIMS = dict(num_classes=11, embed_dim=64, num_heads=1, depth=4, patch_size=8)
LOC = (1, 2)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
B, H = 3, 2


def core_inputs(N, hd, seed, with_bias):
    """q, k, v [B, H, N, hd], a ToMe-like bias [B, N] (or None), a mask
    [B, N] with CLS valid and token N // 2 off in every image (a fully
    masked query row), and the cotangents of out, row0 and colsum."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    bias = np.log(rng.integers(1, 5, (B, N))).astype(np.float32) \
        if with_bias else None
    mask = rng.uniform(size=(B, N)) > 0.3
    mask[:, 0] = True
    mask[:, N // 2] = False
    return ([r(B, H, N, hd) for _ in range(3)], bias, mask,
            (r(B, H, N, hd), r(B, H, N), r(B, H, N)))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("N,hd", [(12, 16), (17, 16), (12, 64), (17, 64)])
def test_masked_attention_core_train_matches_jax(N, hd, with_bias):
    qkv, bias, mask, cots = core_inputs(N, hd, N + hd, with_bias)
    scale = hd ** -0.5
    jmask = jnp.asarray(mask)
    inputs = [*qkv] + ([bias] if with_bias else [])

    def jax_core(q, k, v, b=None):
        return jax_attention_core(q, k, v, scale, b, jmask, True)

    outs_ref, vjp = jax.vjp(jax_core, *map(jnp.asarray, inputs))
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    outs = attention_core_train(*leaves[:3], scale,
                                leaves[3] if with_bias else None,
                                torch.from_numpy(mask))
    for got, want in zip(outs, outs_ref):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **KERNEL_TOL)
    grads = torch.autograd.grad(outs, leaves,
                                tuple(map(torch.from_numpy, cots)))
    want = vjp(tuple(map(jnp.asarray, cots)))
    assert len(grads) == len(want) == len(inputs)
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **KERNEL_TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_masked_bwd_ref_matches_autograd(with_bias):
    qkv, bias, mask, cots = core_inputs(17, 16, 5, with_bias)
    leaves = [torch.from_numpy(a).requires_grad_() for a in qkv]
    b = torch.from_numpy(bias).requires_grad_() if with_bias else None
    mask = torch.from_numpy(mask)
    cots = tuple(map(torch.from_numpy, cots))
    inputs = leaves + ([b] if with_bias else [])
    want = torch.autograd.grad(
        fused_attention_ref(*leaves, 0.25, bias=b, mask=mask), inputs, cots)
    dq, dk, dv, dbias = attention_core_train_bwd_ref(
        *leaves, b, *cots, 0.25, mask)
    got = (dq, dk, dv) + ((dbias.sum(1),) if with_bias else ())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(),
                                   **KERNEL_TOL)


def test_fully_masked_row_takes_no_gradient_but_feeds_dv():
    """A fully masked query row attends uniformly: its dq is zero, yet its
    output's cotangent reaches every value row (dV = P^T dO)."""
    qkv, _, mask, cots = core_inputs(12, 16, 9, False)
    dead = 12 // 2
    cots[0][:] = 0.0
    cots[0][:, :, dead] = 1.0  # a cotangent on the dead row's output alone
    cots[1][:] = 0.0
    cots[2][:] = 0.0
    dq, dk, dv, _ = attention_core_train_bwd_ref(
        *map(torch.from_numpy, qkv), None, *map(torch.from_numpy, cots),
        0.25, torch.from_numpy(mask))
    assert dq.abs().max() == 0 and dk.abs().max() == 0
    np.testing.assert_allclose(dv.numpy(), np.full(dv.shape, 1 / 12),
                               rtol=1e-6)


def test_heuristic_ops_is_a_verbatim_copy():
    """ops/heuristic.py is copied, not imported: below the module
    docstring the two files are equal."""
    def body(module):
        text = open(module.__file__).read()
        return text[text.index('"""', 3) + 3:]

    assert body(heuristic_ops) == body(jax_heuristic_ops)


VARIANTS = {
    f"{pattern} {'subset' if not_contiguous else 'contiguous'}":
        dict(heuristic_pattern=pattern, not_contiguous=not_contiguous,
             keep_rate=(0.5,))
    for pattern in ("l1", "l2", "linf") for not_contiguous in (False, True)}
VARIANTS["odd grid"] = dict(keep_rate=(0.5,), img_size=40, min_radius=0.0)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_masks_match_jax(variant):
    kw = VARIANTS[variant]
    cfg = ViTConfig(**{**DIMS, "img_size": 32, **kw, "method": "heuristic",
                       "reduction_loc": LOC})
    got, want = heuristic_masks(cfg), jax_heuristic_masks(cfg)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert sorted(g) == sorted(w)
        for i in w:
            np.testing.assert_array_equal(g[i], w[i])


def jax_model(img_size=32, **kw):
    return jax_create_model("heuristic_small_patch16_224", **DIMS,
                            img_size=img_size, reduction_loc=LOC, **kw)[0]


@functools.lru_cache(maxsize=None)
def init_params(img_size=32):
    """One Flax init per patch grid (the masks add no parameters)."""
    module = jax_model(img_size)
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, img_size, img_size, 3)), train=False))()
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def port_model(params, img_size=32, **kw):
    model, _ = create_model("heuristic_small_patch16_224", device="cpu",
                            **DIMS, img_size=img_size, reduction_loc=LOC,
                            **kw)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def images(b=2, seed=7, img_size=32):
    x = np.random.default_rng(seed).standard_normal(
        (b, 3, img_size, img_size)).astype(np.float32)
    return x, x.transpose(0, 2, 3, 1)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_features_and_kept_tokens_match_jax(variant):
    kw = dict(VARIANTS[variant], viz_mode=True)
    img_size = kw.pop("img_size", 32)
    jmodel = jax_model(img_size, **kw)
    params = init_params(img_size)
    model = port_model(params, img_size=img_size, **kw).eval()
    x_nchw, x_nhwc = images(img_size=img_size)
    ref, ref_viz = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, train=False))(params, jnp.asarray(x_nhwc))
    with torch.no_grad():
        out, viz = model(torch.from_numpy(x_nchw))
    kept, ref_kept = viz["Kept_Tokens_Abs"], ref_viz["Kept_Tokens_Abs"]
    assert sorted(kept) == sorted(ref_kept) == model.reduction_count()
    for i, k in ref_kept.items():
        np.testing.assert_array_equal(kept[i].numpy(), np.asarray(k))
    assert sorted(viz["Features"]) == sorted(ref_viz["Features"])
    for i, feat in ref_viz["Features"].items():
        np.testing.assert_allclose(viz["Features"][i].numpy(),
                                   np.asarray(feat), **MODEL_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)


def test_masks_live_on_the_model_and_leave_the_state_dict():
    """The per-block masks are buffers made once (not in the state dict);
    the active blocks are JAX's reduction_count."""
    model = port_model(init_params(), keep_rate=(0.5,))
    assert not any(k.startswith(("mask_", "kept_"))
                   for k in model.state_dict())
    assert model.reduction_count() == jax_heuristic_masks(model.cfg)[0]
    assert all(getattr(model, f"mask_{i}").dtype == torch.bool
               for i in model.reduction_count())


RECIPE = dict(lr=1e-3, clip_grad=1.0, backbone_lr_scale=0.01)


def train_case():
    rng = np.random.default_rng(5)
    start = jax.tree_util.tree_map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(a.dtype),
        init_params())
    data = np.random.default_rng(11)
    x = data.standard_normal((4, 3, 32, 32)).astype(np.float32)
    y = data.integers(0, 11, 4)
    return start, x, y


def smoothing(out, t, *_):
    return losses.label_smoothing_ce(out, t, 0.1)


def test_train_loss_and_gradients_match_jax():
    """The training forward (the masked blocks through the attention core
    and its plain backward on the CPU) against jax.value_and_grad: loss
    and every gradient leaf within 1e-4 of the leaf's max."""
    start, x, y = train_case()
    module = jax_model(keep_rate=(0.5,))

    def jax_loss(p):
        out = module.apply({"params": p}, jnp.asarray(x.transpose(0, 2, 3, 1)),
                           train=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_losses.label_smoothing_ce(out, jnp.asarray(y), 0.1)

    jloss, jgrads = jax.value_and_grad(jax_loss)(
        jax.tree_util.tree_map(jnp.asarray, start))
    model = port_model(start, keep_rate=(0.5,))
    model.train()
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.named_parameters()}
    loss, grads = step.loss_and_grads(model, smoothing, params,
                                      torch.from_numpy(x),
                                      torch.from_numpy(y), step.StepConfig())
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(grads) == sorted(want)
    for n, w in want.items():
        tol = 1e-4 * float(w.abs().max())
        np.testing.assert_allclose(grads[n].numpy(), w.numpy(), rtol=0,
                                   atol=tol, err_msg=n)


def test_training_halves_follow_the_jax_gates(monkeypatch):
    """In training the attention halves before the first active block
    take ``attend_branch_train``, the masked ones the attention core with
    the mask; every MLP half takes ``mlp_branch``."""
    from tokenreduction_tpu_torch.core import layers

    calls = {"attend": 0, "core": 0, "mlp": 0}
    masks = []

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            if name == "core":
                masks.append(a[5])
            return fn(*a, **kw)
        return run

    for name, attr in (("attend", "attend_branch_train"),
                       ("core", "attention_core_train"),
                       ("mlp", "mlp_branch")):
        monkeypatch.setattr(layers, attr, counted(name, getattr(layers, attr)))
    model = port_model(init_params(), keep_rate=(0.5,))
    model.train()(torch.from_numpy(images()[0]))
    assert calls == {"attend": 1, "core": 3, "mlp": 4}
    assert all(m is not None and m.shape == (2, 17) for m in masks)


def test_train_step_matches_jax():
    """One step of bench.py's recipe: the same loss, grad norm, params
    and EMA params as JAX's make_train_step."""
    start, x, y = train_case()
    module = jax_model(keep_rate=(0.5,))
    params = jax.tree_util.tree_map(jnp.asarray, start)
    tx, _ = jax_optim.create_optimizer(
        params, jax_optim.OptimConfig(**RECIPE), lambda s: 1e-3, [],
        steps_per_epoch=100)
    train_step = jax.jit(jax_step.make_train_step(
        lambda p, im, train, rngs: module.apply({"params": p}, im,
                                                train=train, rngs=rngs),
        lambda out, t, i, p: jax_losses.label_smoothing_ce(out, t, 0.1), tx,
        jax_step.StepConfig(ema_decay=0.99996)))
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.copy, params))
    jstate, jm = train_step(
        jstate, {"image": jnp.asarray(x.transpose(0, 2, 3, 1)),
                 "label": jnp.asarray(y)}, jax.random.PRNGKey(0))

    model = port_model(start, keep_rate=(0.5,))
    opt, _ = optim.create_optimizer(dict(model.named_parameters()),
                                    optim.OptimConfig(**RECIPE),
                                    lambda s: 1e-3, [], steps_per_epoch=100)
    state = step.init_train_state(model, opt, ema=True, device="cpu")
    port_step = step.make_train_step(model, smoothing, opt,
                                     step.StepConfig(ema_decay=0.99996))
    state, m = port_step(state, {"image": torch.from_numpy(x),
                                 "label": torch.from_numpy(y)})
    for k in ("loss", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    for got, tree in ((state.params, jstate.params),
                      (state.ema_params, jstate.ema_params)):
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree))
        for n, w in want.items():
            tol = 1e-4 * float(w.abs().max())
            np.testing.assert_allclose(got[n].detach().numpy(), w.numpy(),
                                       rtol=0, atol=tol, err_msg=n)
