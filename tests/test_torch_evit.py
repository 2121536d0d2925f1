"""The port's EViT against the JAX package, fp32 on the CPU.

The gather ops get the same seeded ids on both sides: ``complement_idx``
(with and without 0 among the selected ids, the two ways the zeros sort
to the front) and ``take_rows`` on both axes, exactly. The model is held
as tests/test_torch_heuristic.py holds heuristic: one Flax init through
the weight bridge, the same seeded numpy images, logits and ``Features``
within 1e-4, ``Kept_Tokens`` (with the ``-1`` sentinel of the fused
token) and ``Fusion_Assign`` exactly, in viz mode (the plain composition)
and without it (the kernel wrappers' plain versions). Training: the loss
and every gradient leaf within 1e-4 of the leaf's max against
``jax.value_and_grad``; the fused token's gradient reaches the attention
branch through its CLS row (a non-zero row0 cotangent).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.ops import gather as jax_gather
from tokenreduction_tpu.train import losses as jax_losses
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.core import layers
from tokenreduction_tpu_torch.models.convert import state_dict_from_flax
from tokenreduction_tpu_torch.ops import gather
from tokenreduction_tpu_torch.train import losses, step
from torch_threads import one_torch_thread  # noqa: F401

DIMS = dict(num_classes=11, embed_dim=64, num_heads=1, depth=4, patch_size=8,
            img_size=32)
LOC = (1, 2)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_zero", [False, True])
def test_complement_idx_matches_jax(with_zero):
    rng = np.random.default_rng(3)
    idx = np.stack([rng.permutation(np.arange(1, 20))[:7] for _ in range(3)])
    if with_zero:
        idx[:, 2] = 0
    idx = idx.astype(np.int32)
    want = jax_gather.complement_idx(jnp.asarray(idx), 20)
    got = gather.complement_idx(torch.from_numpy(idx), 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert all(sorted(set(range(20)) - set(r)) == list(g)
               for r, g in zip(idx.tolist(), got.tolist()))


@pytest.mark.parametrize("axis", [1, 2])
def test_take_rows_matches_jax(axis):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 9)).astype(np.float32)
    idx = rng.integers(0, 9, (2, 5)).astype(np.int32)
    want = jax_gather.take_rows(jnp.asarray(x), jnp.asarray(idx), axis)
    got = gather.take_rows(torch.from_numpy(x), torch.from_numpy(idx), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def jax_model(**kw):
    return jax_create_model("evit_small_patch16_224", **DIMS,
                            reduction_loc=LOC, **kw)[0]


@functools.lru_cache(maxsize=None)
def init_params():
    module = jax_model(keep_rate=(0.7,))
    variables = jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)),
        train=False))()
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def port_model(params, **kw):
    model, _ = create_model("evit_small_patch16_224", device="cpu", **DIMS,
                            reduction_loc=LOC, **kw)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def images(b=2, seed=7):
    x = np.random.default_rng(seed).standard_normal(
        (b, 3, 32, 32)).astype(np.float32)
    return x, x.transpose(0, 2, 3, 1)


# keep 0.7: 11 then 7 of 16 patches; keep 1.0: no pruning (left >= N - 1,
# the block's MLP half without a gather); keep (0.5, 0.95): the second
# stage keeps 15 of the 9 patches left, so it runs no gather either
@pytest.mark.parametrize("keep", [(0.7,), (1.0,), (0.5, 0.95)])
def test_logits_and_viz_match_jax(keep):
    params = init_params()
    x_nchw, x_nhwc = images()
    ref, ref_viz = jax.jit(lambda p, x: jax_model(
        keep_rate=keep, viz_mode=True).apply({"params": p}, x, train=False))(
        params, jnp.asarray(x_nhwc))
    model = port_model(params, keep_rate=keep, viz_mode=True).eval()
    with torch.no_grad():
        out, viz = model(torch.from_numpy(x_nchw))
        plain = port_model(params, keep_rate=keep).eval()(
            torch.from_numpy(x_nchw))
    assert sorted(viz) == sorted(ref_viz)
    for key in ("Kept_Tokens", "Fusion_Assign"):
        assert sorted(viz[key]) == sorted(ref_viz[key])
        for i, k in ref_viz[key].items():
            np.testing.assert_array_equal(viz[key][i].numpy(), np.asarray(k))
    for i, k in viz["Kept_Tokens"].items():
        # the kept ids, then -1; kept and fused cover the patches once
        assert (k[:, -1] == -1).all()
        fused = viz["Fusion_Assign"][i]
        n = k.shape[1] - 1 + fused.shape[1]
        for kept_row, fused_row in zip(k[:, :-1].tolist(), fused.tolist()):
            assert sorted(kept_row + fused_row) == list(range(n))
    assert sorted(viz["Features"]) == sorted(ref_viz["Features"])
    for i, feat in ref_viz["Features"].items():
        np.testing.assert_allclose(viz["Features"][i].numpy(),
                                   np.asarray(feat), **MODEL_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MODEL_TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **MODEL_TOL)


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
    """The training forward (every attention half through
    ``attend_branch_train``, whose CLS row carries the fused token's
    gradient, every MLP half through ``mlp_branch``, their plain versions
    on the CPU) against jax.value_and_grad: the loss and every gradient
    leaf within 1e-4 of the leaf's max."""
    start, x, y = train_case()
    module = jax_model(keep_rate=(0.7,))

    def jax_loss(p):
        out = module.apply({"params": p}, jnp.asarray(x.transpose(0, 2, 3, 1)),
                           train=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_losses.label_smoothing_ce(out, jnp.asarray(y), 0.1)

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(
        jax.tree_util.tree_map(jnp.asarray, start))
    model = port_model(start, keep_rate=(0.7,)).train()
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


def test_fused_token_pulls_a_gradient_through_row0(monkeypatch):
    """In training every attention half takes ``attend_branch_train`` and
    every MLP half ``mlp_branch`` (the JAX gates); the reduction blocks'
    CLS rows get a non-zero cotangent (the fused token's weights), the
    other blocks' none."""
    calls = {"attend": 0, "core": 0, "mlp": 0}
    row0s = []

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            out = fn(*a, **kw)
            if name == "attend":
                out[1].retain_grad()
                row0s.append(out[1])
            return out
        return run

    for name, attr in (("attend", "attend_branch_train"),
                       ("core", "attention_core_train"),
                       ("mlp", "mlp_branch")):
        monkeypatch.setattr(layers, attr, counted(name, getattr(layers, attr)))
    model = port_model(init_params(), keep_rate=(0.7,)).train()
    model(torch.from_numpy(images()[0])).sum().backward()
    assert calls == {"attend": 4, "core": 0, "mlp": 4}
    pulled = [r.grad is not None and bool(r.grad.abs().sum() > 0)
              for r in row0s]
    assert pulled == [i in LOC for i in range(4)]
