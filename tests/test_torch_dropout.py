"""Dropout in the port draws its masks from the forward's generator, fp32
on the CPU.

JAX draws every dropout mask from the step's ``make_rng("dropout")``
(``core/layers.py:320-331``): a train step is a function of its key. The
port's ``Dropout`` (``pos_drop``, ``Attention.attn_drop`` and
``proj_drop``, ``Mlp.drop``) draws from the ``torch.Generator`` handed to
the model's forward, as ``DropPath`` does, and raises in training without
one. Inverted scaling as in timm: kept elements are divided by 1 - p.

The generator's numbers are not JAX's, so with dropout above 0 the tests
hold the port to its own generator: the same seed gives the same bits,
another seed other ones. With dropout at 0 the training forward is held
against the JAX model's (one Flax init through the weight bridge, the same
seeded numpy images) at rtol = atol = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.core.layers import Dropout
from tokenreduction_tpu_torch.models.convert import state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401

DIMS = dict(num_classes=11, img_size=32, embed_dim=64, num_heads=1, depth=4,
            patch_size=8)
REDUCE = dict(reduction_loc=(1, 2), keep_rate=(0.7,))
# ATS refuses attention dropout (as the JAX package does)
MODELS = {
    "dense": ("deit_small_patch16_224_local", {}, 0.1),
    "topk": ("topk_small_patch16_224", REDUCE, 0.1),
    "tome": ("tome_small_patch16_224", REDUCE, 0.1),
    "heuristic": ("heuristic_small_patch16_224", REDUCE, 0.1),
    "ats": ("ats_small_patch16_224", REDUCE, 0.0),
}


def images(b=2, seed=7):
    x = np.random.default_rng(seed).standard_normal((b, 3, 32, 32)) \
        .astype(np.float32)
    return x, x.transpose(0, 2, 3, 1)


def test_dropout_layer():
    """Inverted dropout from the generator; eval and rate 0 pass x
    through; training without a generator raises."""
    layer = Dropout(0.5).train()
    x = torch.ones(64, 64)
    a = layer(x, torch.Generator().manual_seed(3))
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < float((a == 0).float().mean()) < 0.6
    assert torch.equal(a, layer(x, torch.Generator().manual_seed(3)))
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        layer(x)
    assert torch.equal(layer.eval()(x), x)
    assert torch.equal(Dropout(0.0).train()(x), x)


@pytest.mark.parametrize("label", sorted(MODELS))
def test_train_forward_follows_its_generator(label):
    """drop_rate 0.1 (and attn_drop_rate 0.1 where the model takes it):
    the same seed gives the same output, another seed another one, and no
    generator raises."""
    name, kw, attn_drop = MODELS[label]
    model, _ = create_model(name, device="cpu", drop_rate=0.1,
                            attn_drop_rate=attn_drop, **DIMS, **kw)
    model.train()
    x = torch.from_numpy(images()[0])

    def run(seed):
        return model(x, generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        model(x)


@pytest.mark.parametrize("label", ["dense", "topk"])
def test_zero_dropout_train_forward_matches_jax(label):
    """With every rate at 0 the training forward draws nothing and gives
    JAX's training logits."""
    name, kw, _ = MODELS[label]
    jmodel, _ = jax_create_model(name, **DIMS, **kw)
    variables = jax.jit(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)),
        train=False))()
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model, _ = create_model(name, device="cpu", **DIMS, **kw)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    x_nchw, x_nhwc = images()
    key = jax.random.PRNGKey(1)
    ref = jmodel.apply({"params": params}, jnp.asarray(x_nhwc), train=True,
                       rngs={"dropout": key, "droppath": key})
    with torch.no_grad():
        out = model.train()(torch.from_numpy(x_nchw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
