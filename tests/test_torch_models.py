"""The port's models against the JAX models and the torch oracles, fp32 CPU.

The Flax model is initialised once from a seed; its params go through the
weight bridge (models/convert.py) into the port, and both sides see the
same seeded numpy images (NHWC to JAX, NCHW to the port). On a CPU tensor
every kernel wrapper of the port runs its plain version.

Logits are held at rtol = atol = 2e-4, the TOL of tests/test_parity.py,
and the top-k decisions (``Kept_Tokens``) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.models.convert import convert_torch_state_dict
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.models.convert import state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401

DEPTH, DIM, HEADS, PATCH, NCLS = 4, 64, 1, 8, 11
IMG = 32  # 4x4 = 16 patches
NTOK = 16
LOC = (1, 2)
TOL = dict(rtol=2e-4, atol=2e-4)
DIMS = dict(num_classes=NCLS, img_size=IMG, embed_dim=DIM, num_heads=HEADS,
            depth=DEPTH, patch_size=PATCH)

CASES = {
    "dense": ("deit_small_patch16_224_local", {}),
    "topk@0.7": ("topk_small_patch16_224",
                 dict(reduction_loc=LOC, keep_rate=(0.7,), viz_mode=True)),
    "topk@0.25": ("topk_small_patch16_224",
                  dict(reduction_loc=LOC, keep_rate=(0.25,), viz_mode=True)),
}


@pytest.fixture(scope="module")
def flax_params():
    """One Flax init (dense and topk share the param tree), as numpy."""
    module, _ = jax_create_model("deit_small_patch16_224_local", **DIMS)
    x = jnp.zeros((1, IMG, IMG, 3))
    variables = module.init({"params": jax.random.PRNGKey(0)}, x,
                            train=False)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def images(seed=7, b=2):
    x = np.random.default_rng(seed).standard_normal((b, 3, IMG, IMG)) \
        .astype(np.float32)
    return x, x.transpose(0, 2, 3, 1)


def port_model(name, state, **kw):
    model, _ = create_model(name, device="cpu", **DIMS, **kw)
    model.load_state_dict(state, strict=True)
    return model.eval()


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_and_kept_tokens_match_jax(flax_params, case):
    name, kw = CASES[case]
    jmodel, _ = jax_create_model(name, **DIMS, **kw)
    model = port_model(name, state_dict_from_flax(flax_params), **kw)
    x_nchw, x_nhwc = images()
    ref = jmodel.apply({"params": flax_params}, jnp.asarray(x_nhwc),
                       train=False)
    with torch.no_grad():
        out = model(torch.from_numpy(x_nchw))
    if kw.get("viz_mode"):
        (ref, ref_viz), (out, viz) = ref, out
        assert sorted(viz["Kept_Tokens"]) == sorted(ref_viz["Kept_Tokens"])
        for i, kept in ref_viz["Kept_Tokens"].items():
            np.testing.assert_array_equal(viz["Kept_Tokens"][i].numpy(),
                                          np.asarray(kept))
        for i, feat in ref_viz["Features"].items():
            np.testing.assert_allclose(viz["Features"][i].numpy(),
                                       np.asarray(feat), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("keep", [0.7, 0.25])
def test_timm_state_dict_loads_strict_and_matches_oracle(keep):
    """A timm-named state dict (tests/oracles.py) loads with
    load_state_dict(strict=True) and matches the independent torch
    oracle's logits and kept tokens."""
    state = O.make_vit_state(DEPTH, DIM, HEADS, PATCH, NCLS, seed=1,
                             n_tokens=NTOK)
    model = port_model("topk_small_patch16_224", state, reduction_loc=LOC,
                       keep_rate=(keep,), viz_mode=True)
    x, _ = images()
    xt = torch.from_numpy(x)
    counts = [int(keep ** (s + 1) * NTOK) for s in range(len(LOC))]
    ref, kept = O.topk_forward(state, xt, DEPTH, HEADS, DIM, PATCH,
                               list(LOC), counts)
    with torch.no_grad():
        out, viz = model(xt)
    np.testing.assert_allclose(out.numpy(), O.np32(ref), **TOL)
    for i in LOC:
        np.testing.assert_array_equal(viz["Kept_Tokens"][i].numpy(),
                                      kept[i].numpy())


@pytest.mark.parametrize("distilled", [False, True])
def test_bridge_round_trips_timm_state(distilled):
    """state_dict_from_flax inverts convert_torch_state_dict exactly."""
    state = O.make_vit_state(DEPTH, DIM, HEADS, PATCH, NCLS, seed=2,
                             num_prefix=2 if distilled else 1,
                             n_tokens=NTOK)
    tree, skipped = convert_torch_state_dict(
        {k: v.numpy() for k, v in state.items()})
    assert not skipped
    back = state_dict_from_flax(tree)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k


def test_bridge_rejects_unknown_params():
    with pytest.raises(KeyError, match="no torch name"):
        state_dict_from_flax({"blocks_0": {"gate": {"kernel": np.zeros(2)}}})


def test_distilled_dense_matches_oracle():
    """DeiT-distilled backbone: dist token in the prefix, eval logits the
    mean of both heads (reference deit_viz.py distilled forward)."""
    state = O.make_vit_state(DEPTH, DIM, HEADS, PATCH, NCLS, seed=3,
                             num_prefix=2, n_tokens=NTOK)
    model = port_model("deit_small_patch16_224_local", state,
                       distilled=True)
    x, _ = images()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = model(xt)
    ref = O.dense_forward(state, xt, DEPTH, HEADS, DIM, PATCH)
    np.testing.assert_allclose(out.numpy(), O.np32(ref), **TOL)


def test_train_mode_runs_plain_composition_with_grads():
    """In training the blocks run the training branches under autograd
    (on the CPU their plain forward and hand-written backward); they agree
    with the eval path at zero drop rates."""
    state = O.make_vit_state(DEPTH, DIM, HEADS, PATCH, NCLS, seed=4,
                             n_tokens=NTOK)
    model = port_model("topk_small_patch16_224", state, reduction_loc=LOC,
                       keep_rate=(0.7,))
    x = torch.from_numpy(images()[0])
    with torch.no_grad():
        ref = model(x)
    model.train()
    out = model(x)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), **TOL)
    assert model.blocks[0].attn.qkv.weight.grad is not None
