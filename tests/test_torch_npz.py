"""The port's Brain-Flax ``.npz`` route (models/convert.py
``load_jax_npz_state``, ``convert_jax_npz``, ``state_dict_from_flax``)
against the JAX package's, on the CPU.

A seeded Flax DeiT at the tiny widths is written in the Brain-Flax layout
by the JAX tests' own inverse mapping (tests/test_npz_loader.py), with
and without the ``opt/target/`` prefix and with 1x1x1xN biases; each side
converts the file and loads it into its model. The logits agree within
1e-5 of max|JAX| (fp32; the port's exact erf against JAX's CPU path), the
skipped names are the same, and both refuse a file with no encoder
blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_npz_loader import _params_to_brain_npz
from tokenreduction_tpu.models import convert as jax_convert
from tokenreduction_tpu.models.registry import create_model as jax_create
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.models import convert
from torch_threads import one_torch_thread  # noqa: F401

DIMS = dict(num_classes=5, img_size=32, embed_dim=64, num_heads=1, depth=3,
            patch_size=8)


@pytest.fixture(scope="module")
def seeded():
    module, _ = jax_create("deit_small_patch16_224_local", **DIMS)
    v = jax.jit(lambda: module.init({"params": jax.random.PRNGKey(0)},
                                    jnp.zeros((1, 32, 32, 3)),
                                    train=False))()
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), v["params"])
    return module, params


def write_npz(path, params, prefix="", squash=False):
    state = _params_to_brain_npz(params, DIMS["num_heads"], prefix)
    if squash:  # a 1x1x1xN "conv" bias, as some Brain files hold
        key = prefix + "embedding/bias"
        state[key] = state[key].reshape(1, 1, 1, -1)
    state[prefix + "pre_logits/kernel"] = np.zeros((2, 2), np.float32)
    np.savez(path, **state)
    return path


@pytest.mark.parametrize("prefix,squash", [("", False),
                                           ("opt/target/", True)])
def test_npz_route_gives_jax_logits(tmp_path, seeded, prefix, squash):
    module, params = seeded
    path = write_npz(str(tmp_path / "vit.npz"), params, prefix, squash)
    jtree, jskipped = jax_convert.convert_jax_npz(
        jax_convert.load_jax_npz_state(path))
    merged, _ = jax_convert.merge_pretrained(
        jax.tree_util.tree_map(np.zeros_like, params), jtree)
    x = np.random.default_rng(2).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: module.apply(
        {"params": p}, x, train=False))(merged, jnp.asarray(x)))

    tree, skipped = convert.convert_jax_npz(convert.load_jax_npz_state(path))
    assert skipped == jskipped == [prefix + "pre_logits/kernel"]
    model, _ = create_model("deit_small_patch16_224_local", device="cpu",
                            **DIMS)
    state, report = convert.merge_pretrained(
        model.state_dict(), convert.state_dict_from_flax(tree))
    assert not report["missing_in_ckpt"] and not report["shape_mismatch"]
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_non_vit_npz_is_refused_by_both(tmp_path, seeded):
    """A file with a ViT's stem and head but no encoder blocks (a hybrid
    backbone's layout) raises ValueError on both sides."""
    state = _params_to_brain_npz(seeded[1], DIMS["num_heads"])
    state = {k: v for k, v in state.items() if "encoderblock_" not in k}
    state["Transformer/block1/unit1/conv1/kernel"] = np.zeros((1, 1, 3, 4))
    path = str(tmp_path / "hybrid.npz")
    np.savez(path, **state)
    for mod in (jax_convert, convert):
        with pytest.raises(ValueError, match="not a Brain-Flax ViT"):
            mod.convert_jax_npz(mod.load_jax_npz_state(path))
