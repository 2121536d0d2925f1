"""Shared helpers of the eval-slice tests (tests/test_torch_{checkpoint,
validate,extract,artifact_chain}.py): checkpoint pairs made from one Flax
init (the JAX package's Orbax checkpoint, then the port's through the
weight bridge) and the viz-JSON comparison."""

import json

import jax
import jax.numpy as jnp
import numpy as np

from tokenreduction_tpu import create_model as jax_create_model
from tokenreduction_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from tokenreduction_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from tokenreduction_tpu_torch.models.convert import state_dict_from_flax
from tokenreduction_tpu_torch.utils.checkpoint import (
    config_from_meta,
    save_checkpoint,
)

# tiny widths shared by the eval tests: 32 px, 16 patches of 8 px
TINY = dict(num_classes=7, img_size=32, embed_dim=32, num_heads=2, depth=5,
            patch_size=8)
DATA = ["--dataset", "synthetic", "--synthetic-n", "16", "--input-size",
        "32", "-b", "8"]


def flax_params(name, seed=0, **kw):
    """(Flax params, cfg) of a JAX registry name, initialised from
    PRNGKey(seed)."""
    module, cfg = jax_create_model(name, **kw)
    x = jnp.ones((1, kw["img_size"], kw["img_size"], 3))
    params = jax.jit(lambda: module.init(
        {"params": jax.random.PRNGKey(seed)}, x, train=False))()["params"]
    return params, cfg


def checkpoint_pair(root, name, *, ema_best=False, seed=0, **kw):
    """Write the JAX checkpoint ``root/jax/<run>/best_checkpoint`` (Orbax)
    of a Flax init of ``name`` and, from it through the JAX package's
    load_checkpoint and the weight bridge, the port's
    ``root/port/<run>/best_checkpoint``; returns (jax run dir, port run
    dir). The params are initialised from ``seed``; with ``ema_best`` the
    EMA params are a second init (seed + 1) and meta says the EMA was
    best."""
    run = kw.pop("run", name)
    params, cfg = flax_params(name, seed, **kw)
    ema = flax_params(name, seed + 1, **kw)[0] if ema_best else None
    jax_dir, port_dir = root / "jax" / run, root / "port" / run
    jax_save_checkpoint(str(jax_dir / "best_checkpoint"), params=params,
                        ema_params=ema, epoch=1, step=2, model_cfg=cfg,
                        run_args={"model": name}, ema_best=ema_best,
                        max_accuracy=12.5)
    port_checkpoint_from_jax(jax_dir, port_dir)
    return jax_dir, port_dir


def port_checkpoint_from_jax(jax_dir, port_dir):
    """The port's checkpoint of a JAX run dir: its params (and EMA
    params) through state_dict_from_flax, its meta as it is."""
    tree, meta = jax_load_checkpoint(str(jax_dir / "best_checkpoint"))
    ema = tree.get("ema_params")
    save_checkpoint(
        str(port_dir / "best_checkpoint"),
        params=state_dict_from_flax(tree["params"]),
        ema_params=None if ema is None else state_dict_from_flax(ema),
        epoch=meta["epoch"], step=meta["step"],
        model_cfg=config_from_meta(meta), run_args=meta["run_args"],
        ema_best=meta["ema_best"], max_accuracy=meta["max_accuracy"])


def read_json(path):
    with open(path) as f:
        return json.load(f)


def assert_viz_equal(want, got, tol=1e-4):
    """The port's viz JSON (as read back) against JAX's: the same keys in
    the same order; per image the same Target, Predictions (top-5 ids:
    equal; multilabel probabilities: within tol), Loss within tol, and
    every Stage-* entry (Kept_Token, Assignment_Maps) equal, in order;
    the header and Top1-Acc, Top5-Acc and Params equal."""
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if not isinstance(w, dict):
            assert g == w, key
            continue
        assert list(g) == list(w), key
        assert g["Target"] == w["Target"], key
        preds_w = np.asarray(w["Predictions"])
        if preds_w.dtype.kind == "f":
            np.testing.assert_allclose(g["Predictions"], preds_w, rtol=0,
                                       atol=tol, err_msg=key)
        else:
            assert g["Predictions"] == w["Predictions"], key
        assert abs(g["Loss"] - w["Loss"]) <= tol, key
        for stage in w:
            if stage.startswith("Stage-"):
                assert g[stage] == w[stage], (key, stage)
