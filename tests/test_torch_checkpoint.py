"""The port's checkpoints (``utils/checkpoint.py``): tree.pt + meta.json
round-trip params, EMA params and the optimizer state, meta.json has the
JAX sidecar's keys, its config rebuilds the model, and a checkpoint made
from a JAX Orbax checkpoint through the weight bridge gives the port's
model the JAX model's logits."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tokenreduction_tpu.models.registry import (
    model_for_config as jax_model_for_config,
)
from tokenreduction_tpu.utils.checkpoint import (
    config_from_meta as jax_config_from_meta,
)
from tokenreduction_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from tokenreduction_tpu.utils.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.models.registry import model_for_config
from tokenreduction_tpu_torch.train.optim import OptimConfig, create_optimizer
from tokenreduction_tpu_torch.train.step import init_train_state
from tokenreduction_tpu_torch.utils.checkpoint import (
    config_from_meta,
    load_checkpoint,
    save_checkpoint,
)
from torch_eval_cases import TINY, checkpoint_pair
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(TINY, reduction_loc=(1, 3), keep_rate=(0.7,))


@pytest.fixture(scope="module")
def state():
    model, cfg = create_model("topk_small_patch16_224", device="cpu", **KW)
    opt, _ = create_optimizer(dict(model.named_parameters()),
                              OptimConfig(lr=1e-3), lambda s: 1e-3, [])
    state = init_train_state(model, opt, ema=True, device="cpu")
    for t in (*state.opt_state["mu"].values(), *state.ema_params.values()):
        t.normal_(generator=torch.Generator().manual_seed(3))
    return model, cfg, state


def test_round_trip(state, tmp_path):
    """params, ema_params and the optimizer state come back equal, on the
    CPU, with the meta as written; a checkpoint without EMA params or an
    optimizer state reads them back as None."""
    model, cfg, st = state
    save_checkpoint(str(tmp_path / "a"), params=st.params,
                    ema_params=st.ema_params, opt_state=st.opt_state,
                    epoch=3, step=40, model_cfg=cfg,
                    run_args={"model": "topk_small_patch16_224"},
                    ema_best=True, max_accuracy=71.25)
    tree, meta = load_checkpoint(str(tmp_path / "a"))
    assert sorted(tree) == ["ema_params", "opt_state", "params"]
    for got, want in ((tree["params"], st.params),
                      (tree["ema_params"], st.ema_params),
                      (tree["opt_state"]["mu"], st.opt_state["mu"]),
                      (tree["opt_state"]["nu"], st.opt_state["nu"])):
        assert list(got) == list(want)
        for name in want:
            assert got[name].device.type == "cpu"
            assert not got[name].requires_grad
            assert torch.equal(got[name], want[name].detach()), name
    assert (meta["epoch"], meta["step"], meta["ema_best"],
            meta["max_accuracy"], meta["run_args"]) == (
        3, 40, True, 71.25, {"model": "topk_small_patch16_224"})
    model.load_state_dict(tree["params"], strict=True)

    save_checkpoint(str(tmp_path / "b"), params=model.state_dict(),
                    model_cfg=cfg)
    tree, meta = load_checkpoint(str(tmp_path / "b"))
    assert tree["ema_params"] is None and tree["opt_state"] is None
    assert meta["run_args"] is None and meta["ema_best"] is False


def test_meta_has_the_jax_keys_and_rebuilds_the_config(state, tmp_path):
    """meta.json: the JAX sidecar's keys and values for the same
    arguments (Orbax writes the JAX tree); config_from_meta gives the
    same ViTConfig on both sides, and the port's model rebuilt from it
    takes the saved params."""
    model, cfg, _ = state
    args = dict(epoch=2, step=7, model_cfg=cfg, run_args={"lr": 0.1},
                ema_best=False, max_accuracy=3.5)
    save_checkpoint(str(tmp_path / "port"), params=model.state_dict(),
                    **args)
    jax_save_checkpoint(str(tmp_path / "jax"),
                        params={"w": np.zeros(2, np.float32)}, **args)
    port_meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    jax_meta = json.loads((tmp_path / "jax" / "meta.json").read_text())
    assert list(port_meta) == list(jax_meta)
    assert port_meta == jax_meta
    rebuilt = config_from_meta(port_meta)
    assert rebuilt == cfg
    assert dataclasses.asdict(rebuilt) == dataclasses.asdict(
        jax_config_from_meta(jax_meta))
    again = model_for_config(rebuilt, device="cpu")
    again.load_state_dict(load_checkpoint(str(tmp_path / "port"))[0][
        "params"], strict=True)


@pytest.mark.parametrize("name", ["deit_small_patch16_224_local",
                                  "tome_small_patch16_224"])
def test_checkpoint_from_jax_gives_jax_logits(name, tmp_path):
    """A JAX Orbax checkpoint, read by JAX's load_checkpoint and written
    as the port's through state_dict_from_flax: the port's model rebuilt
    from it gives the JAX model's fp32 logits within 1e-4."""
    kw = TINY if name.startswith("deit") else KW
    jax_dir, port_dir = checkpoint_pair(tmp_path, name, **kw)
    tree, meta = jax_load_checkpoint(str(jax_dir / "best_checkpoint"))
    module = jax_model_for_config(jax_config_from_meta(meta))
    x = np.random.default_rng(0).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: module.apply(
        {"params": p}, x, train=False))(
        jax.tree_util.tree_map(jnp.asarray, tree["params"]), x))
    ptree, pmeta = load_checkpoint(str(port_dir / "best_checkpoint"))
    assert pmeta == meta
    model = model_for_config(config_from_meta(pmeta), device="cpu").eval()
    model.load_state_dict(ptree["params"], strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
