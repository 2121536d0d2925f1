"""Checkpoints that carry their config (counterpart of
``tokenreduction_tpu/utils/checkpoint.py``): the checkpoint holds
everything needed to rebuild the model, the config included (reference
train.py:684-693 stores `args`; validate.py:85-94 rebuilds the model from
it).

A checkpoint is a directory of two files:

- ``tree.pt``: one ``torch.save`` of ``{"params": {name: tensor},
  "ema_params": {name: tensor} or None, "opt_state": the optimizer's state
  or None}``. ``params`` and ``ema_params`` are state dicts under the
  model's own names (``model.state_dict()``, or a train state's fp32
  masters), saved on the CPU; ``opt_state`` is the optimizer's state as
  it is (the port's ``GroupedAdamW`` moments ``{"mu", "nu"}``, or a
  ``torch.optim`` ``state_dict()``). Only tensors, numbers, strings and
  containers of them, so that ``torch.load(..., weights_only=True)``
  reads it.
- ``meta.json``: the JAX package's sidecar, with the same keys (epoch,
  step, ema_best, max_accuracy, model_cfg, run_args), so the run table and
  the eval CLIs read both packages' checkpoints alike.

The JAX package's checkpoints are Orbax directories (``tree/``), which
need JAX to read; this module does not read them. A JAX checkpoint's
params become a port checkpoint through the JAX package's
``load_checkpoint`` and the weight bridge
(``models/convert.py::state_dict_from_flax``), in a process that has both.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

from tokenreduction_tpu_torch.core.config import ViTConfig

TREE = "tree.pt"


def _to_cpu(state):
    if state is None:
        return None
    return {name: t.detach().cpu() for name, t in state.items()}


def save_checkpoint(path: str, *, params, ema_params=None, opt_state=None,
                    epoch: int = 0, step: int = 0,
                    model_cfg: Optional[ViTConfig] = None,
                    run_args: Optional[dict] = None,
                    ema_best: bool = False, max_accuracy: float = 0.0):
    """Write ``path/tree.pt`` and ``path/meta.json`` (the directory is made
    when missing; existing files are replaced)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tree = {"params": _to_cpu(params), "ema_params": _to_cpu(ema_params),
            "opt_state": opt_state}
    torch.save(tree, os.path.join(path, TREE))
    meta = {
        "epoch": epoch,
        "step": step,
        "ema_best": ema_best,
        "max_accuracy": max_accuracy,
        "model_cfg": dataclasses.asdict(model_cfg) if model_cfg else None,
        "run_args": run_args,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_checkpoint(path: str):
    """(tree, meta) of a checkpoint directory, every tensor on the CPU."""
    path = os.path.abspath(path)
    tree = torch.load(os.path.join(path, TREE), weights_only=True,
                      map_location="cpu")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return tree, meta


def config_from_meta(meta: dict) -> ViTConfig:
    d = dict(meta["model_cfg"])
    for k in ("reduction_loc", "keep_rate"):
        if k in d and d[k] is not None:
            d[k] = tuple(d[k])
    return ViTConfig(**d)
