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
  it is (the port's ``GroupedOptimizer`` state {part: {name: tensor}},
  e.g. AdamW's ``{"mu", "nu"}``, or a ``torch.optim`` ``state_dict()``).
  Only tensors, numbers, strings and containers of them, so that
  ``torch.load(..., weights_only=True)`` reads it.
- ``meta.json``: the JAX package's sidecar, with the same keys (epoch,
  step, ema_best, max_accuracy, model_cfg, run_args), so the run table and
  the eval CLIs read both packages' checkpoints alike.

``AsyncCheckpointer`` (JAX ``utils/checkpoint.py:77-137``) writes them
without stalling the train loop, and ``restore_train_state`` puts a
checkpoint back into a live train state (``--resume``). Over several
processes the loop gathers the whole state on every rank's main thread,
in one order, and rank 0 alone saves it (``train/loop.py``); the file is
the single-device checkpoint, and a live FSDP shard takes its block of
it on restore.

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
import threading
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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.cpu()


class AsyncCheckpointer:
    """Checkpoint writes that do not stall the train loop.

    The train step updates the masters, the optimizer moments and the EMA
    in place, so ``save`` first snapshots them on the device: one
    ``clone()`` of each tensor on the current stream, then a CUDA event
    recorded after the clones. A background thread waits on that event,
    copies the snapshot to the host on a stream of its own and writes
    ``tree.pt`` and ``meta.json`` (``save_checkpoint``). The main thread
    never synchronises with the card. At most one write is in flight: a
    new ``save`` waits for the previous one after taking its own
    snapshot. An error of the write is raised by the next ``save`` or
    ``wait``."""

    def __init__(self):
        self._thread = None
        self._error = None

    def save(self, path: str, *, params, ema_params=None, opt_state=None,
             **meta):
        with torch.no_grad():
            snap = _tree_map(lambda t: t.detach().clone(),
                             {"params": params, "ema_params": ema_params,
                              "opt_state": opt_state})
        tensors = []
        _tree_map(tensors.append, snap)
        event = None
        if any(t.is_cuda for t in tensors):
            event = torch.cuda.Event()
            event.record()
        self.wait()

        def work():
            try:
                if event is not None:
                    event.synchronize()
                    with torch.cuda.stream(torch.cuda.Stream(
                            device=event.device)):
                        host = _tree_map(_cpu, snap)
                else:
                    host = snap
                save_checkpoint(path, **host, **meta)
            except Exception as e:  # raised by the next save or wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _block_of(live: torch.Tensor, saved: torch.Tensor) -> torch.Tensor:
    """The block of a whole saved tensor that a live shard holds (FSDP):
    split along the one dim where their shapes differ, this rank's block
    of it; the saved tensor itself when the shapes agree."""
    if live.shape == saved.shape:
        return saved
    import torch.distributed as dist

    (dim,) = [d for d, (a, b) in enumerate(zip(live.shape, saved.shape))
              if a != b]
    world = saved.shape[dim] // live.shape[dim]
    return saved.chunk(world, dim)[dist.get_rank() if world > 1 else 0]


def restore_train_state(state, tree: dict, meta: dict):
    """``state`` (a ``train/step.py`` TrainState) with a checkpoint's
    params, EMA params and optimizer moments copied into its tensors in
    place, on their devices, and its step set to meta["step"]. When the
    checkpoint's optimizer state does not match the live one (another
    optimizer, other names), it restores the params and the EMA only and
    keeps the fresh moments, as JAX's resume does (train/loop.py:634-642
    there). The checkpoint holds whole tensors whatever world wrote it; a
    live FSDP shard takes its rank's block of its tensor (JAX's resume
    into another layout, train/loop.py:640-651 there)."""
    def copy_into(live, saved):
        with torch.no_grad():
            for name, t in live.items():
                t.copy_(_block_of(t, saved[name]))

    copy_into(state.params, tree["params"])
    if state.ema_params is not None:
        saved = tree.get("ema_params")
        copy_into(state.ema_params,
                  saved if saved is not None else tree["params"])
    opt = tree.get("opt_state")
    if isinstance(opt, dict) and sorted(opt) == sorted(state.opt_state) and \
            all(sorted(opt[k]) == sorted(v)
                for k, v in state.opt_state.items()):
        for part, live in state.opt_state.items():
            copy_into(live, opt[part])
    else:
        print("resume: the checkpoint's optimizer state does not match the "
              "live one; restoring params only with a fresh optimizer state")
    state.step = int(meta["step"])
    return state


def config_from_meta(meta: dict) -> ViTConfig:
    d = dict(meta["model_cfg"])
    for k in ("reduction_loc", "keep_rate"):
        if k in d and d[k] is not None:
            d[k] = tuple(d[k])
    return ViTConfig(**d)
