"""Shared pieces of the train CLI tests (tests/test_torch_train_cli*.py):
the tiny widths and data flags, timm-named .pth files made from a seed,
and the port's CLI run on the CPU with its stdout captured."""

import contextlib
import io
import json
import os

import torch

from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.train import train_cli

DIMS = ["--embed-dim", "32", "--depth", "4", "--num-heads", "2",
        "--patch-size", "8", "--input-size", "32"]
DATA = ["--dataset", "synthetic", "--synthetic-n", "32",
        "--synthetic-classes", "7", "--batch-size", "8",
        "--no-repeated-aug", "--print-freq", "100"]
TOPK = ["--model", "topk_tiny_patch16_224", "--reduction_loc", "1", "3",
        "--keep_rate", "0.7"]
# no random draw in the step: the two packages' generators differ
QUIET = ["--mixup", "0", "--cutmix", "0", "--drop-path", "0"]


def read_log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def read_meta(out, name="best_checkpoint"):
    with open(os.path.join(out, name, "meta.json")) as f:
        return json.load(f)


def write_pth(path, name, seed, **kw):
    """A timm-named state dict of the port's ``name`` (a ViT by default at
    the tiny widths; kw overrides), every entry with seeded noise (no leaf
    at zero), saved as {"model": state} the way DeiT's releases are."""
    if not name.startswith("regnet"):
        kw = {**dict(num_classes=7, img_size=32, embed_dim=32, depth=4,
                     num_heads=2, patch_size=8), **kw}
    model, _ = create_model(name, device="cpu",
                            generator=torch.Generator().manual_seed(seed),
                            **kw)
    g = torch.Generator().manual_seed(seed + 1)
    state = {k: v + 0.02 * torch.randn(v.shape, generator=g)
             for k, v in model.state_dict().items()}
    torch.save({"model": state}, path)
    return state


def run_port(argv):
    """The port's CLI on the CPU; returns what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main(argv + ["--device", "cpu"])
    return buf.getvalue()
