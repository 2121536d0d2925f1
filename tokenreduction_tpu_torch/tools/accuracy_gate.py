"""The real-weights accuracy gate: the counterpart of
``tools/accuracy_gate.py``.

The top-1 axis needs the released DeiT-S weights
(``deit_small_patch16_224-cd65a155.pth``) and the ImageNet validation
images; neither is in the repository. Once they are mounted:

    TOKENREDUCTION_WEIGHTS_DIR=/weights \\
    python -m tokenreduction_tpu_torch.tools.accuracy_gate --data /imagenet

Steps, each failing loudly (exit 2) when its input is absent:

1. the weights: ``--weights`` or ``$TOKENREDUCTION_WEIGHTS_DIR``;
2. logit parity: the hand-written eager ViT oracle
   (``tests/oracles.py::dense_forward``, plain PyTorch on the CPU) on a
   seeded batch against the port's model (``create_model``) loaded through
   the ``.pth`` route (``models/convert.py``), fp32 logits within 1e-4 on
   the device the gate runs on (the card unless ``--device cpu``);
3. with ``--data`` (an ImageNet tree with ``val/``): top-1 and top-5 over
   the validation set, gated to |top-1 - 79.8| <= ``--tolerance``
   (DeiT-S's released top-1).

``--depth``, ``--embed-dim`` and ``--num-heads`` set the ViT of step 2
(DeiT-S's by default), so that a tiny seeded state dict can stand in for
the released one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import sys

import torch

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.tools.tpu_parity import full_fp32

WEIGHT_FILE = "deit_small_patch16_224-cd65a155.pth"
EXPECTED_TOP1 = 79.8
# tests/oracles.py of the checkout: the plain eager ViT the gate holds the
# port against
TESTS = pathlib.Path(__file__).resolve().parents[2] / "tests"


def fail(msg: str, code: int = 2):
    print(f"accuracy_gate: FAIL - {msg}", file=sys.stderr)
    sys.exit(code)


def find_weights(args) -> str:
    if args.weights:
        if not os.path.isfile(args.weights):
            fail(f"--weights {args.weights} does not exist")
        return args.weights
    wdir = os.environ.get("TOKENREDUCTION_WEIGHTS_DIR",
                          os.path.expanduser("~/.cache/tokenreduction_tpu"))
    path = os.path.join(wdir, WEIGHT_FILE)
    if not os.path.isfile(path):
        fail(f"weights not found: place {WEIGHT_FILE} in "
             f"$TOKENREDUCTION_WEIGHTS_DIR (looked at {path})")
    return path


def load_model(args, path: str, device):
    """The port's model with the .pth's weights (fp32, eval mode)."""
    from tokenreduction_tpu_torch.models import convert as C
    from tokenreduction_tpu_torch.models.registry import create_model

    model, _ = create_model(args.model, device=device,
                            generator=torch.Generator().manual_seed(0),
                            depth=args.depth, embed_dim=args.embed_dim,
                            num_heads=args.num_heads)
    tree, _ = C.convert_torch_state_dict(C.load_torch_checkpoint(path))
    merged, report = C.merge_pretrained(model.state_dict(), tree)
    if report["shape_mismatch"]:
        fail(f"converter shape mismatches: {report['shape_mismatch']}")
    model.load_state_dict(merged, strict=True)
    return model.eval()


def load_oracle():
    """``dense_forward`` of the checkout's tests/oracles.py, loaded from its
    path (sys.path stays as it is); exit 2 where it is absent."""
    path = TESTS / "oracles.py"
    if not path.is_file():
        fail(f"{path} is absent: the logit-parity step needs the "
             "checkout's tests/oracles.py")
    spec = importlib.util.spec_from_file_location("_accuracy_gate_oracles",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.dense_forward


def logit_parity(args, path: str, device, batch: int = 4,
                 atol: float = 1e-4) -> float:
    """max|port - oracle| of the fp32 logits on a seeded batch."""
    from tokenreduction_tpu_torch.models.convert import load_torch_checkpoint

    dense_forward = load_oracle()

    state = {k: v.float() for k, v in load_torch_checkpoint(path).items()}
    x = torch.randn(batch, 3, 224, 224,
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = dense_forward(state, x, depth=args.depth, heads=args.num_heads,
                            dim=args.embed_dim, patch=16)
        out = load_model(args, path, device)(x.to(device)).float().cpu()
    diff = float((out - ref).abs().max())
    print(f"logit parity vs the torch oracle ({device.type}): max|d| = "
          f"{diff:.3e} (gate {atol})", flush=True)
    if diff > atol:
        fail(f"logit parity {diff:.3e} exceeds {atol}")
    return diff


def imagenet_top1(args, path: str, device) -> dict:
    """Top-1 and top-5 over ImageNet's validation set, gated."""
    from tokenreduction_tpu_torch.data import (
        Loader,
        TransformConfig,
        build_dataset,
        make_transform,
    )
    from tokenreduction_tpu_torch.data.sampler import ShardedSampler
    from tokenreduction_tpu_torch.train.loop import evaluate
    from tokenreduction_tpu_torch.train.step import make_eval_step

    if not os.path.isdir(os.path.join(args.data, "val")):
        fail(f"--data {args.data} has no val/ ImageNet folder tree")
    ds, _ = build_dataset(args.data, "imagenet", "val")
    model = load_model(args, path, device)
    loader = Loader(ds, ShardedSampler(len(ds), 1, 0, shuffle=False),
                    args.batch_size,
                    make_transform("imagenet", False, TransformConfig()),
                    pad_partial=True)
    params = dict(model.named_parameters())
    stats = evaluate(make_eval_step(model), params, loader, device, False)
    print(json.dumps({"top1": stats["acc1"], "top5": stats["acc5"],
                      "expected_top1": EXPECTED_TOP1}), flush=True)
    if abs(stats["acc1"] - EXPECTED_TOP1) > args.tolerance:
        fail(f"top-1 {stats['acc1']:.2f} outside "
             f"{EXPECTED_TOP1}+-{args.tolerance}")
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(description="The real-weights accuracy "
                                "gate: logit parity, then ImageNet top-1.")
    p.add_argument("--weights", default="",
                   help=f"path to {WEIGHT_FILE} (default: "
                        "$TOKENREDUCTION_WEIGHTS_DIR)")
    p.add_argument("--data", default="",
                   help="ImageNet root containing val/ (without it, the "
                        "parity step only)")
    p.add_argument("--model", default="deit_small_patch16_224_local")
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--embed-dim", type=int, default=384)
    p.add_argument("--num-heads", type=int, default=6)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--tolerance", type=float, default=0.1)
    p.add_argument("--device", default=None,
                   help="torch device; the card unless 'cpu' is given")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    full_fp32()
    path = find_weights(args)
    print(f"weights: {path}", flush=True)
    logit_parity(args, path, device)
    if args.data:
        imagenet_top1(args, path, device)
    else:
        print("no --data given: top-1 not measured (mount ImageNet val and "
              "run again to complete the gate)", flush=True)
    print("accuracy_gate: PASS", flush=True)


if __name__ == "__main__":
    main()
