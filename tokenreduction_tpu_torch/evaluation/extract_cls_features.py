"""CLS-feature extraction at fixed blocks (counterpart of
``tokenreduction_tpu/evaluation/extract_cls_features.py``, reference
extract_cls_features.py): stacks the CLS token of the viz features at
blocks {3, 6, 9, 11} across the val set and writes one transposed
(D, n_images) fp32 .npy per block.

Always the viz forward (every block the plain composition, no kernel
launch); a dense model captures every block's features, a reduction model
records its own blocks', and a block with none recorded takes the largest
recorded block's (reference quirk, kept). Device and precision as in
``validate``: the card unless ``--device``/``--platform`` names another,
TF32 off unless ``--use_amp``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tokenreduction_tpu_torch.evaluation.validate import (
    add_eval_compat_args,
    check_eval_compat_args,
    eval_device,
    forward,
    load_eval_model,
    loader_source,
    set_fp32_products,
    to_host,
)

EXTRACT_BLOCKS = (3, 6, 9, 11)


def get_parser():
    p = argparse.ArgumentParser("CLS feature extraction")
    p.add_argument("--data", type=str, default="")
    p.add_argument("--dataset", "-d", default="imagenet")
    p.add_argument("--checkpoint", default="", type=str)
    p.add_argument("-b", "--batch-size", default=64, type=int)
    p.add_argument("--input-size", default=224, type=int)
    p.add_argument("--output_dir", default="")
    p.add_argument("--feature_output_name", default="cls_features")
    p.add_argument("--split", default="val",
                   help="dataset split; for --dataset cached also the "
                        "cache subdir (the reference flag exists but is "
                        "hardcoded to val, extract_cls_features.py:57)")
    p.add_argument("--use_amp", action="store_true",
                   help="bf16 extraction forward; default is the "
                        "bit-stable fp32 composition")
    p.add_argument("--synthetic-n", default=64, type=int)
    p.add_argument("--platform", default="", type=str,
                   help="cpu, or gpu / cuda (the JAX CLI's flag; --device "
                        "names the device too)")
    p.add_argument("--viz_mode", action="store_true",
                   help="no-op: extraction always runs the viz forward "
                        "(reference compat, extract_cls_features.py:28)")
    add_eval_compat_args(p)
    return p


def extract(args, source=None):
    """{block: (D, n_images) fp32 array}, each also saved under
    --output_dir. ``source`` as in ``validate.validate``."""
    device = eval_device(args)
    use_amp = args.use_amp
    module, _, _, model_cfg = load_eval_model(
        args.checkpoint, viz_mode=True, use_amp=use_amp, device=device,
        extract=True)
    batches, _, _ = (source or loader_source)(args, model_cfg.num_classes)

    feats = {b: [] for b in EXTRACT_BLOCKS}
    for batch in batches:
        valid = batch.pop("valid", len(batch["image"]))
        _, viz = forward(module, batch["image"], device, use_amp)
        features = viz["Features"]
        for b in EXTRACT_BLOCKS:
            blk = features.get(b)
            if blk is None:  # features recorded only at reduction blocks
                blk = features[max(features.keys())]
            feats[b].append(to_host(blk[:valid, 0]))
    out = {}
    for b in EXTRACT_BLOCKS:
        mat = np.vstack(feats[b]).T  # (D, n_images)
        out[b] = mat
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            np.save(os.path.join(
                args.output_dir,
                f"{args.feature_output_name}_{b}.npy"), mat)
    return out


def main(argv=None, source=None):
    args = get_parser().parse_args(argv)
    check_eval_compat_args(args)
    # bit-stable extraction (see validate.py main): the plain composition
    # (viz mode) with true fp32 products; --use_amp opts out into bf16
    set_fp32_products(args.use_amp)
    return extract(args, source)


if __name__ == "__main__":
    main()
