"""Validation + reduction-pattern extraction (counterpart of
``tokenreduction_tpu/evaluation/validate.py``, reference validate.py).

Writes the per-image viz JSON the offline analysis suite consumes, with
the JAX package's parser, compat flags and schema: the local->absolute
token-id chaining (``chain_stage_tokens``, EViT's ``-1`` included), the
top-5 ``Predictions`` by ``np.argsort(-logits)`` (ties fall as in JAX),
the per-image ``Loss`` that is its batch's mean, the multilabel sigmoid
and mAP, all as numpy on the host, so ``analysis/`` runs on either
package's artifacts unchanged.

The model runs on ``--device`` (the card unless the caller names another;
``--device cpu`` or ``--platform cpu`` for the CPU), with no generator:
JAX's validate passes no RNG, so DPC-KNN draws no density noise. fp32 runs
turn TF32 off for cuBLAS and cuDNN (the counterpart of JAX's
``jax_default_matmul_precision="highest"``), so the plain fp32 products
(viz mode, the patch-embed convolution) are true fp32 products.
``--use_amp`` casts the model and the images to bf16 and the logits back
to fp32. Batches come from the data pipeline's Loader (``loader_source``)
as HWC float32 numpy and become NCHW on the device.
"""

from __future__ import annotations

import argparse
import json
import os
from json import JSONEncoder

import numpy as np
import torch

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.models.registry import model_for_config
from tokenreduction_tpu_torch.utils.checkpoint import (
    config_from_meta,
    load_checkpoint,
)
from tokenreduction_tpu_torch.utils.metrics import mAP

# --platform's names (JAX's platforms) -> the port's devices
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}
# the viz outputs the JSON is made of (chain_stage_tokens reads these)
VIZ_KEYS = ("Kept_Tokens", "Kept_Tokens_Abs", "Assignment_Maps")


class NumpyArrayEncoder(JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, (np.floating,)):
            return float(obj)
        return JSONEncoder.default(self, obj)


def get_parser():
    p = argparse.ArgumentParser("validation")
    p.add_argument("--data", type=str, default="")
    p.add_argument("--dataset", "-d", default="imagenet",
                   choices=["imagenet", "nabirds", "coco", "nuswide",
                            "cached", "synthetic",
                            "synthetic_multilabel"])
    p.add_argument("--split", default="val",
                   help="dataset split; for --dataset cached also the "
                        "cache subdirectory (falls back to --data root)")
    p.add_argument("--checkpoint", default="", type=str,
                   help="dir containing best_checkpoint")
    p.add_argument("-b", "--batch-size", default=64, type=int)
    p.add_argument("--input-size", default=224, type=int)
    p.add_argument("--output_dir", default="")
    p.add_argument("--viz_mode", action="store_true")
    p.add_argument("--viz_output_name", default="viz_results.json")
    p.add_argument("--use_amp", action="store_true")
    p.add_argument("--synthetic-n", default=64, type=int)
    p.add_argument("--platform", default="", type=str,
                   help="cpu, or gpu / cuda (the JAX CLI's flag; --device "
                        "names the device too)")
    p.add_argument("--synthetic-classes", default=10, type=int)
    add_eval_compat_args(p)
    return p


def add_eval_compat_args(p):
    """Reference eval-CLI flags (validate.py:18-33). -j/--num_workers is
    wired for real (Loader's fork process pool), and so is --device (the
    card by default; cpu for the CPU); --pin-mem is accepted so verbatim
    reference commands parse, but never silently (a notice prints)."""
    p.add_argument("-j", "--num_workers", dest="num_workers",
                   default=0, type=int,
                   help="host decode worker processes (0 = prefetch "
                        "thread; reference default 4)")
    p.add_argument("--pin-mem", action="store_true", default=None,
                   dest="pin_mem",
                   help="no-op (reference compat; warns if set)")
    p.add_argument("--no-pin-mem", action="store_false", dest="pin_mem",
                   help="no-op (reference compat)")
    p.add_argument("--device", default=None,
                   help="the device the model runs on (default: the "
                        "card; cpu for the CPU)")


def check_eval_compat_args(args):
    if args.pin_mem is not None:
        print("NOTE: --pin-mem/--no-pin-mem is a DataLoader knob the "
              "Loader does not have; ignored")


def eval_device(args) -> torch.device:
    """--device, else --platform's device, else the card (which raises
    when there is none)."""
    platform = args.platform
    if platform and platform not in PLATFORMS:
        raise ValueError(f"--platform {platform!r}: one of "
                         f"{sorted(PLATFORMS)}")
    device = args.device or PLATFORMS.get(platform)
    if args.device and platform and \
            torch.device(args.device).type != PLATFORMS[platform]:
        raise ValueError(f"--device {args.device} and --platform "
                         f"{platform} disagree")
    return resolve_device(device)


def set_fp32_products(use_amp: bool):
    """fp32 runs: TF32 off for cuBLAS and cuDNN (JAX pins
    jax_default_matmul_precision="highest"); bf16 runs leave both as
    they are."""
    if not use_amp:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def add_dirs_driver_args(p):
    """Flags shared by the two batch drivers (validate_dirs /
    extract_cls_features_dirs), mirroring the reference drivers' common
    surface (validate_dirs.py:16-33 == extract_cls_features_dirs.py).
    Kept in one place so a wording/behavior fix cannot drift between
    the two."""
    p.add_argument("--dataset_csv", "--csv", dest="csv", required=True)
    p.add_argument("--parent_dir", default=".")
    p.add_argument("--data", default="")
    p.add_argument("--dataset", "-d", default="imagenet")
    p.add_argument("-b", "--batch-size", default=64, type=int)
    p.add_argument("--input-size", default=224, type=int)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--overwrite_existing", action="store_true")
    p.add_argument("--use_amp", action="store_true")
    p.add_argument("--synthetic-n", default=64, type=int)
    p.add_argument("--platform", default="", type=str,
                   help="forwarded to the per-run CLI (e.g. cpu)")
    p.add_argument("--checkpoint", default=None,
                   help="no-op: the checkpoint path comes from each CSV "
                        "row (reference compat, validate_dirs.py:18)")
    add_eval_compat_args(p)


def check_dirs_driver_args(args):
    check_eval_compat_args(args)
    if args.checkpoint:
        print("NOTE: --checkpoint is ignored; run dirs come from the "
              "CSV's output_dir/Name columns")


def dirs_forward_args(args) -> list:
    """The per-run CLI flags a batch driver passes on from its own."""
    argv = []
    if args.use_amp:
        argv += ["--use_amp"]
    if args.platform:
        argv += ["--platform", args.platform]
    if args.device:
        argv += ["--device", args.device]
    if args.num_workers:
        argv += ["-j", str(args.num_workers)]
    return argv


def read_csv_rows(path: str) -> list:
    """The run-overview CSV's rows as {column: text}: the drivers read
    only the Name, model and output_dir columns, as text."""
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def count_params(state) -> int:
    """Parameters of a checkpoint's params (the model's non-persistent
    buffers are not in it), as JAX's count over its param tree."""
    return sum(t.numel() for t in state.values())


def chain_stage_tokens(model_name, reduction_count, viz_np, img_i,
                       data_dict):
    """Per-image Stage-{i} dicts with local->absolute id chaining
    (reference validate.py:205-229)."""
    viz_keys = list(viz_np.keys())
    kept_tokens = "Kept_Tokens" in viz_keys
    kept_tokens_abs = "Kept_Tokens_Abs" in viz_keys
    assign_maps = "Assignment_Maps" in viz_keys
    prev_stage_name = None
    for stage_idx, stage in enumerate(reduction_count):
        stage_name = f"Stage-{stage}"
        data_dict[stage_name] = {}
        if kept_tokens:
            if stage_idx == 0:
                data_dict[stage_name]["Kept_Token"] = \
                    viz_np["Kept_Tokens"][stage][img_i]
            else:
                rel_idx = viz_np["Kept_Tokens"][stage][img_i]
                if "evit" not in model_name:
                    rel_idx = rel_idx[rel_idx >= 0]
                data_dict[stage_name]["Kept_Token"] = \
                    data_dict[prev_stage_name]["Kept_Token"][rel_idx]
        if kept_tokens_abs:
            data_dict[stage_name]["Kept_Token"] = \
                viz_np["Kept_Tokens_Abs"][stage][img_i]
        if assign_maps:
            data_dict[stage_name]["Assignment_Maps"] = \
                viz_np["Assignment_Maps"][stage][img_i]
        prev_stage_name = stage_name
    return data_dict


def load_eval_model(checkpoint: str, *, viz_mode: bool, use_amp: bool,
                    device, extract: bool = False):
    """(model in eval mode on ``device``, the params it was loaded from,
    meta, its config) of ``checkpoint`` (the run dir or its
    best_checkpoint): ema_params when meta says the EMA was best; with
    ``extract`` a dense model captures its blocks' features (reference
    extract_cls_features.py:74-75); ``use_amp`` casts it to bf16."""
    ckpt_dir = checkpoint
    if os.path.isdir(os.path.join(ckpt_dir, "best_checkpoint")):
        ckpt_dir = os.path.join(ckpt_dir, "best_checkpoint")
    tree, meta = load_checkpoint(ckpt_dir)
    model_cfg = config_from_meta(meta).replace(viz_mode=viz_mode)
    params = tree["ema_params"] if meta.get("ema_best") and \
        tree.get("ema_params") is not None else tree["params"]
    mod_kw = {"capture_features": True} \
        if extract and model_cfg.method == "" else {}
    model = model_for_config(model_cfg, device=device, **mod_kw)
    model.load_state_dict(params, strict=True)
    if use_amp:
        # reference validate.py:36-37 amp autocast -> the serving
        # configuration: bf16 params + inputs (viz extraction should
        # stay at the fp32 default for bit-stable artifacts)
        model = model.to(torch.bfloat16)
    return model.eval(), params, meta, model_cfg


def loader_source(args, num_classes: int):
    """(batches, image_name, multilabel) of args' dataset: the eval
    Loader's numpy batches (image HWC float32, label, valid)."""
    from tokenreduction_tpu_torch.data import (
        Loader,
        ShardedSampler,
        TransformConfig,
        build_dataset,
        make_transform,
    )

    ds, _ = build_dataset(
        args.data, args.dataset, args.split,
        num_classes=num_classes, img_size=args.input_size,
        synthetic_n=args.synthetic_n)
    tcfg = TransformConfig(input_size=args.input_size)
    loader = Loader(ds, ShardedSampler(len(ds), 1, 0, shuffle=False),
                    args.batch_size, make_transform(args.dataset, False,
                                                    tcfg),
                    num_workers=args.num_workers)
    return loader, ds.image_name, getattr(ds, "multilabel", False)


def forward(model, image: np.ndarray, device, use_amp: bool):
    """The model's output on a numpy HWC batch, made NCHW on the
    device."""
    x = torch.from_numpy(image).to(device).permute(0, 3, 1, 2)
    x = x.to(torch.bfloat16 if use_amp else torch.float32).contiguous()
    with torch.no_grad():
        return model(x)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as numpy, floating ones in fp32 (metrics/viz math
    downstream expects f32)."""
    if t.is_floating_point():
        t = t.float()
    return t.cpu().numpy()


def validate(args, source=None):
    """The viz/metrics dict of args' checkpoint. ``source(args,
    num_classes) -> (batches, image_name, multilabel)`` gives the numpy
    batches (default: ``loader_source``)."""
    if not args.checkpoint:
        raise ValueError("Empty checkpoint path, not usable")
    device = eval_device(args)
    use_amp = args.use_amp
    module, params, meta, model_cfg = load_eval_model(
        args.checkpoint, viz_mode=args.viz_mode, use_amp=use_amp,
        device=device)
    run_args = meta.get("run_args") or {}
    batches, image_name, multilabel = (source or loader_source)(
        args, model_cfg.num_classes)

    param_count = count_params(params)
    model_name = meta["model_cfg"].get("method") or "deit"
    full_model_name = run_args.get("model", model_name)
    model_data_dict = {
        "Model": full_model_name,
        "Ratio": list(model_cfg.keep_rate),
        "Location": list(model_cfg.reduction_loc),
    }
    reduction_count = (
        list(module.active_loc) if hasattr(module, "active_loc")
        else list(model_cfg.reduction_loc))
    # heuristic contiguous mode expands the loc range only after setup;
    # rebuild from config the same way the model does
    if model_cfg.method == "heuristic" and not model_cfg.not_contiguous:
        reduction_count = list(range(min(model_cfg.reduction_loc),
                                     max(model_cfg.reduction_loc) + 1))

    top1 = top5 = seen = 0
    loss_total = 0.0
    preds_all, targs_all = [], []
    img_count = 0
    for batch in batches:
        valid = batch.pop("valid", len(batch["image"]))
        out = forward(module, batch["image"], device, use_amp)
        viz_np = None
        if args.viz_mode:
            # a dense model without captured features has no viz data:
            # its predictions JSON, as without viz (JAX unpacks the
            # logits' batch axis here)
            out, viz_data = out if isinstance(out, tuple) else (out, {})
            viz_np = {
                k: {blk: to_host(v) for blk, v in d.items()}
                for k, d in viz_data.items() if k in VIZ_KEYS
            }
        logits = to_host(out)[:valid]
        target = batch["label"][:valid]

        if multilabel:
            if target.ndim == 3:
                target = target.max(axis=1)
            probs = 1.0 / (1.0 + np.exp(-logits))
            preds_all.append(probs)
            targs_all.append(target)
            loss = float(np.mean(
                np.maximum(logits, 0) - logits * target
                + np.log1p(np.exp(-np.abs(logits)))))
            pred_out = probs
        else:
            logp = logits - logits.max(-1, keepdims=True)
            logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
            loss = float(np.mean(
                -logp[np.arange(len(target)), target]))
            order = np.argsort(-logits, axis=-1)[:, :5]
            top1 += int((order[:, 0] == target).sum())
            top5 += int((order == target[:, None]).any(-1).sum())
            pred_out = order
        loss_total += loss * valid
        seen += valid

        for i in range(valid):
            name = image_name(img_count + i)
            data_dict = {"Predictions": pred_out[i],
                         "Target": np.asarray(target[i]),
                         "Loss": loss}
            if args.viz_mode:
                chain_stage_tokens(full_model_name, reduction_count,
                                   viz_np, i, data_dict)
            model_data_dict[name] = data_dict
        img_count += valid

    if multilabel:
        score = mAP(np.concatenate(targs_all), np.concatenate(preds_all))
        top1a = top5a = score
    else:
        top1a = 100.0 * top1 / max(seen, 1)
        top5a = 100.0 * top5 / max(seen, 1)

    model_data_dict["Top1-Acc"] = round(top1a, 4)
    model_data_dict["Top5-Acc"] = round(top5a, 4)
    model_data_dict["Params"] = round(param_count / 1e6, 2)
    print(f" * Acc@1 {top1a:.3f} Acc@5 {top5a:.3f} "
          f"loss {loss_total / max(seen, 1):.4f} params {param_count / 1e6:.2f}M")
    return model_data_dict


def write_viz(viz_file, viz_data):
    with open(viz_file, "w") as f:
        json.dump(viz_data, f, cls=NumpyArrayEncoder, indent=4)


def main(argv=None, source=None):
    """The CLI; ``source`` as in ``validate``."""
    args = get_parser().parse_args(argv)
    check_eval_compat_args(args)
    set_fp32_products(args.use_amp)
    if args.viz_mode and args.use_amp:
        print("NOTE: --use_amp viz extraction is NOT bit-stable across "
              "platforms; drop --use_amp for analysis-grade artifacts")
    data = validate(args, source)
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        write_viz(os.path.join(args.output_dir, args.viz_output_name), data)
    return data


if __name__ == "__main__":
    main()
