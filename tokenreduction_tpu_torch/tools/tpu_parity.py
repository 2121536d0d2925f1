"""All-methods full-model parity of the port's kernels on the GPU: the
counterpart of ``tools/tpu_parity.py``, whose name it keeps so that a
reader finds it; it runs on the card (the H100), not on a TPU.

The CPU tests hold the port's plain versions against the JAX package; this
holds the card's hand-written kernels against the port's plain
composition on the card, for every method at DeiT-S widths (and the
capacity axis's DeiT-Ti, D 192 / 3 heads, and DeiT-B, D 768 / 12 heads),
from weights and logits that a CPU process saved.

1. A subprocess on the CPU (``--cpu-phase``) builds each configuration
   from a seed and saves its state dict and fp32 eval logits on a seeded
   batch (``--ref``).
2. On the card, each configuration reloads those weights and checks:

   A. platform: the plain composition on the card (every block pinned by
      ``force_plain``) in fp32 against the CPU's logits, max|d| <= 1e-4;
   B. strict: the fp32 kernels (3xTF32 on the tensor cores) against the
      fp32 plain composition on the card, max|d| <= 1e-4;
   C. bf16 drift, reported: the bf16 kernels against the bf16 plain
      composition, per image; an image beyond ``--bf16-tol`` is a flip.
      Flips are reported for the methods that select tokens (near-tied
      random-weight scores let a boundary token flip) and gated to zero
      for the others.
3. Training (skip with ``--skip-train``):

   D. per-leaf gradients of the label-smoothed loss in fp32 (drop_path
      0.1, the same generator seeds), the training kernels against the
      plain composition, each leaf within 1e-4 of its own max, for deit,
      topk@0.7, tome@0.7, dyvit@0.7, topk@0.25 and topk at tiny and base;
   E. a mini-train A/B: ``--mt-steps`` amp steps of topk@0.7 (grouped
      AdamW, clip 1.0) over 8 fixed batches, the kernels against the plain
      composition from the same weights and seeds: 8-step window means of
      the loss within ``--curve-tol`` and both runs descending (the mean of
      the last 16 steps 0.2 below that of the first 16, or of the last and
      first half of a shorter run).

    python -m tokenreduction_tpu_torch.tools.tpu_parity

runs on the card; with ``--device cpu`` every route is the plain one and
the gates only exercise the tool.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.models.registry import create_model
from tokenreduction_tpu_torch.train import losses
from tokenreduction_tpu_torch.train.optim import (
    OptimConfig,
    create_optimizer,
)
from tokenreduction_tpu_torch.train.step import (
    StepConfig,
    init_train_state,
    make_train_step,
)

METHODS = ["deit", "topk", "evit", "tome", "sit", "patchmerger", "sinkhorn",
           "dpcknn", "kmedoids", "dyvit", "ats", "heuristic"]
# hard token selection in the eval forward
SELECTING = {"topk", "evit", "tome", "dpcknn", "kmedoids", "dyvit", "ats"}
# the keep-0.25 schedule (197 -> 50 -> 13 -> 4), one method a family
KEEP025 = ["topk", "evit", "tome", "sinkhorn"]
# the capacity axis: D 192 / 3 heads and D 768 / 12 heads
CAPACITY_SIZES = ["tiny", "base"]
CAPACITY_METHODS = ["deit", "topk", "dpcknn"]
# the training kernels' families (gate D)
TRAIN_GRAD_CONFIGS = [
    ("deit@0.7", "deit", "small", (0.7,)),
    ("topk@0.7", "topk", "small", (0.7,)),
    ("tome@0.7", "tome", "small", (0.7,)),
    ("dyvit@0.7", "dyvit", "small", (0.7,)),
    ("topk@0.25", "topk", "small", (0.25,)),
    ("topk-tiny@0.7", "topk", "tiny", (0.7,)),
    ("topk-base@0.7", "topk", "base", (0.7,)),
]
WINDOW = 8  # distinct mini-train batches, and the loss window
ROOT = pathlib.Path(__file__).resolve().parents[2]  # the checkout


def configs(methods, sizes=("small",)):
    """(name, method, size, keep): at small the whole method matrix and
    the keep-0.25 families; at tiny and base the capacity set."""
    out = []
    if "small" in sizes:
        out += [(f"{m}@0.7", m, "small", (0.7,)) for m in methods]
        out += [(f"{m}@0.25", m, "small", (0.25,)) for m in methods
                if m in KEEP025]
    for size in sizes:
        if size == "small":
            continue
        out += [(f"{m}-{size}@0.7", m, size, (0.7,))
                for m in CAPACITY_METHODS if m in methods]
        if "topk" in methods:
            out.append((f"topk-{size}@0.25", "topk", size, (0.25,)))
    return out


def build(method, keep, size, device, img_size: int,
          train: bool = False):
    """The configuration's model from a seed (drop_path 0.1 in training:
    it has no parameters, so the saved weights load unchanged)."""
    kw = {"drop_path_rate": 0.1} if train else {}
    kw["img_size"] = img_size
    if method == "deit":
        name = f"deit_{size}_patch16_224_local"
    else:
        name = f"{method}_{size}_patch16_224"
        kw.update(reduction_loc=(3, 6, 9), keep_rate=keep)
    model, _ = create_model(name, device=device,
                            generator=torch.Generator().manual_seed(0), **kw)
    return model


def set_plain(model, plain: bool):
    """Pin every block to the plain composition, or release it."""
    for m in model.modules():
        if hasattr(m, "force_plain"):
            m.force_plain = plain


def logits_of(out):
    return out[0] if isinstance(out, tuple) else out


def cpu_phase(args):
    """Save each configuration's state dict and fp32 eval logits."""
    x = torch.randn(args.batch, 3, args.img_size, args.img_size,
                    generator=torch.Generator().manual_seed(7))
    blobs = {"x": x}
    for name, method, size, keep in configs(args.methods, args.sizes):
        model = build(method, keep, size, "cpu", args.img_size).eval()
        with torch.no_grad():
            logits = logits_of(model(x)).float()
        blobs[name] = {"state": model.state_dict(), "logits": logits}
        print(f"[cpu] {name}: logits {tuple(logits.shape)}", flush=True)
    torch.save(blobs, args.ref)
    print(f"[cpu] wrote {args.ref}", flush=True)


def load(ref, name, method, keep, size, device, train: bool = False):
    x = ref["x"]
    model = build(method, keep, size, device, x.shape[-1], train)
    model.load_state_dict(ref[name]["state"])
    return model


def eval_phase(args, ref, device):
    """Gates A and B, report C."""
    x = ref["x"].to(device)
    rows, failures = [], []
    for name, method, size, keep in configs(args.methods, args.sizes):
        model = load(ref, name, method, keep, size, device).eval()
        half = copy.deepcopy(model).to(torch.bfloat16)

        def run(m, xx, plain):
            set_plain(m, plain)
            with torch.no_grad():
                return logits_of(m(xx)).float()

        plain32, kern32 = run(model, x, True), run(model, x, False)
        xb = x.to(torch.bfloat16)
        plain16, kern16 = run(half, xb, True), run(half, xb, False)
        plat_d = float((plain32.cpu() - ref[name]["logits"]).abs().max())
        strict_d = float((kern32 - plain32).abs().max())
        bf_img = (kern16 - plain16).abs().reshape(x.shape[0], -1).amax(1)
        bf_flips = int((bf_img > args.bf16_tol).sum())
        ok = (plat_d <= args.platform_tol and strict_d <= args.strict_tol
              and (method in SELECTING or bf_flips == 0))
        rows.append({"config": name, "platform_max_d": plat_d,
                     "strict_max_d": strict_d,
                     "bf16_drift_median": float(bf_img.median()),
                     "bf16_flips": bf_flips, "ok": ok})
        print(f"[{device.type}] {name:16s} platform|d|={plat_d:.1e} "
              f"strict|d|={strict_d:.1e} bf16|d| med="
              f"{float(bf_img.median()):.1e} flips={bf_flips}/{x.shape[0]} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)
    return rows, failures


def loss_fn(out, targets, images=None, params=None):
    return losses.label_smoothing_ce(logits_of(out), targets, 0.1)


def train_grads_phase(args, ref, device):
    """Gate D: whole-model fp32 gradients, kernels against plain."""
    x = ref["x"].to(device)
    labels = torch.arange(x.shape[0], device=device) % 1000
    rows, failures = [], []
    for name, method, size, keep in TRAIN_GRAD_CONFIGS:
        if method not in args.methods or size not in args.sizes:
            continue
        model = load(ref, name, method, keep, size, device, train=True)
        model.train()
        params = dict(model.named_parameters())

        def run(plain):
            set_plain(model, plain)
            gen = torch.Generator(device=device).manual_seed(12)
            loss = loss_fn(model(x, generator=gen), labels)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            return float(loss.detach()), dict(zip(params, grads))

        loss_p, g_p = run(True)
        loss_k, g_k = run(False)
        worst, worst_leaf = 0.0, ""
        for n, b in g_p.items():
            a = g_k[n]
            if a is None or b is None:
                if (a is None) != (b is None):
                    worst, worst_leaf = float("inf"), n
                continue
            rel = float((a - b).abs().max() / (b.abs().max() + 1e-20))
            if rel > worst:
                worst, worst_leaf = rel, n
        loss_d = abs(loss_k - loss_p)
        ok = worst <= args.train_tol and \
            loss_d <= args.train_tol * max(1.0, abs(loss_p))
        rows.append({"config": f"{name}/train", "loss_plain": loss_p,
                     "loss_d": loss_d, "grad_rel_max": worst,
                     "worst_leaf": worst_leaf, "ok": ok})
        print(f"[{device.type}] {name + '/train':16s} loss|d|={loss_d:.1e} "
              f"grad rel|d| max={worst:.1e} ({worst_leaf}) "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"{name}/train")
    return rows, failures


def minitrain_phase(args, ref, device):
    """Check E: an amp mini-train, kernels against plain."""
    size = args.sizes[0]
    name = "topk@0.7" if size == "small" else f"topk-{size}@0.7"
    if name not in ref:
        print(f"minitrain: no {name} in the reference (--methods without "
              "topk): skipped", flush=True)
        return [], []
    g = torch.Generator(device=device).manual_seed(21)
    side = ref["x"].shape[-1]
    images = torch.randn(WINDOW, args.mt_batch, 3, side, side, generator=g,
                         device=device)
    labels = torch.randint(0, 1000, (WINDOW, args.mt_batch), generator=g,
                           device=device)

    def run(plain):
        model = load(ref, name, "topk", (0.7,), size, device, train=True)
        model.train()
        set_plain(model, plain)
        opt, _ = create_optimizer(
            dict(model.named_parameters()),
            OptimConfig(lr=args.mt_lr, clip_grad=1.0, backbone_lr_scale=1.0),
            lambda s: args.mt_lr, [], steps_per_epoch=100)
        state = init_train_state(model, opt, device=device)
        step = make_train_step(model, loss_fn, opt, StepConfig(amp=True),
                               torch.Generator(device=device).manual_seed(33))
        out = []
        for i in range(args.mt_steps):
            state, metrics = step(state, {"image": images[i % WINDOW],
                                          "label": labels[i % WINDOW]})
            out.append(metrics["loss"])
        return torch.stack(out).float().cpu().numpy()

    lp, lk = run(True), run(False)
    d = np.abs(lk - lp)
    n_win = lp.size // WINDOW
    wd = np.abs(lk[:n_win * WINDOW].reshape(n_win, WINDOW).mean(1)
                - lp[:n_win * WINDOW].reshape(n_win, WINDOW).mean(1))
    span = min(2 * WINDOW, lp.size // 2)  # the first and last steps
    head, tail = lp[:span].mean(), lp[-span:].mean()
    headk, tailk = lk[:span].mean(), lk[-span:].mean()
    descended = bool(tail < head - 0.2 and tailk < headk - 0.2)
    ok = bool(wd.max() <= args.curve_tol and descended)
    row = {"config": f"minitrain/{name}", "steps": int(lp.size),
           "batch": args.mt_batch, "loss_wind_d_max": float(wd.max()),
           "loss_d_max": float(d.max()), "loss_d_final": float(d[-1]),
           "plain_first": float(head), "plain_last": float(tail),
           "kernels_first": float(headk), "kernels_last": float(tailk),
           "descended": descended, "ok": ok}
    print(f"[{device.type}] minitrain {lp.size} steps b{args.mt_batch}: "
          f"loss wind|d| max={wd.max():.3f} step|d| max={d.max():.3f} "
          f"final={d[-1]:.3f}; plain {head:.3f}->{tail:.3f} kernels "
          f"{headk:.3f}->{tailk:.3f} {'OK' if ok else 'FAIL'}", flush=True)
    return [row], ([] if ok else [f"minitrain/{name}"])


def full_fp32():
    """fp32 products and convolutions in full fp32 (PyTorch runs cuDNN's
    convolutions in TF32 by default): the plain composition's reference
    precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_phase(args) -> int:
    device = resolve_device(args.device)
    full_fp32()
    ref = torch.load(args.ref, weights_only=False)
    rows, failures = ([], []) if args.only_train else \
        eval_phase(args, ref, device)
    train_rows = []
    if not args.skip_train:
        for phase in (train_grads_phase, minitrain_phase):
            r, f = phase(args, ref, device)
            train_rows += r
            failures += f
    print(json.dumps({"device": torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu",
                      "platform_tol": args.platform_tol,
                      "strict_tol": args.strict_tol,
                      "bf16_tol": args.bf16_tol, "train_tol": args.train_tol,
                      "curve_tol": args.curve_tol,
                      "batch": int(ref["x"].shape[0]), "rows": rows,
                      "train_rows": train_rows}), flush=True)
    if failures:
        print(f"FAILED: {failures}", file=sys.stderr, flush=True)
        return 1
    print(f"all {len(rows)} eval + {len(train_rows)} train configs pass",
          flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Full-model parity of the "
                                 "kernels against the plain composition on "
                                 "the GPU, every method and size.")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless 'cpu' is given")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--img-size", type=int, default=224)
    ap.add_argument("--platform-tol", type=float, default=1e-4,
                    help="plain composition on the device vs the CPU")
    ap.add_argument("--strict-tol", type=float, default=1e-4,
                    help="fp32 kernels vs the fp32 plain composition")
    ap.add_argument("--bf16-tol", type=float, default=1e-1,
                    help="per-image bound of bf16 kernels vs bf16 plain")
    ap.add_argument("--train-tol", type=float, default=1e-4,
                    help="per-leaf relative gradient bound, fp32")
    ap.add_argument("--curve-tol", type=float, default=0.3,
                    help="max 8-step window mean |loss_kernels - "
                    "loss_plain| over the amp mini-train")
    ap.add_argument("--mt-steps", type=int, default=200)
    ap.add_argument("--mt-batch", type=int, default=128)
    ap.add_argument("--mt-lr", type=float, default=5e-4)
    ap.add_argument("--skip-train", action="store_true",
                    help="skip the training phases (D, E)")
    ap.add_argument("--only-train", action="store_true",
                    help="run only the training phases")
    ap.add_argument("--methods", nargs="*", default=METHODS)
    ap.add_argument("--sizes", nargs="*", default=["small"] + CAPACITY_SIZES,
                    choices=["tiny", "small", "base"])
    ap.add_argument("--ref", default=None,
                    help="the CPU reference file (default: a temporary "
                    "file, removed after the run)")
    ap.add_argument("--cpu-phase", action="store_true",
                    help="internal: compute the CPU reference and exit")
    args = ap.parse_args(argv)
    if args.cpu_phase:
        return cpu_phase(args) or 0
    with tempfile.TemporaryDirectory(prefix="tpu_parity") as tmp:
        if args.ref is None or not os.path.exists(args.ref):
            args.ref = args.ref or os.path.join(tmp, "ref.pt")
            subprocess.run([sys.executable, "-m",
                            "tokenreduction_tpu_torch.tools.tpu_parity",
                            "--cpu-phase", "--ref", args.ref,
                            "--batch", str(args.batch),
                            "--img-size", str(args.img_size),
                            "--methods", *args.methods,
                            "--sizes", *args.sizes], check=True, cwd=ROOT)
        return card_phase(args)


if __name__ == "__main__":
    sys.exit(main())
