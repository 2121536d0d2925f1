"""Where the train step's time goes on the card: the counterpart of
``tools/profile_train.py``.

bench.py's train recipe (topk@0.7, amp, drop_path 0.1, label smoothing
0.1, grouped AdamW with clip 1.0, EMA 0.99996) at B = 256, split into:

- ``fwd_only``: the amp forward and the loss (autograd recording, no
  backward);
- ``fwd_bwd``: the forward, the backward and the gradients' global norm
  (``train/step.py::loss_and_grads``);
- ``full_step``: the whole step (``make_train_step``): the above, clip,
  the grouped AdamW update and the EMA; ``optimizer + EMA`` is the
  difference.

It runs once with the training kernels (the branches' hand-written
forwards and backwards) and once on the plain composition, the model's
blocks pinned by ``force_plain`` (``train/step.py::pin_plain_composition``),
each ms a step by CUDA events around steps issued back to back.

    python -m tokenreduction_tpu_torch.tools.profile_train

runs on the card; with ``--device cpu`` (at a small ``--batch``,
``--img-size`` and ``--size``) on the CPU, timed by the host's clock.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.models.registry import create_model
from tokenreduction_tpu_torch.tools import _measure as M
from tokenreduction_tpu_torch.train import losses
from tokenreduction_tpu_torch.train.optim import (
    OptimConfig,
    create_optimizer,
    global_norm,
)
from tokenreduction_tpu_torch.train.step import (
    StepConfig,
    init_train_state,
    loss_and_grads,
    make_train_step,
    pin_plain_composition,
)

ITERS = 8  # steps a timed run


def loss_fn(out, targets, images, params):
    return losses.label_smoothing_ce(out, targets, 0.1)


def build(device, B: int, img_size: int, size: str = "small"):
    """(the three timed functions, the model) of the recipe at B images of
    img_size pixels, from seeded weights and data."""
    model, _ = create_model(f"topk_{size}_patch16_224", device=device,
                            img_size=img_size, drop_path_rate=0.1,
                            generator=torch.Generator().manual_seed(0),
                            reduction_loc=(3, 6, 9), keep_rate=(0.7,))
    model.train()
    opt, _ = create_optimizer(
        dict(model.named_parameters()),
        OptimConfig(lr=1e-3, clip_grad=1.0, backbone_lr_scale=0.01),
        lambda s: 1e-3, [], steps_per_epoch=100)
    state = init_train_state(model, opt, ema=True, device=device)
    cfg = StepConfig(ema_decay=0.99996, amp=True)
    gen = torch.Generator(device=device).manual_seed(5)
    step = make_train_step(model, loss_fn, opt, cfg, gen)
    data = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(B, 3, img_size, img_size, generator=data, device=device)
    y = torch.randint(0, 1000, (B,), generator=data, device=device)
    holder = [state]

    def fwd_only():
        p = {n: t.to(torch.bfloat16) for n, t in holder[0].params.items()}
        with torch.enable_grad():
            out = functional_call(model, p, (x.to(torch.bfloat16),),
                                  {"generator": gen})
            return loss_fn(out, y, x, p).float()

    def fwd_bwd():
        _, g = loss_and_grads(model, loss_fn, holder[0].params, x, y, cfg,
                              gen)
        return global_norm(g.values())

    def full_step():
        holder[0], metrics = step(holder[0], {"image": x, "label": y})
        return metrics["loss"]

    return {"fwd_only": fwd_only, "fwd_bwd": fwd_bwd,
            "full_step": full_step}, model


def main(argv=None):
    p = M.parser("The topk@0.7 amp train step split into forward, backward "
                 "and optimizer + EMA, with the training kernels and on the "
                 "plain composition.")
    p.add_argument("--img-size", type=int, default=224,
                   help="image size (default 224, the recipe's)")
    p.add_argument("--size", default="small",
                   choices=("tiny", "small", "base"),
                   help="the model's capacity (default small, DeiT-S)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    iters = args.iters or ITERS
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu", flush=True)
    parts, model = build(device, args.batch, args.img_size, args.size)
    for route in ("kernels", "plain"):
        if route == "plain":
            pin_plain_composition(model)
        ms = {name: M.timeit(fn, device, iters, reps=3)
              for name, fn in parts.items()}
        for name, t in ms.items():
            print(f"{route:7s} {name:10s} {t:9.3f} ms a step "
                  f"({M.clock(device)})", flush=True)
        tail = ms["full_step"] - ms["fwd_bwd"]
        print(f"{route:7s} optimizer + EMA {tail:9.3f} ms a step; train "
              f"{args.batch / ms['full_step'] * 1e3:.0f} img/s", flush=True)


if __name__ == "__main__":
    main()
