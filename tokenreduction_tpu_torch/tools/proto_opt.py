"""The cost of the train step's optimizer tail on the card: the counterpart
of ``tools/proto_opt.py``.

The tail of a step (clip to the global norm, the grouped AdamW update, the
parameter add and the EMA) is elementwise traffic over every parameter.
This times it two ways over topk@0.7's parameters (DeiT-S, 22M fp32):

- ``tree``: the port's own tail (``train/optim.py``'s grouped AdamW with
  clip 1.0 and ``backbone_lr_scale`` 0.01, which adds the update to the
  parameters in place, then ``ema_update``) over the model's parameter
  dict;
- ``flat``: the same math over five flat fp32 vectors (parameters, the
  base gradient, two moments, the EMA), one global-norm reduction and one
  chain of elementwise operations: what a fused optimizer kernel would
  start from, with no per-leaf work.

Both make each step's gradient from the carried parameters (g = g0 + 1e-6
p), as the JAX tool does. The ideal beside them is the traffic (g0 and p
read twice, m, v and the EMA read, m, v, p and the EMA written: 9 fp32
values a parameter) at the card's 3.35 TB/s.

    python -m tokenreduction_tpu_torch.tools.proto_opt

runs on the card; with ``--device cpu`` (and a smaller ``--model``) on
the CPU, timed by the host's clock.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.models.registry import create_model
from tokenreduction_tpu_torch.tools import _measure as M
from tokenreduction_tpu_torch.train.optim import (
    OptimConfig,
    create_optimizer,
    ema_update,
    global_norm,
)

ITERS = 20  # steps a timed run
EMA = 0.99996
MODEL = "topk_small_patch16_224"


def tree_step(model_name: str, device):
    """(step(), parameter count): one step of the port's optimizer tail
    over the model's parameters, in place."""
    model, _ = create_model(model_name, device=device,
                            generator=torch.Generator().manual_seed(0),
                            reduction_loc=(3, 6, 9), keep_rate=(0.7,))
    params = {n: p.detach() for n, p in model.named_parameters()}
    opt, _ = create_optimizer(
        params, OptimConfig(lr=1e-3, clip_grad=1.0, backbone_lr_scale=0.01),
        lambda s: 1e-3, [], steps_per_epoch=100)
    state = opt.init(params)
    ema = {n: p.clone() for n, p in params.items()}
    g = torch.Generator().manual_seed(1)
    g0 = {n: (torch.randn(p.shape, generator=g) * 1e-3).to(device)
          for n, p in params.items()}
    count = [0]

    def step():
        grads = dict(zip(params, torch._foreach_add(
            list(g0.values()), list(params.values()), alpha=1e-6)))
        opt.update(params, grads, state, count[0],
                   global_norm(grads.values()))
        ema_update(ema, params, EMA)
        count[0] += 1

    return step, sum(p.numel() for p in params.values())


def flat_step(nparam: int, device):
    """step(): the same math over flat fp32 vectors of nparam values."""
    g = torch.Generator().manual_seed(0)
    p = (torch.randn(nparam, generator=g) * 0.02).to(device)
    g0 = (torch.randn(nparam, generator=g) * 1e-3).to(device)
    m, v, e = torch.zeros_like(p), torch.zeros_like(p), p.clone()

    def step():
        gr = g0 + 1e-6 * p
        gr.mul_(torch.clamp(1.0 / (gr.norm() + 1e-6), max=1.0))
        m.mul_(0.9).add_(gr, alpha=0.1)
        v.mul_(0.999).addcmul_(gr, gr, value=0.001)
        upd = m / (v.sqrt() + 1e-8) + 0.05 * p
        p.add_(upd, alpha=-1e-3)
        e.mul_(EMA).add_(p, alpha=1 - EMA)

    return step


def main(argv=None):
    p = M.parser("The optimizer tail (clip, grouped AdamW, param add, EMA) "
                 "over the model's parameters against flat vectors.")
    p.add_argument("--model", default=MODEL,
                   help=f"whose parameters (default {MODEL})")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    iters = args.iters or ITERS
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu", flush=True)
    tree, nparam = tree_step(args.model, device)
    flat = flat_step(nparam, device)
    gb = nparam * 4 * 9 / 1e9
    print(f"params: {nparam / 1e6:.1f}M; ~{gb:.3f} GB a step -> ideal "
          f"{gb / M.PEAK_BYTES * 1e12:.4f} ms at "
          f"{M.PEAK_BYTES / 1e12:.2f} TB/s", flush=True)
    with torch.no_grad():
        ms_tree = M.timeit(tree, device, iters, reps=3)
        ms_flat = M.timeit(flat, device, iters, reps=3)
    print(f"tree (the port's optimizer tail): {ms_tree:.4f} ms a step "
          f"({M.clock(device)})", flush=True)
    print(f"flat (five flat vectors):         {ms_flat:.4f} ms a step "
          f"({M.clock(device)})", flush=True)


if __name__ == "__main__":
    main()
