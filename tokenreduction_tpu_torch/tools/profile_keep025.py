"""The keep-0.25 throughput decomposition on the card: the counterpart of
``tools/profile_keep025.py``.

It times, in bf16 at B images:

1. the eval counterparts per width, ``fused_block_attention`` (#2) and
   ``fused_mlp_residual`` (#4), at the keep-0.7 widths (197, 138, 97, 68)
   and the keep-0.25 schedule's (197 -> 50 -> 13 -> 4, CLS included), with
   more calls a timed run at the narrow widths, each beside its bound;
2. the patch embedding (a 16 x 16 convolution of stride 16, cuDNN);
3. the dense, topk@0.7 and topk@0.25 DeiT-S forwards (seeded weights),

and prints each schedule's kernel sum (the halves' times by their counts,
plus the patch embedding) beside its model's time: the glue between the
kernels, and the kernel ceiling of each keep rate's speed-up.

    python -m tokenreduction_tpu_torch.tools.profile_keep025

runs on the card; ``--device cpu`` runs the plain versions, timed by the
host's clock.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.tools import _measure as M
from tokenreduction_tpu_torch.tools.profile_kernels import (
    attn_ms,
    mlp_ms,
    report,
)

# width: calls a timed run (more at the narrow widths, as the JAX tool)
WIDTHS = {197: 40, 138: 60, 97: 80, 68: 100, 50: 120, 13: 300, 4: 400}
# (attention halves, MLP halves) a forward, as (width, count)
SCHEDULES = {
    "dense": ([(197, 12)], [(197, 12)]),
    "keep0.7": ([(197, 4), (138, 3), (97, 3), (68, 2)],
                [(197, 3), (138, 3), (97, 3), (68, 3)]),
    "keep0.25": ([(197, 4), (50, 3), (13, 3), (4, 2)],
                 [(197, 3), (50, 3), (13, 3), (4, 3)]),
}
MODELS = {
    "dense": ("deit_small_patch16_224_local", {}),
    "keep0.7": ("topk_small_patch16_224",
                dict(reduction_loc=(3, 6, 9), keep_rate=(0.7,))),
    "keep0.25": ("topk_small_patch16_224",
                 dict(reduction_loc=(3, 6, 9), keep_rate=(0.25,))),
}


def patch_embed_ms(device, B: int, iters: int = 100) -> float:
    g = torch.Generator().manual_seed(1)
    wc = (torch.randn(M.D, 3, 16, 16, generator=g) * 0.02).to(
        device, torch.bfloat16)
    x = torch.randn(B, 3, 224, 224, generator=g).to(device, torch.bfloat16)
    return M.timeit(lambda: F.conv2d(x, wc, stride=16), device, iters)


def model_ms(label: str, device, B: int, iters: int = 20) -> float:
    name, kw = MODELS[label]
    model, _ = create_model(name, device=device,
                            generator=torch.Generator().manual_seed(0), **kw)
    model = model.to(torch.bfloat16).eval()
    x = torch.randn(B, 3, 224, 224, generator=torch.Generator().manual_seed(0))
    x = x.to(device, torch.bfloat16)
    return M.timeit(lambda: model(x), device, iters)


def main(argv=None):
    args = M.parser("The keep-0.25 decomposition: per-width kernel times, "
                    "their sums by schedule and the models' times.") \
        .parse_args(argv)
    device = resolve_device(args.device)
    B = args.batch
    at, mt = {}, {}
    with torch.no_grad():
        for n, iters in WIDTHS.items():
            iters = args.iters or iters
            at[n] = attn_ms(n, device, iters, B)
            mt[n] = mlp_ms(n, device, iters, B)
            print(report("attn", n, at[n], M.attn_cost(B, n), device),
                  flush=True)
            print(report("mlp ", n, mt[n], M.mlp_cost(B, n), device),
                  flush=True)
        pe = patch_embed_ms(device, B, args.iters or 100)
        print(f"patch embed: {pe:.4f} ms ({M.clock(device)})", flush=True)
        sums, models = {}, {}
        for name, (aw, mw) in SCHEDULES.items():
            sums[name] = pe + sum(at[n] * c for n, c in aw) + \
                sum(mt[n] * c for n, c in mw)
            print(f"kernel-sum {name}: {sums[name]:8.4f} ms", flush=True)
        for name in SCHEDULES:
            models[name] = model_ms(name, device, B, args.iters or 20)
            print(f"model {name:8s}: {models[name]:8.4f} ms (glue "
                  f"{models[name] - sums[name]:+.4f})", flush=True)
    for name in ("keep0.7", "keep0.25"):
        print(f"measured ratio {name}: {models['dense'] / models[name]:6.3f} "
              f"(kernel ceiling {sums['dense'] / sums[name]:6.3f})",
              flush=True)


if __name__ == "__main__":
    main()
