"""Per-width timings of the port's eval counterparts on the card: the
counterpart of ``tools/profile_kernels.py`` (which of the attention and
MLP halves loses the most of its bound at the reduced widths).

For N = 197, 138, 97, 68 (topk@0.7's widths) it times
``fused_block_attention`` (#2) and ``fused_mlp_residual`` (#4) at B x N,
bf16, and prints each time beside its bound (the bf16 rate or the memory
rate, ``_measure.bound_ms``) and its share of the bf16 peak.

    python -m tokenreduction_tpu_torch.tools.profile_kernels

runs on the card; ``--device cpu`` runs the plain versions, timed by the
host's clock.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.tools import _measure as M
from tokenreduction_tpu_torch.tools.tune_kernels import (
    current_attention,
    current_mlp,
)

ITERS = 40
WIDTHS = (197, 138, 97, 68)


def report(label: str, n: int, ms: float, cost, device) -> str:
    bound, by = M.bound_ms(*cost)
    return (f"{label} N={n:3d}  {ms:8.4f} ms ({M.clock(device)})  "
            f"{cost[0] / (ms / 1e3) / M.PEAK_FLOPS * 100:5.1f}% of the bf16 "
            f"peak, bound {bound:.4f} ms ({by})")


def attn_ms(n: int, device, iters: int, B: int) -> float:
    w, x = M.weights(device), M.inputs(B, n, device)
    return M.timeit(lambda: current_attention(x, w), device, iters)


def mlp_ms(n: int, device, iters: int, B: int) -> float:
    w, x = M.weights(device), M.inputs(B, n, device)
    return M.timeit(lambda: current_mlp(x, w), device, iters)


def main(argv=None):
    args = M.parser("Per-width times of the eval attention and MLP "
                    "halves against their bounds.").parse_args(argv)
    device = resolve_device(args.device)
    iters = args.iters or ITERS
    with torch.no_grad():
        for n in WIDTHS:
            print(report("attn", n, attn_ms(n, device, iters, args.batch),
                         M.attn_cost(args.batch, n), device), flush=True)
        for n in WIDTHS:
            print(report("mlp ", n, mlp_ms(n, device, iters, args.batch),
                         M.mlp_cost(args.batch, n), device), flush=True)


if __name__ == "__main__":
    main()
