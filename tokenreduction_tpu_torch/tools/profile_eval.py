"""Where the eval forward's time goes on the card: the counterpart of
``tools/profile_eval.py``.

The topk@0.7 bf16 forward at B = 256, split by CUDA events into:

- the model: ``full_topk07`` (topk@0.7) and ``full_dense`` (DeiT-S);
- the kernel floor: the attention halves (``fused_block_attention``) and
  MLP halves (``fused_mlp_residual``) alone at topk@0.7's widths
  (``ATTN_W``, ``MLP_W``) and at 197 throughout (``kern_dense``);
- the glue: the top-k and gather at the three reductions, the patch
  embedding, and the classifier at 68 tokens.

What is left of the model once its parts are taken out is the glue that
none of them times. Each part is ms a forward (calls issued back to back
between two events), beside img/s at the batch.

    python -m tokenreduction_tpu_torch.tools.profile_eval

runs on the card; with ``--device cpu`` (at a small ``--batch``) the
plain versions run, timed by the host's clock.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.models.registry import create_model
from tokenreduction_tpu_torch.ops.gather import take_tokens
from tokenreduction_tpu_torch.tools import _measure as M
from tokenreduction_tpu_torch.tools.tune_kernels import (
    GLUE,
    current_attention,
    current_mlp,
)

ITERS = 20
# topk@0.7 at reduction_loc (3, 6, 9): each block's attention and MLP widths
ATTN_W = (197, 197, 197, 197, 138, 138, 138, 97, 97, 97, 68, 68)
MLP_W = (197, 197, 197, 138, 138, 138, 97, 97, 97, 68, 68, 68)


def model_forward(name: str, device, B: int, **kw):
    """fn(): one bf16 eval forward of the named model (seeded weights) on
    a seeded image batch; and the model."""
    model, _ = create_model(name, device=device,
                            generator=torch.Generator().manual_seed(0), **kw)
    model.to(torch.bfloat16).eval()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, 3, 224, 224, generator=g).to(device, torch.bfloat16)
    return (lambda: model(x)), model


def kernel_floor(attn_w, mlp_w, device, B: int):
    """fn(): the attention and MLP halves alone at the given widths, each
    half taking the first tokens of the last one's output."""
    w = M.weights(device)
    x0 = M.inputs(B, 197, device)

    def fn():
        x = x0
        for aw, mw in zip(attn_w, mlp_w):
            x = current_attention(x[:, :aw].contiguous(), w)[0]
            x = current_mlp(x[:, :mw].contiguous(), w)
        return x

    return fn


def glue(device, B: int):
    """fn(): top-k of the CLS-scored tokens and the gather, at the three
    reductions."""
    x0 = M.inputs(B, 197, device)

    def fn():
        x = x0
        for left, _ in GLUE:
            _, idx = torch.topk(x[:, 1:, 0].float(), left)
            x = torch.cat([x[:, :1], take_tokens(x[:, 1:], idx)], 1)
        return x

    return fn


def main(argv=None):
    p = M.parser("The topk@0.7 eval forward split into the model, the "
                 "kernel floor and the glue.")
    p.add_argument("--size", default="small",
                   choices=("tiny", "small", "base"),
                   help="the models' capacity (default small, DeiT-S; the "
                        "kernel floor stays at DeiT-S's width)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    iters = args.iters or ITERS
    B = args.batch
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu (plain versions)", flush=True)
    topk, _ = model_forward(f"topk_{args.size}_patch16_224", device, B,
                            reduction_loc=(3, 6, 9), keep_rate=(0.7,))
    dense, model = model_forward(f"deit_{args.size}_patch16_224_local",
                                 device, B)
    xi = torch.randn(B, 3, 224, 224,
                     generator=torch.Generator().manual_seed(1)).to(
        device, torch.bfloat16)
    t68 = torch.randn(B, 68, model.cfg.embed_dim,
                      generator=torch.Generator().manual_seed(2)).to(
        device, torch.bfloat16)
    parts = {
        "full_topk07": topk,
        "full_dense": dense,
        "kern_reduced": kernel_floor(ATTN_W, MLP_W, device, B),
        "kern_dense": kernel_floor((197,) * 12, (197,) * 12, device, B),
        "glue_topk_gather": glue(device, B),
        "embed": lambda: model.embed(xi),
        "classify_w68": lambda: model.classify(t68),
    }
    ms = {}
    with torch.no_grad():
        for name, fn in parts.items():
            ms[name] = M.timeit(fn, device, iters, reps=3)
            print(f"{name:20s} {ms[name]:8.4f} ms ({M.clock(device)}; "
                  f"{B / ms[name] * 1e3:9.0f} img/s)", flush=True)
    rest = (ms["full_topk07"] - ms["kern_reduced"] - ms["embed"]
            - ms["classify_w68"] - ms["glue_topk_gather"])
    print(f"unaccounted glue in full_topk07: {rest:.4f} ms", flush=True)
    ops = floor_ops((197,) * 12, (197,) * 12) / floor_ops(ATTN_W, MLP_W)
    print(f"kernel ratio dense / reduced: "
          f"{ms['kern_dense'] / ms['kern_reduced']:.3f} (operations ratio "
          f"{ops:.3f})", flush=True)


def floor_ops(attn_w, mlp_w) -> float:
    """The operations of the halves at the given widths (any batch)."""
    return sum(M.attn_cost(1, a)[0] for a in attn_w) + \
        sum(M.mlp_cost(1, m)[0] for m in mlp_w)


if __name__ == "__main__":
    main()
