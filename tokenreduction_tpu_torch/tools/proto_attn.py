"""Arrangements of the per-head attention core on the card: the counterpart
of ``tools/proto_attn.py``.

The JAX tool asks how a block's attention core is best arranged around
its heads, at DeiT-S width without LayerNorm or biases:

    out = round(x + proj(attn(round(x . Wqkv))))

in three arrangements that compute the same function: ``loop`` (one
head's logits, softmax and value product at a time), ``avpair`` (each
head pair's value product as one 128-wide product [P_h | P_h+1] .
blockdiag(V_h, V_h+1), the zero blocks multiplied) and ``stacked`` (the
logits of all heads in one buffer, one softmax pass over it). On the card
the question is whether packing two heads into one product, or stacking
all heads' softmax, changes the time on mma.sync, whose n-granularity is
8 (csrc/proto_attn.cu says how each is laid out).

``main()`` times each arrangement at N = 138, 197, 97, 68 (the JAX tool's
widths) beside its bound, its plain version and the port's current route
for the same function (the qkv GEMM, the sm_90a attention, the proj GEMM
with the residual), by CUDA events around calls issued back to back. The
JAX tool's group of images a grid step (G) has no counterpart: on the card
a block takes one image's head, head pair or query tile, so nothing sets
it.

    python -m tokenreduction_tpu_torch.tools.proto_attn

runs on the card; with ``--device cpu`` the plain versions run, timed by
the host's clock. On a CUDA tensor ``proto_attn`` launches its kernels or
raises (bf16 only); on a CPU tensor it runs ``proto_attn_ref``.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.ops.flash_attention import _check_width
from tokenreduction_tpu_torch.tools import _measure as M
from tokenreduction_tpu_torch.tools.tune_kernels import joint_attention_ref

VARIANTS = ("loop", "avpair", "stacked")
WIDTHS = (138, 197, 97, 68)  # the JAX tool's
ITERS = 40  # calls a timed run


def proto_attn_ref(x, w, num_heads: int = M.H, scale: float = M.SCALE):
    """Plain PyTorch version with the TPU kernel's rounding points: qkv
    summed in fp32 and rounded; the logits in fp32, scaled after the
    product; p = e / sum(e) rounded before the value product; each head's
    merged output rounded; x + proj summed in fp32 and rounded once (the
    projection is not rounded before the residual). w: wqkv [3D, D] and
    wproj [D, D] in nn.Linear's layout, no biases."""
    dt = x.dtype
    qkv = (x.float() @ w["wqkv"].float().T).to(dt)
    merged = joint_attention_ref(qkv, num_heads, scale)[0]
    return (x.float() + merged.float() @ w["wproj"].float().T).to(dt)


def check_operands(name: str, x, num_heads: int, *weights):
    """Raise on anything the card's kernels do not take: bf16 [B, N, D]
    with head dim 64, N <= 256, wqkv [3D, D] and wproj [D, D], contiguous
    and 16-byte aligned on x's device."""
    from tokenreduction_tpu_torch.ops import _build

    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, N, D], got {tuple(x.shape)}")
    _, N, D = x.shape
    if D % num_heads:
        raise ValueError(f"{name}: D={D} is not a multiple of {num_heads} "
                         "heads")
    _check_width(name, N, D // num_heads)
    _build.check_operands(name, x, *weights)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the card's kernels take bf16, got "
                        f"{x.dtype}")


def proto_attn(x, w, variant: str = "loop", num_heads: int = M.H,
               scale: float = M.SCALE):
    """x [B, N, D] -> x + proj(attn(qkv(x))) [B, N, D] in x's dtype, in
    arrangement ``variant`` (``VARIANTS``). w: wqkv [3D, D], wproj [D, D]
    in nn.Linear's layout, no biases.

    On the card (bf16, head dim 64, N <= 256) three launches: the bf16
    GEMM writes the packed qkv; csrc/proto_attn.cu runs each head's
    attention in the arrangement and writes the merged heads; the GEMM adds
    proj and the residual x in fp32 before its one rounding.
    ``proto_attn.launches`` counts the card's calls."""
    if variant not in VARIANTS:
        raise ValueError(f"proto_attn: variant {variant!r} is none of "
                         f"{VARIANTS}")
    if not x.is_cuda:
        return proto_attn_ref(x, w, num_heads, scale)
    from tokenreduction_tpu_torch.ops import _build

    name = "proto_attn"
    check_operands(name, x, num_heads, w["wqkv"], w["wproj"])
    B, N, D = x.shape
    _build.check_shapes(name, (w["wqkv"], (3 * D, D)), (w["wproj"], (D, D)))
    if variant == "avpair" and num_heads % 2:
        raise ValueError(f"{name}: avpair pairs the heads; {num_heads} is odd")
    if _build.proto_attn_smem(N, num_heads, variant) > 232448:
        raise ValueError(f"{name}: {variant} at N={N} and {num_heads} heads "
                         "takes more shared memory than a block has")
    rows = x.view(B * N, D)
    qkv = torch.empty(B, N, 3 * D, dtype=x.dtype, device=x.device)
    _build.gemm(rows, w["wqkv"], None, qkv.view(B * N, 3 * D))
    merged = torch.empty_like(x)
    _build.proto_attn(qkv, merged, num_heads, scale, variant=variant)
    out = torch.empty_like(x)
    _build.gemm(merged.view(B * N, D), w["wproj"], None, out.view(B * N, D),
                res=rows)
    proto_attn.launches += 1
    return out


proto_attn.launches = 0


def current_route(x, w, num_heads: int = M.H, scale: float = M.SCALE):
    """The port's route for the same function on the card: the qkv GEMM,
    the sm_90a attention with the normalised probabilities rounded
    (``_build.short_attention``), the proj GEMM with the residual."""
    from tokenreduction_tpu_torch.ops import _build

    B, N, D = x.shape
    rows = x.view(B * N, D)
    qkv = torch.empty(B, N, 3 * D, dtype=x.dtype, device=x.device)
    _build.gemm(rows, w["wqkv"], None, qkv.view(B * N, 3 * D))
    merged = torch.empty_like(x)
    _build.short_attention(qkv, merged, num_heads, scale, norm_p=True)
    out = torch.empty_like(x)
    _build.gemm(merged.view(B * N, D), w["wproj"], None, out.view(B * N, D),
                res=rows)
    return out


def cost(B: int, n: int, D: int = M.D) -> tuple[float, float]:
    """(operations, bytes) of the function at B x n: the two products and
    the attention's two; x in, out, the two weights."""
    return (8 * B * n * D * D + 4 * B * n * n * D,
            2 * (2 * B * n * D + 4 * D * D))


def max_rel(a, b) -> float:
    """max|a - b| / max|b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def main(argv=None):
    p = M.parser("Arrangements of the per-head attention core (loop, "
                 "avpair, stacked) against the port's current route.")
    p.add_argument("--variant", choices=(*VARIANTS, "all"), default="all")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    iters = args.iters or ITERS
    variants = VARIANTS if args.variant == "all" else (args.variant,)
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu (plain versions)", flush=True)
    w = {k: v for k, v in M.weights(device).items()
         if k in ("wqkv", "wproj")}
    with torch.no_grad():
        for n in WIDTHS:
            x = M.inputs(args.batch, n, device)
            bound, by = M.bound_ms(*cost(args.batch, n))
            plain = M.timeit(lambda: proto_attn_ref(x, w), device, iters)
            line = (f"N={n} bound {bound:.4f} ms ({by}), plain {plain:.4f} "
                    "ms")
            if device.type == "cuda":
                route = M.timeit(lambda: current_route(x, w), device, iters)
                line += f", current route {route:.4f} ms"
            print(line, f"({M.clock(device)})", flush=True)
            outs = {}
            for variant in variants:
                ms = M.timeit(lambda: proto_attn(x, w, variant), device,
                              iters)
                outs[variant] = proto_attn(x, w, variant)
                print(f"N={n} {variant}: {ms:.4f} ms ({M.clock(device)})",
                      flush=True)
            for variant in variants[1:]:
                same = torch.equal(outs[variant], outs[variants[0]])
                print(f"  N={n} {variant} against {variants[0]}: rel|d| = "
                      f"{max_rel(outs[variant], outs[variants[0]]):.2e}"
                      f"{', the same bits' if same else ''}", flush=True)


if __name__ == "__main__":
    main()
