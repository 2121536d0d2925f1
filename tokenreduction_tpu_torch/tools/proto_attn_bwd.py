"""The training attention branch's backward recomputed from x alone, in two
arrangements of its attention products: the counterpart of
``tools/proto_attn_bwd.py``.

The JAX tool's kernel takes x, the branch's parameters, the cotangent dy
of its output and the row0 cotangent drow0 [B, H, 1, N], recomputes
LN -> qkv + bias -> p -> merged = round(p v) with no saved intermediate,
and returns dx (through the LayerNorm, in x's dtype) and the fp32 weight
gradients dwqkv and dwproj summed over the batch. Its two arrangements of
the four attention products that contract over N: ``loop`` (each at
width 64) and ``pack2`` (two at width 128: [ds; p] . [k | v] and
[ds | p]^T . [q | do], the unwanted quadrants computed and dropped). On
the card the question is whether two 128-wide products with shared
operand loads beat four 64-wide ones on mma.sync; ``pack2`` runs at every
width here (csrc/proto_attn_bwd.cu).

On the card (bf16) the backward is a chain of the port's kernels, as the
training branch's (``ops/fused_block_train.py`` ``_bwd_cuda``) but with
nothing saved: ``layer_norm``; the qkv ``gemm`` with its bias; ``gemm``
do = dy . Wproj; csrc/proto_attn_bwd.cu, which recomputes p, writes the
merged heads and dqkv and takes drow0 at row 0; ``gemm_wgrad`` twice into
the fp32 dwproj and dwqkv (one ``sum_partials_many`` launch sums their
partials); ``gemm`` dln = dqkv . Wqkv in fp32; ``layer_norm_bwd`` for dx
(its parameter gradients are not summed: the tool returns none).

``main()`` runs both arrangements at N = 197, 138, 97, 50 (the JAX
tool's), prints each output's relative difference between them, as the
JAX tool does, and the time of each beside the bound, the plain version
and the port's current route: the training branch's forward and its
backward chain (``_fwd_cuda`` + ``_bwd_cuda``), which saves what this
recomputes.

    python -m tokenreduction_tpu_torch.tools.proto_attn_bwd

runs on the card; with ``--device cpu`` the plain versions run, timed by
the host's clock.
"""

from __future__ import annotations

import torch

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.ops import fused_block_train as FBT
from tokenreduction_tpu_torch.tools import _measure as M
from tokenreduction_tpu_torch.tools.proto_attn import check_operands, max_rel

VARIANTS = ("loop", "pack2")
WIDTHS = (197, 138, 97, 50)  # the JAX tool's
ITERS = 20  # calls a timed run
PARAMS = ("ls", "lb", "wqkv", "bqkv", "wproj")
OUTPUTS = ("dx", "dwqkv", "dwproj")


def proto_attn_bwd_ref(x, w, dy, drow0, num_heads: int = M.H,
                       scale: float = M.SCALE, eps: float = M.EPS):
    """Plain version: (dx in x's dtype, dwqkv and dwproj fp32 in nn.Linear's
    layout), from ``attend_branch_train_bwd_ref`` at the TPU kernel's
    rounding points, given the parameters in fp32 (the same values) so
    that it returns the weight gradients before any cast."""
    p = {k: w[k].float() for k in PARAMS}
    dx, _, _, dwqkv, _, dwproj, _ = FBT.attend_branch_train_bwd_ref(
        x, *(p[k] for k in PARAMS), dy, drow0, num_heads, scale, eps)
    return dx, dwqkv, dwproj


def proto_attn_bwd(x, w, dy, drow0, variant: str = "loop",
                   num_heads: int = M.H, scale: float = M.SCALE,
                   eps: float = M.EPS):
    """(dx [B, N, D] in x's dtype, dwqkv [3D, D] and dwproj [D, D] in fp32)
    of the attention branch proj(attn(qkv(LN x))) at x, for its output's
    cotangent dy [B, N, D] (x's dtype) and the row0 cotangent drow0
    [B, H, N] (fp32). w: ls, lb, wqkv [3D, D], bqkv, wproj [D, D] in
    nn.Linear's layout. ``variant``: "loop" or "pack2". On the card bf16
    only, head dim 64, N <= 256 (the module docstring's chain);
    ``proto_attn_bwd.launches`` counts the card's calls."""
    if variant not in VARIANTS:
        raise ValueError(f"proto_attn_bwd: variant {variant!r} is none of "
                         f"{VARIANTS}")
    if not x.is_cuda:
        return proto_attn_bwd_ref(x, w, dy, drow0, num_heads, scale, eps)
    from tokenreduction_tpu_torch.ops import _build

    name = "proto_attn_bwd"
    check_operands(name, x, num_heads, dy, *(w[k] for k in PARAMS))
    B, N, D = x.shape
    _build.check_shapes(name, (w["ls"], (D,)), (w["lb"], (D,)),
                        (w["wqkv"], (3 * D, D)), (w["bqkv"], (3 * D,)),
                        (w["wproj"], (D, D)), (dy, x.shape),
                        (drow0, (B, num_heads, N)))
    if (drow0.dtype != torch.float32 or drow0.device != x.device
            or not drow0.is_contiguous()):
        raise ValueError(f"{name}: drow0 must be a contiguous fp32 tensor on "
                         f"{x.device}")
    M_ = B * N
    rows = x.view(M_, D)
    ln = torch.empty_like(rows)
    _build.layer_norm(rows, w["ls"], w["lb"], ln, eps=eps)
    qkv = torch.empty(B, N, 3 * D, dtype=x.dtype, device=x.device)
    _build.gemm(ln, w["wqkv"], w["bqkv"], qkv.view(M_, 3 * D))
    dy2 = dy.view(M_, D)
    dattn = torch.empty_like(x)
    _build.gemm(dy2, w["wproj"], None, dattn.view(M_, D), w_kn=True)
    merged = torch.empty_like(x)
    dqkv = torch.empty_like(qkv)
    _build.proto_attn_bwd(qkv, dattn, drow0, merged, dqkv, num_heads, scale,
                          variant=variant)
    f32 = dict(dtype=torch.float32, device=x.device)
    dwproj = torch.empty(D, D, **f32)
    sums = _build.gemm_wgrad(dy2, merged.view(M_, D), dwproj)
    dqkv = dqkv.view(M_, 3 * D)
    dwqkv = torch.empty(3 * D, D, **f32)
    sums += _build.gemm_wgrad(dqkv, ln, dwqkv)
    dln = torch.empty(M_, D, **f32)
    _build.gemm(dqkv, w["wqkv"], None, dln, w_kn=True)
    dx = torch.empty_like(x)
    dwb = torch.empty(2, D, dtype=w["ls"].dtype, device=x.device)
    _build.layer_norm_bwd(rows, w["ls"], dln, dx.view(M_, D), dwb, eps=eps)
    _build.sum_partials_many(sums)
    proto_attn_bwd.launches += 1
    return dx, dwqkv, dwproj


proto_attn_bwd.launches = 0


def current_route(x, w, dy, drow0, num_heads: int = M.H,
                  scale: float = M.SCALE, eps: float = M.EPS):
    """The port's route on the card: the training branch's forward, which
    saves LN, qkv, the merged heads and the row statistics, and its
    backward chain from them (``fused_block_train._fwd_cuda``,
    ``_bwd_cuda``); its seven gradients in the parameters' dtype."""
    bproj = torch.zeros_like(w["lb"])
    saved = FBT._fwd_cuda(x, w["ls"], w["lb"], w["wqkv"], w["bqkv"],
                          w["wproj"], bproj, num_heads, scale, eps)[2]
    return FBT._bwd_cuda(x, w["ls"], w["wqkv"], w["wproj"], saved, dy, drow0,
                         num_heads, scale, eps)


def cost(B: int, n: int, D: int = M.D, H: int = M.H) -> tuple[float, float]:
    """(operations, bytes) of the function at B x n: the qkv recompute, do,
    the two weight gradients and dln (22 B n D^2) and six attention
    products a head (12 B n^2 D); x, dy, drow0 and the weights in, dx and
    the fp32 weight gradients out."""
    flops = 22 * B * n * D * D + 12 * B * n * n * D
    nbytes = 2 * (3 * B * n * D + 4 * D * D + 6 * D) + 4 * B * H * n \
        + 4 * 4 * D * D
    return flops, nbytes


def cotangents(B: int, n: int, device, seed: int = 3):
    """dy [B, n, D] bf16 ~ N(0, 1) and drow0 [B, H, n] fp32 ~ N(0, 0.1^2),
    the JAX tool's, from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    dy = torch.randn(B, n, M.D, generator=g).to(device, torch.bfloat16)
    drow0 = (torch.randn(B, M.H, n, generator=g) * 0.1).to(device)
    return dy, drow0


def main(argv=None):
    p = M.parser("The attention branch's backward recomputed from x: the "
                 "loop and pack2 arrangements against each other and the "
                 "port's current route.")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    iters = args.iters or ITERS
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu (plain versions)", flush=True)
    w = {k: v for k, v in M.weights(device).items() if k in PARAMS}
    for n in WIDTHS:
        x = M.inputs(args.batch, n, device)
        dy, drow0 = cotangents(args.batch, n, device)
        bound, by = M.bound_ms(*cost(args.batch, n))
        plain = M.timeit(lambda: proto_attn_bwd_ref(x, w, dy, drow0), device,
                         iters)
        line = f"N={n} bound {bound:.4f} ms ({by}), plain {plain:.4f} ms"
        if device.type == "cuda":
            route = M.timeit(lambda: current_route(x, w, dy, drow0), device,
                             iters)
            line += f", current route (forward + backward) {route:.4f} ms"
        print(line, f"({M.clock(device)})", flush=True)
        outs = {}
        for variant in VARIANTS:
            ms = M.timeit(lambda: proto_attn_bwd(x, w, dy, drow0, variant),
                          device, iters)
            outs[variant] = proto_attn_bwd(x, w, dy, drow0, variant)
            print(f"N={n} {variant}: {ms:.4f} ms ({M.clock(device)})",
                  flush=True)
        for name, a, b in zip(OUTPUTS, outs["pack2"], outs["loop"]):
            print(f"  N={n} {name} rel|d| = {max_rel(a, b):.2e}", flush=True)


if __name__ == "__main__":
    main()
