"""Kernel-variant tuning on the card: the counterpart of
``tools/tune_kernels.py``.

1. glue: the top-k and gather glue of topk@0.7's reductions (``torch.topk``
   against ``torch.take_along_dim``; PyTorch has no ``approx_max_k``);
2. attention: ``attn_joint``, the qkv product fused into the attention
   (the counterpart of the TPU kernel ``tools/tune_kernels.py:160``),
   beside the port's ``fused_block_attention`` at N = 197, 138, 97, 68;
3. MLP: ``mlp_chunked``, the MLP half with its hidden tensor kept on chip
   (``tools/tune_kernels.py:282``), beside ``fused_mlp_residual`` at
   N = 197 and 68, with max|diff| as the JAX tool prints it.

What the JAX tool found on the TPU is in its file and is no target here:
this prints the card's own comparison against the port's current route,
each time beside its bound (the bf16 rate or the memory rate).

    python -m tokenreduction_tpu_torch.tools.tune_kernels --part mlp

runs on the card; with ``--device cpu`` the plain versions run, timed by
the host's clock. On a CUDA tensor each kernel wrapper launches its kernel
or raises (bf16 only); on a CPU tensor it runs its plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.ops.flash_attention import (
    fused_block_attention,
    layer_norm_f32,
    linear_f32,
    packed_heads,
)
from tokenreduction_tpu_torch.ops.fused_mlp import fused_mlp_residual
from tokenreduction_tpu_torch.tools import _measure as M

ITERS = 40  # the JAX tool's chained iterations a timed run
ATTN_N = (197, 138, 97, 68)
MLP_N = (197, 68)
# topk@0.7's reductions: (tokens kept besides CLS, tokens before)
GLUE = ((137, 197), (96, 138), (67, 97))


# ------------------------------------------------------------ attention
def attn_joint_ref(x, w, num_heads: int, scale: float, eps: float = 1e-6):
    """Plain PyTorch version of ``attn_joint`` with the TPU kernel's
    rounding points: (x + proj(attn(qkv(LN x))), row0 [B, H, N] fp32,
    colsum [B, H, N] fp32). LN and the logits in fp32, the LN output and
    qkv rounded to x's dtype, p = e / sum(e) rounded before the value
    product, the merged heads rounded, x + proj summed in fp32 and rounded
    once. w: the port's block weights ([out, in] layout)."""
    x32 = x.float()
    ln = layer_norm_f32(x32, w["ls"], w["lb"], eps).to(x.dtype)
    qkv = linear_f32(ln, w["wqkv"], w["bqkv"]).to(x.dtype)
    merged, p = joint_attention_ref(qkv, num_heads, scale)
    out = (x32 + linear_f32(merged, w["wproj"], w["bproj"])).to(x.dtype)
    return out, p[:, :, 0, :], p.sum(2)


def joint_attention_ref(qkv, num_heads: int, scale: float):
    """The attention of ``attn_joint_ref`` off a packed qkv [B, N, 3D]:
    (merged heads [B, N, D] in qkv's dtype, the fp32 probabilities
    [B, H, N, N]), p = e / sum(e) rounded before the value product."""
    B, N, D3 = qkv.shape
    q, k, v = (t.float() for t in packed_heads(qkv, num_heads))
    logits = (q @ k.transpose(-1, -2)) * scale
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    merged = (p.to(qkv.dtype).float() @ v).to(qkv.dtype)
    return merged.transpose(1, 2).reshape(B, N, D3 // 3), p


def attn_joint(x, w, num_heads: int, scale: float, *, eps: float = 1e-6,
               stages: int = 2, with_scores: bool = False):
    """x [B, N, D] -> x + proj(attn(qkv(LN1 x))), and with ``with_scores``
    also (row0, colsum) [B, H, N] fp32. w: the block weights in
    nn.Linear's layout (wqkv [3D, D], wproj [D, D]).

    On the card (bf16, head dim 64, N <= 256) three launches: the
    ``layer_norm`` kernel writes LN1's rows; csrc/attn_joint.cu makes each
    (image, head)'s q, k and v from them on chip and runs the attention,
    writing the merged heads and the by-products (the qkv tensor never
    reaches device memory); the ``gemm`` kernel adds proj, its bias and
    the residual. The TPU kernel's images a grid cell (its ``group``) have
    no counterpart: a block takes one (image, head).
    ``stages`` (1 or 2) is the card kernel's own tunable: the D chunks of
    LN rows and weights a block keeps in flight; the result does not
    depend on it. ``attn_joint.launches`` counts the card's launches."""
    if not x.is_cuda:
        out, row0, colsum = attn_joint_ref(x, w, num_heads, scale, eps)
        return (out, (row0, colsum)) if with_scores else out
    from tokenreduction_tpu_torch.ops import _build
    from tokenreduction_tpu_torch.ops.flash_attention import (
        check_attention_operands,
    )

    name = "attn_joint"
    check_attention_operands(name, x, num_heads, w["ls"], w["lb"], w["wqkv"],
                             w["bqkv"], w["wproj"], w["bproj"])
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the card's kernel takes bf16, got "
                        f"{x.dtype}")
    if stages not in (1, 2):
        raise ValueError(f"{name}: stages must be 1 or 2, got {stages}")
    B, N, D = x.shape
    rows = x.view(B * N, D)
    ln = torch.empty_like(x)
    _build.layer_norm(rows, w["ls"], w["lb"], ln.view(B * N, D), eps=eps)
    merged = torch.empty_like(x)
    row0 = colsum = None
    if with_scores:
        row0 = torch.empty(B, num_heads, N, dtype=torch.float32,
                           device=x.device)
        colsum = torch.empty_like(row0)
    _build.attn_joint(ln, w["wqkv"], w["bqkv"], merged, num_heads, scale,
                      stages=stages, row0=row0, colsum=colsum)
    out = torch.empty_like(x)
    _build.gemm(merged.view(B * N, D), w["wproj"], w["bproj"],
                out.view(B * N, D), res=rows)
    attn_joint.launches += 1
    return (out, (row0, colsum)) if with_scores else out


attn_joint.launches = 0


def current_attention(x, w, num_heads: int = M.H, scale: float = M.SCALE):
    """The port's route for the same block: ``fused_block_attention``."""
    return fused_block_attention(x, w["ls"], w["lb"], w["wqkv"], w["bqkv"],
                                 w["wproj"], w["bproj"], num_heads, scale)


# ------------------------------------------------------------------ MLP
def mlp_chunked_ref(x, w, eps: float = 1e-6):
    """Plain PyTorch version of ``mlp_chunked`` with the TPU kernel's
    rounding points: LN in fp32 rounded to x's dtype, fc1 + b1 and the
    exact GELU in fp32, the hidden rounded, (x + fc2) + b2 in fp32 rounded
    once."""
    dt = x.dtype
    x32 = x.float()
    ln = layer_norm_f32(x32, w["ls"], w["lb"], eps).to(dt)
    h = F.gelu(linear_f32(ln, w["w1"], w["b1"])).to(dt)
    return ((x32 + h.float() @ w["w2"].float().T)
            + w["b2"].float()).to(dt)


def mlp_chunked(x, w, chunks: int, tile: int = 512, eps: float = 1e-6):
    """x [..., N, D] -> x + fc2(gelu(fc1(LN2 x))), the same shape. w: the
    block weights in nn.Linear's layout (w1 [4D, D], w2 [D, 4D]).

    On the card (bf16, D = 384) one launch of csrc/mlp_chunked.cu: a block
    keeps 64 rows and walks the hidden units in slices, so the hidden
    tensor never reaches device memory. ``chunks``, the TPU kernel's cut
    of the hidden width, must divide it, as there; the card's kernel
    walks the hidden units in its own slices (``_build.mlp_chunked_config``)
    and adds fc2's products in the same order whatever ``chunks`` is, so
    the result does not depend on it. ``tile``, the TPU kernel's rows a
    grid step, changes nothing. ``mlp_chunked.launches`` counts the card's
    launches."""
    h4 = w["w1"].shape[0]
    if chunks < 1 or h4 % chunks:
        raise ValueError(f"mlp_chunked: chunks={chunks} must divide the "
                         f"hidden width {h4}")
    if tile < 1:
        raise ValueError(f"mlp_chunked: tile={tile} must be positive")
    if not x.is_cuda:
        return mlp_chunked_ref(x, w, eps)
    from tokenreduction_tpu_torch.ops import _build
    from tokenreduction_tpu_torch.ops.fused_mlp import check_mlp_operands

    name = "mlp_chunked"
    rows = x.reshape(-1, x.shape[-1])
    check_mlp_operands(name, rows[None], w["ls"], w["lb"], w["w1"], w["b1"],
                       w["w2"], w["b2"])
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the card's kernel takes bf16, got "
                        f"{x.dtype}")
    if rows.shape[1] != M.D:
        raise ValueError(f"{name}: the card's kernel is built for D={M.D}, "
                         f"got {rows.shape[1]}")
    if h4 % _build.mlp_chunked_config()["HC"]:
        raise ValueError(f"{name}: the hidden width {h4} is no multiple of "
                         f"{_build.mlp_chunked_config()['HC']}")
    out = torch.empty_like(rows)
    _build.mlp_chunked(rows, w["ls"], w["lb"], w["w1"], w["b1"], w["w2"],
                       w["b2"], out, eps=eps)
    mlp_chunked.launches += 1
    return out.view(x.shape)


mlp_chunked.launches = 0


def current_mlp(x, w):
    """The port's route for the same half: ``fused_mlp_residual``."""
    return fused_mlp_residual(x, w["ls"], w["lb"], w["w1"], w["b1"],
                              w["w2"], w["b2"])


# --------------------------------------------------------------- driver
def _line(label: str, ms: float, cost, device) -> str:
    bound, by = M.bound_ms(*cost)
    return (f"{label} {ms:8.4f} ms ({M.clock(device)}), bound {bound:.4f} "
            f"ms ({by})")


def max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def glue_variants(device, iters: int, B: int):
    x0 = M.inputs(B, 197, device)
    ids = {left: torch.arange(left + 1, device=device).expand(B, -1)
           for left, _ in GLUE}
    cls = torch.zeros(B, 1, dtype=torch.long, device=device)

    def topk_only():
        for left, n in GLUE:
            torch.topk(x0[:, 1:n, 0].float(), left)

    def gather_only():
        x = x0
        for left, _ in GLUE:
            x = torch.take_along_dim(x, ids[left][..., None], 1)

    def single_gather():
        x = x0
        for left, _ in GLUE:
            _, idx = torch.topk(x[:, 1:, 0].float(), left)
            full = torch.cat([cls, idx + 1], 1)
            x = torch.take_along_dim(x, full[..., None], 1)

    for name, body in (("topk_only", topk_only), ("gather_only", gather_only),
                       ("single_gather", single_gather)):
        ms = M.timeit(body, device, iters)
        print(f"glue/{name:22s} {ms:8.4f} ms ({M.clock(device)})",
              flush=True)
    print("glue/approx_topk_only: none (PyTorch has no approx_max_k)",
          flush=True)


def attn_variants(device, iters: int, B: int):
    w = M.weights(device)
    for n in ATTN_N:
        x0 = M.inputs(B, n, device)
        cost = M.attn_cost(B, n)
        base = M.timeit(lambda: current_attention(x0, w), device, iters)
        print(_line(f"attn/current        N={n:3d}", base, cost, device),
              flush=True)
        for stages in (1, 2):
            ms = M.timeit(lambda: attn_joint(x0, w, M.H, M.SCALE,
                                             stages=stages),
                          device, iters)
            print(_line(f"attn/joint stages={stages} N={n:3d}", ms, cost,
                        device), flush=True)
        print("  max|diff|:", max_diff(attn_joint(x0, w, M.H, M.SCALE),
                                       current_attention(x0, w)[0]),
              flush=True)


def mlp_variants(device, iters: int, B: int):
    w = M.weights(device)
    for n in MLP_N:
        x0 = M.inputs(B, n, device)
        cost = M.mlp_cost(B, n)
        base = M.timeit(lambda: current_mlp(x0, w), device, iters)
        print(_line(f"mlp/current       N={n:3d}", base, cost, device),
              flush=True)
        for chunks in (2, 4):
            ms = M.timeit(lambda: mlp_chunked(x0, w, chunks), device, iters)
            print(_line(f"mlp/chunks={chunks}      N={n:3d}", ms, cost,
                        device), flush=True)
        print("  max|diff|:", max_diff(current_mlp(x0, w),
                                       mlp_chunked(x0, w, 4)), flush=True)


PARTS = {"glue": glue_variants, "attn": attn_variants, "mlp": mlp_variants}


def main(argv=None):
    p = M.parser("Kernel-variant tuning: the joint attention and the "
                 "chunked MLP against the port's current route.")
    p.add_argument("--part", choices=(*PARTS, "all"), default="all")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    iters = args.iters or ITERS
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu (plain versions)", flush=True)
    for name, part in PARTS.items():
        if args.part in (name, "all"):
            with torch.no_grad():
                part(device, iters, args.batch)


if __name__ == "__main__":
    main()
