"""Where the MLP half's time goes on the card: the counterpart of
``tools/proto_gelu.py``.

The JAX tool swaps parts of the fused MLP kernel (#4) at trace time and
times what is left. Here the port's route for #4
(``ops/fused_mlp.py``: ``layer_norm``, the fc1 ``gemm`` with GELU in its
epilogue, the fc2 ``gemm`` with its bias and the residual) runs in the
tool's variants at N = 197, B = 256, bf16:

- ``erf``: the route's own exact-erf GELU (``fused_mlp_residual``);
- ``identity``: the fc1 GEMM without its activation;
- ``tanh``: GELU's tanh form in the fc1 GEMM's epilogue (an option of
  csrc/gemm_sm90.cu);
- ``no-LN``: a cast of x in place of the ``layer_norm`` launch (x is
  already bf16, so no launch);
- ``chunks=1/4/8``: the chunked MLP with its hidden tensor on chip
  (``tune_kernels.mlp_chunked``, csrc/mlp_chunked.cu).

Each time (CUDA events around calls issued back to back) prints beside
the bound of the half and the variant's max|diff| from its own plain
version.

    python -m tokenreduction_tpu_torch.tools.proto_gelu

runs on the card; with ``--device cpu`` the plain versions run, timed by
the host's clock.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tokenreduction_tpu_torch.core.device import resolve_device
from tokenreduction_tpu_torch.ops.flash_attention import (
    layer_norm_f32,
    linear_f32,
)
from tokenreduction_tpu_torch.ops.fused_mlp import (
    check_mlp_operands,
    fused_mlp_residual,
)
from tokenreduction_tpu_torch.tools import _measure as M
from tokenreduction_tpu_torch.tools.tune_kernels import (
    max_diff,
    mlp_chunked,
    mlp_chunked_ref,
)

VARIANTS = ("erf", "identity", "tanh", "no-LN")
CHUNKS = (1, 4, 8)
WIDTHS = (197,)  # the JAX tool's
ITERS = 40
# the fc1 GEMM's epilogue activation of each variant (_build.Gelu's names)
GEMM_GELU = {"erf": "ERF", "identity": "NONE", "tanh": "TANH",
             "no-LN": "ERF"}
ACTIVATION = {"erf": F.gelu, "identity": lambda h: h,
              "tanh": lambda h: F.gelu(h, approximate="tanh"),
              "no-LN": F.gelu}


def mlp_variant_ref(x, w, variant: str, eps: float = M.EPS):
    """Plain version of a variant at the route's rounding points: the LN
    output (or, no-LN, x itself) and the hidden tensor rounded to x's
    dtype; x + fc2 + b2 summed in fp32 and rounded once."""
    dt = x.dtype
    x32 = x.float()
    ln = x if variant == "no-LN" else \
        layer_norm_f32(x32, w["ls"], w["lb"], eps).to(dt)
    h = ACTIVATION[variant](linear_f32(ln, w["w1"], w["b1"])).to(dt)
    return (x32 + linear_f32(h, w["w2"], w["b2"])).to(dt)


def mlp_variant(x, w, variant: str, eps: float = M.EPS):
    """x [B, N, D] -> the MLP half in ``variant`` (``VARIANTS``). On the
    card (bf16) the route's launches with the variant's change; on the CPU
    ``mlp_variant_ref``."""
    if variant not in VARIANTS:
        raise ValueError(f"proto_gelu: variant {variant!r} is none of "
                         f"{VARIANTS}")
    if not x.is_cuda:
        return mlp_variant_ref(x, w, variant, eps)
    if variant == "erf":
        return fused_mlp_residual(x, w["ls"], w["lb"], w["w1"], w["b1"],
                                  w["w2"], w["b2"], eps=eps)
    from tokenreduction_tpu_torch.ops import _build

    check_mlp_operands("proto_gelu", x, w["ls"], w["lb"], w["w1"], w["b1"],
                       w["w2"], w["b2"])
    if x.dtype != torch.bfloat16:
        raise TypeError(f"proto_gelu: the variants run bf16, got {x.dtype}")
    rows = x.reshape(-1, x.shape[-1])
    ln = rows
    if variant != "no-LN":
        ln = torch.empty_like(rows)
        _build.layer_norm(rows, w["ls"], w["lb"], ln, eps=eps)
    hidden = torch.empty(rows.shape[0], w["w1"].shape[0], dtype=x.dtype,
                         device=x.device)
    _build.gemm(ln, w["w1"], w["b1"], hidden,
                gelu=_build.Gelu[GEMM_GELU[variant]])
    out = torch.empty_like(rows)
    _build.gemm(hidden, w["w2"], w["b2"], out, res=rows)
    return out.view(x.shape)


def main(argv=None):
    p = M.parser("The MLP half in the JAX tool's variants: GELU forms, no "
                 "LayerNorm, hidden chunks.")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    iters = args.iters or ITERS
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu (plain versions)", flush=True)
    w = M.weights(device)
    with torch.no_grad():
        for n in WIDTHS:
            x = M.inputs(args.batch, n, device)
            bound, by = M.bound_ms(*M.mlp_cost(args.batch, n))
            print(f"N={n} bound {bound:.4f} ms ({by})", flush=True)
            for variant in VARIANTS:
                ms = M.timeit(lambda: mlp_variant(x, w, variant), device,
                              iters)
                d = max_diff(mlp_variant(x, w, variant),
                             mlp_variant_ref(x, w, variant))
                print(f"  N={n} {variant:10s} {ms:8.4f} ms "
                      f"({M.clock(device)}), max|diff| from its plain "
                      f"version {d:.3e}", flush=True)
            for chunks in CHUNKS:
                ms = M.timeit(lambda: mlp_chunked(x, w, chunks), device,
                              iters)
                d = max_diff(mlp_chunked(x, w, chunks),
                             mlp_chunked_ref(x, w))
                print(f"  N={n} chunks={chunks}   {ms:8.4f} ms "
                      f"({M.clock(device)}), max|diff| from its plain "
                      f"version {d:.3e}", flush=True)


if __name__ == "__main__":
    main()
