"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (Hopper:
the kernels are built for sm_90a). Phases, each printing its own lines:

0. device: refuse to run without CUDA; print the card's name and power
   limit (nvidia-smi), torch and CUDA versions; turn TF32 off.
1. build: compile tokenreduction_tpu_torch/csrc/*.cu with nvcc into
   build/tokenreduction_tpu_torch/<source hash>/.
2. kernels: each kernel counterpart against its plain PyTorch version on
   the same CUDA tensors at the main path's widths, fp32 at B=32 (bound
   1e-4 of max|plain|) and bf16 at B=256 (bound 2e-2 of max|plain|), with
   CUDA-event times (median of 20 runs). In bf16 the block's output is
   dominated by its residual, so each bf16 launch is also held alone,
   with no residual, against its plain version at B=256, relative to that
   tensor's own max: LayerNorm (bf16, fp32 and gathered rows), the qkv
   and fc1+GELU GEMMs and the attention's merged heads within 1e-2 (one
   to three bf16 ulps of the max, where two fp32 sums round apart); the
   attention's fp32 row0 and colsum and the proj and fc2 GEMMs with fp32
   output within 1e-4.
3. models: DeiT-S dense, topk@0.7 and topk@0.25 (loc 3 6 9) at full width
   with seeded weights on the card (kernels) against the same model on the
   CPU (plain versions), with the launch counts of one forward. fp32 at
   B=8: logits within 1e-4 of max|CPU|, the same top-1 and the same kept
   ids. bf16 at B=32: top-1 agreement at least 0.9, at least 0.9 of the
   kept ids in the CPU's kept set, and dense logits within 2e-2 of
   max|CPU|. Random weights make near-uniform attention, so the top-k
   scores lie closer than a bf16 ulp and a few kept ids differ; the topk
   models' bf16 logits, which then see other tokens, are reported only.
   Kept_Tokens flips (same id at the same rank) are reported.
4. serve: 5 batches of 256 bf16 images through each model; outputs must
   be finite; img/s over batches 2-5.

No failure is caught: any phase that fails ends the script with a
traceback and a non-zero exit code, before the result lines. The last two
lines are the kernels' JSON record and the result JSON.
"""

from __future__ import annotations

import copy
import json
import pathlib
import statistics
import subprocess
import time

import torch

import tokenreduction_tpu_torch
from tokenreduction_tpu_torch import create_model
import torch.nn.functional as F

from tokenreduction_tpu_torch.ops.flash_attention import (
    attention_ref,
    fused_block_attention,
    fused_block_attention_ref,
    layer_norm_f32,
    linear_f32,
)
from tokenreduction_tpu_torch.ops.fused_full_block import (
    fused_full_block,
    fused_full_block_ref,
)
from tokenreduction_tpu_torch.ops.fused_mlp import (
    fused_mlp_gather_residual,
    fused_mlp_gather_residual_ref,
)

DEVICE = "cuda"
D, HEADS, H4 = 384, 6, 1536  # DeiT-S
SCALE = (D // HEADS) ** -0.5
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # of max|plain|
BATCH = {torch.float32: 32, torch.bfloat16: 256}
# a bf16 launch alone, of the tensor's own max|plain|: bf16 outputs, and
# fp32 outputs of bf16 operands
LAUNCH_BOUND = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# of max|CPU|; in bf16 for dense only (no selection)
MODEL_BOUND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MODEL_BATCH = {torch.float32: 8, torch.bfloat16: 32}
MODEL_TOP1 = {torch.float32: 1.0, torch.bfloat16: 0.9}
KEPT_SET = {torch.float32: 1.0, torch.bfloat16: 0.9}  # share of kept ids
EPS = 1e-6
WRAPPERS = {
    "fused_full_block": fused_full_block,
    "fused_block_attention": fused_block_attention,
    "fused_mlp_gather_residual": fused_mlp_gather_residual,
}
REPLACES = {
    "fused_full_block": "tokenreduction_tpu/ops/fused_full_block.py:118",
    "fused_block_attention": "tokenreduction_tpu/ops/flash_attention.py:660",
    "fused_mlp_gather_residual": "tokenreduction_tpu/ops/fused_mlp.py:192",
}
# the kernel wrapper of each counterpart, and the CUDA sources it launches
# (the first is the record's "source")
WRAPPER_SOURCES = {
    "fused_full_block": "tokenreduction_tpu_torch/ops/fused_full_block.py",
    "fused_block_attention":
        "tokenreduction_tpu_torch/ops/flash_attention.py",
    "fused_mlp_gather_residual": "tokenreduction_tpu_torch/ops/fused_mlp.py",
}
CUDA_SOURCES = {
    "fused_full_block": ["tokenreduction_tpu_torch/csrc/ln_gemm.cu",
                         "tokenreduction_tpu_torch/csrc/short_attention.cu"],
    "fused_block_attention": [
        "tokenreduction_tpu_torch/csrc/short_attention.cu",
        "tokenreduction_tpu_torch/csrc/ln_gemm.cu"],
    "fused_mlp_gather_residual": ["tokenreduction_tpu_torch/csrc/ln_gemm.cu"],
}
FULL_BLOCK_N = (197, 138, 97, 68, 50, 13, 4)
BLOCK_ATTN_N = (197, 138, 97, 50, 13)
MLP_GATHER_NK = ((197, 138), (138, 97), (97, 68), (197, 50), (50, 13),
                 (13, 4))
MODELS = {
    "dense": ("deit_small_patch16_224_local", {}),
    "topk@0.7": ("topk_small_patch16_224",
                 dict(reduction_loc=(3, 6, 9), keep_rate=(0.7,))),
    "topk@0.25": ("topk_small_patch16_224",
                  dict(reduction_loc=(3, 6, 9), keep_rate=(0.25,))),
}
# launches of one forward: 12 score-less blocks (dense); 9 score-less
# blocks and 3 reduction blocks (topk at loc 3 6 9)
PER_FORWARD = {
    "dense": dict(fused_full_block=12, fused_block_attention=0,
                  fused_mlp_gather_residual=0),
    "topk@0.7": dict(fused_full_block=9, fused_block_attention=3,
                     fused_mlp_gather_residual=3),
}
PER_FORWARD["topk@0.25"] = PER_FORWARD["topk@0.7"]
SERVE_BATCHES, SERVE_B = 5, 256


def require(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def counts() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() over `runs` runs, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def block_params(dtype, gen):
    """Seeded block weights in nn.Linear layout, on the card."""
    def r(*shape, scale=0.05, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=gen)) \
            .to(device=DEVICE, dtype=dtype)

    return dict(
        ls1=r(D, scale=0.1, shift=1.0), lb1=r(D, scale=0.1),
        wqkv=r(3 * D, D), bqkv=r(3 * D), wproj=r(D, D), bproj=r(D),
        ls2=r(D, scale=0.1, shift=1.0), lb2=r(D, scale=0.1),
        w1=r(H4, D), b1=r(H4), w2=r(D, H4), b2=r(D))


def kernel_cases(dtype, gen):
    """(kernel name, shape label, kernel call, plain call) at the main
    path's widths."""
    B = BATCH[dtype]
    p = block_params(dtype, gen)
    attn = [p[k] for k in ("ls1", "lb1", "wqkv", "bqkv", "wproj", "bproj")]
    mlp = [p[k] for k in ("ls2", "lb2", "w1", "b1", "w2", "b2")]

    def x_of(N):
        return torch.randn(B, N, D, generator=gen).to(DEVICE, dtype)

    for N in FULL_BLOCK_N:
        x = x_of(N)
        yield ("fused_full_block", f"B={B} N={N}",
               lambda x=x: fused_full_block(x, *attn, *mlp, HEADS, SCALE),
               lambda x=x: fused_full_block_ref(x, *attn, *mlp, HEADS, SCALE))
    for N in BLOCK_ATTN_N:
        x = x_of(N)
        yield ("fused_block_attention", f"B={B} N={N}",
               lambda x=x: fused_block_attention(x, *attn, HEADS, SCALE),
               lambda x=x: fused_block_attention_ref(x, *attn, HEADS, SCALE))
    for N, K in MLP_GATHER_NK:
        x = x_of(N)
        idx = torch.stack([
            torch.cat([torch.zeros(1, dtype=torch.long),
                       1 + torch.randperm(N - 1, generator=gen)[:K - 1]])
            for _ in range(B)]).to(DEVICE)
        yield ("fused_mlp_gather_residual", f"B={B} N={N} K={K}",
               lambda x=x, idx=idx: fused_mlp_gather_residual(x, idx, *mlp),
               lambda x=x, idx=idx: fused_mlp_gather_residual_ref(x, idx,
                                                                  *mlp))


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, that over max|want|) after checking shape and dtype."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    abs_err = (got.float() - want.float()).abs().max().item()
    return abs_err, abs_err / max(want.float().abs().max().item(), 1e-30)


def launcher_cases(gen):
    """(launch, shape label, [(output label, got, want)]) for each bf16
    launch of the main path alone, at B=256 and the main path's widths.
    Each launch reads the plain version's inputs."""
    from tokenreduction_tpu_torch.ops import _build
    from tokenreduction_tpu_torch.ops.gather import take_tokens

    bf16, B = torch.bfloat16, BATCH[torch.bfloat16]
    p = block_params(bf16, gen)

    def ln_ref(rows):  # plain LN2 of rows (bf16 or fp32), rounded to bf16
        return layer_norm_f32(rows.float(), p["ls2"], p["lb2"], EPS).to(bf16)

    def ln_case(rows, M, **gather):
        got = torch.empty(M, D, device=DEVICE, dtype=bf16)
        _build.layer_norm(rows, p["ls2"], p["lb2"], got, eps=EPS, **gather)
        return got

    def gemm_case(x, w, b, y_dtype, **kw):
        got = torch.empty(x.shape[0], w.shape[0], device=DEVICE,
                          dtype=y_dtype)
        _build.gemm(x, w, b, got, **kw)
        return got

    for N in FULL_BLOCK_N:
        M, shape = B * N, f"B={B} N={N}"
        x = torch.randn(M, D, generator=gen).to(DEVICE, bf16)
        x32 = torch.randn(M, D, generator=gen).to(DEVICE)
        for label, rows in (("bf16 rows", x), ("fp32 rows", x32)):
            yield f"layer_norm, {label}", shape, [
                ("ln", ln_case(rows, M), ln_ref(rows))]

        ln = ln_ref(x)
        want_qkv = linear_f32(ln, p["wqkv"], p["bqkv"]).to(bf16)
        yield "gemm qkv", shape, [
            ("qkv", gemm_case(ln, p["wqkv"], p["bqkv"], bf16), want_qkv)]

        qkv = want_qkv.view(B, N, 3 * D)
        merged = torch.empty(B, N, D, device=DEVICE, dtype=bf16)
        row0 = torch.empty(B, HEADS, N, device=DEVICE)
        colsum = torch.empty_like(row0)
        _build.short_attention(qkv, merged, HEADS, SCALE, row0=row0,
                               colsum=colsum)
        want = attention_ref(qkv, HEADS, SCALE)
        yield "short_attention", shape, list(zip(
            ("merged heads", "row0", "colsum"), (merged, row0, colsum), want))

        heads = want[0].view(M, D)
        yield "gemm proj, fp32 out", shape, [
            ("y", gemm_case(heads, p["wproj"], p["bproj"], torch.float32),
             linear_f32(heads, p["wproj"], p["bproj"]))]

        h = F.gelu(linear_f32(ln, p["w1"], p["b1"])).to(bf16)
        yield "gemm fc1+GELU", shape, [
            ("hidden", gemm_case(ln, p["w1"], p["b1"], bf16, gelu=True), h)]

        yield "gemm fc2, fp32 out", shape, [
            ("out", gemm_case(h, p["w2"], p["b2"], torch.float32),
             linear_f32(h, p["w2"], p["b2"]))]

    for N, K in MLP_GATHER_NK:
        x = torch.randn(B, N, D, generator=gen).to(DEVICE, bf16)
        idx = torch.stack([torch.randperm(N, generator=gen)[:K]
                           for _ in range(B)]).to(DEVICE, torch.int32)
        got = ln_case(x.view(B * N, D), B * K, idx=idx, rows_out=K,
                      rows_in=N)
        want = ln_ref(take_tokens(x, idx.long()).view(B * K, D))
        yield "layer_norm, gathered rows", f"B={B} N={N} K={K}", [
            ("ln", got, want)]


def phase_launchers():
    """Phase 2, second part: each bf16 launch alone against its plain
    version, relative to the tensor's own max."""
    worst = {}
    for launch, shape, outputs in launcher_cases(
            torch.Generator().manual_seed(4)):
        errs = []
        for label, got, want in outputs:
            abs_err, rel = rel_err(got, want)
            bound = LAUNCH_BOUND[got.dtype]
            require(rel <= bound, f"{launch} bf16 {shape} {label}: error "
                    f"{rel:.3e} of its max|plain| > bound {bound:.0e}")
            errs.append(f"{label} {abs_err:.3e} ({rel:.2e} of max, bound "
                        f"{bound:.0e})")
            key = f"{launch}: {label}"
            worst[key] = max(worst.get(key, 0.0), rel)
        print(f"phase 2 launch {launch} bf16 {shape}: {', '.join(errs)}",
              flush=True)
    for key, rel in worst.items():
        print(f"phase 2 launch worst {key}: {rel:.2e} of its max|plain|",
              flush=True)


def phase_kernels() -> dict:
    """Phase 2. Returns per-kernel records for the JSON line."""
    gen = torch.Generator().manual_seed(0)
    rec = {name: dict(max_abs_err=0.0, max_rel_err_fp32=0.0,
                      max_rel_err_bf16=0.0) for name in WRAPPERS}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for name, shape, kernel, plain in kernel_cases(dtype, gen):
            got, want = as_tuple(kernel()), as_tuple(plain())
            torch.cuda.synchronize()
            errs = []
            for label, g, w in zip(("out", "row0", "colsum"), got, want):
                require(g.shape == w.shape and g.dtype == w.dtype,
                        f"{name} {shape} {label}: {g.shape}/{g.dtype} vs "
                        f"{w.shape}/{w.dtype}")
                abs_err = (g.float() - w.float()).abs().max().item()
                rel = abs_err / max(w.float().abs().max().item(), 1e-30)
                require(rel <= BOUND[dtype],
                        f"{name} {tag} {shape} {label}: error {rel:.3e} of "
                        f"max|plain| > bound {BOUND[dtype]:.0e}")
                errs.append(f"{label} {abs_err:.3e} ({rel:.2e} rel)")
                r = rec[name]
                r[f"max_rel_err_{tag}"] = max(r[f"max_rel_err_{tag}"], rel)
                if label == "out" and dtype == torch.bfloat16:
                    r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            print(f"phase 2 kernel {name} {tag} {shape}: max abs err "
                  f"{', '.join(errs)}; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms", flush=True)
            if dtype == torch.bfloat16 and "shape" not in rec[name]:
                # the widest main-path shape stands for the kernel
                rec[name].update(shape=f"bf16 {shape}", ms=ms,
                                 plain_ms=plain_ms)
    return rec


def images(B, gen, dtype=torch.float32):
    return torch.randn(B, 3, 224, 224, generator=gen).to(DEVICE, dtype)


def phase_models(dtype):
    """Phase 3: the full-width models on the card against the CPU."""
    tag = "fp32" if dtype == torch.float32 else "bf16"
    B, bound = MODEL_BATCH[dtype], MODEL_BOUND[dtype]
    for label, (name, kw) in MODELS.items():
        viz = bool(kw)
        model, cfg = create_model(name, device=DEVICE, viz_mode=viz,
                                  generator=torch.Generator().manual_seed(1),
                                  **kw)
        model = model.to(dtype).eval()
        cpu_model = copy.deepcopy(model).cpu()
        x = images(B, torch.Generator().manual_seed(2), dtype)
        reset_counts()
        with torch.no_grad():
            out = model(x)
        torch.cuda.synchronize()
        got_counts = counts()
        require(got_counts == PER_FORWARD[label],
                f"{label}: launches {got_counts} != {PER_FORWARD[label]}")
        with torch.no_grad():
            ref = cpu_model(x.cpu())
        require(counts() == got_counts, "a CPU forward launched a kernel")
        flips = ""
        if viz:
            (out, v), (ref, v_ref) = out, ref
            n_flip = sum(int((v["Kept_Tokens"][i].cpu() != k).sum())
                         for i, k in v_ref["Kept_Tokens"].items())
            # kept ids that the CPU kept too, in any order
            n_kept = sum(int(torch.isin(a, b).sum())
                         for i, k in v_ref["Kept_Tokens"].items()
                         for a, b in zip(v["Kept_Tokens"][i].cpu(), k))
            n_all = sum(k.numel() for k in v_ref["Kept_Tokens"].values())
            widths = [k.shape[1] + 1 for k in v_ref["Kept_Tokens"].values()]
            flips = (f"; widths 197->{'->'.join(map(str, widths))}; "
                     f"Kept_Tokens flips {n_flip}/{n_all}, same kept set "
                     f"{n_kept}/{n_all} (bound {KEPT_SET[dtype]})")
            require(n_kept >= KEPT_SET[dtype] * n_all,
                    f"{label} {tag}: only {n_kept}/{n_all} kept ids in the "
                    "CPU's kept set")
        out = out.cpu()
        require(out.shape == (B, cfg.num_classes) and
                bool(torch.isfinite(out).all()), f"{label}: bad logits")
        err, rel = rel_err(out, ref)
        top1 = (out.argmax(1) == ref.argmax(1)).float().mean().item()
        if viz and dtype == torch.bfloat16:
            limit = "reported only"
        else:
            limit = f"bound {bound:.0e}"
            require(rel <= bound, f"{label} {tag}: logits error {rel:.3e} "
                    f"of max|CPU| > {bound:.0e}")
        require(top1 >= MODEL_TOP1[dtype], f"{label} {tag}: top-1 agreement "
                f"{top1:.3f} < {MODEL_TOP1[dtype]}")
        print(f"phase 3 model {label} ({name}) {tag} B={B}: logits max abs "
              f"err {err:.3e} ({rel:.2e} of max|CPU|, {limit}); "
              f"top-1 agreement {top1:.3f} (bound {MODEL_TOP1[dtype]}); "
              f"launches {got_counts}{flips}", flush=True)


def phase_serve(card: str) -> dict:
    """Phase 4: serve SERVE_BATCHES batches of SERVE_B bf16 images per
    model; the launch counts of this run go into the JSON record."""
    reset_counts()
    expected = dict.fromkeys(WRAPPERS, 0)
    for label, (name, kw) in MODELS.items():
        model, _ = create_model(name, device=DEVICE,
                                generator=torch.Generator().manual_seed(1),
                                **kw)
        model = model.to(torch.bfloat16).eval()
        xs = images(SERVE_BATCHES * SERVE_B,
                    torch.Generator().manual_seed(3), torch.bfloat16) \
            .view(SERVE_BATCHES, SERVE_B, 3, 224, 224)
        seconds = []
        with torch.no_grad():
            for x in xs:
                t0 = time.perf_counter()
                out = model(x)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                require(out.shape == (SERVE_B, 1000) and
                        bool(torch.isfinite(out).all()),
                        f"{label}: non-finite or misshapen bf16 logits")
        for k, n in PER_FORWARD[label].items():
            expected[k] += n * SERVE_BATCHES
        ips = SERVE_B * (SERVE_BATCHES - 1) / sum(seconds[1:])
        print(f"phase 4 serve {label} bf16 b{SERVE_B}: {ips:.1f} img/s over "
              f"batches 2-{SERVE_BATCHES} (first batch "
              f"{seconds[0] * 1e3:.1f} ms) on {card}", flush=True)
        del model, xs
    got = counts()
    require(got == expected, f"serve launches {got} != {expected}")
    require(all(got.values()), f"a kernel of the path never ran: {got}")
    return got


def main():
    # phase 0
    root = pathlib.Path(__file__).resolve().parent
    package = pathlib.Path(tokenreduction_tpu_torch.__file__).resolve()
    require(package.parents[1] == root,
            f"the port imported from {package}, not from the checkout {root}")
    require(torch.cuda.is_available(),
            "no CUDA device: chip_smoke.py runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()})"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 0 device: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; TF32 off", flush=True)

    # phase 1
    from tokenreduction_tpu_torch.ops import _build

    kern = _build.kernels()
    print(f"phase 1 build: {kern.path} in {kern.build_seconds:.1f} s "
          f"(0 = already built)", flush=True)
    for line in kern.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"phase 1 ptxas: {line.strip()}")

    rec = phase_kernels()
    phase_launchers()
    for dtype in (torch.float32, torch.bfloat16):
        phase_models(dtype)
    launches = phase_serve(card)

    kernels = [dict(name=name, route="cuda", source=CUDA_SOURCES[name][0],
                    cuda_sources=CUDA_SOURCES[name],
                    wrapper=WRAPPER_SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    **rec[name]) for name in WRAPPERS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
