"""Time the PyTorch port in two checkouts, in turns, on one card.

    python3 tools/port_ab.py PARENT_DIR CHANGE_DIR [--pairs 3]
    python3 tools/port_ab.py --once DIR

Each checkout runs in its own process, with its own kernel build, in the
order parent, change, change, parent, repeated ``--pairs`` times. The
child takes its timer (``cuda_ms``, CUDA events) and its seeded DeiT-S
block weights (``block_params``) from that checkout's ``chip_smoke.py``.
Each run prints the times, in ms, of one full block (``fused_full_block``,
bf16, B=256, N=197, median of 50), of the qkv GEMM alone at the same rows
(median of 50), and of a dense DeiT-S bf16 b256 forward (median of 10), of
the topk@0.7, dense and ToMe@0.7 train steps (``train_run``: bench.py's
recipe at b256, the median of steps 3-6 on the host clock), and, per
launch, of ten back-to-back launches between one pair of events (median
of 20), so that the host's launch cost is hidden: the qkv GEMM, the fc1
GEMM with GELU, the attention and the LayerNorm at the same shapes, and
the attention backward (the training branch's, with the row0 cotangent,
and ToMe's, with the bias, both cotangents and dbias, over [B, H, N, hd]
views), and every other variant of the attention the main path launches
(``attention_times``: the eval forward with row0 and colsum, with ToMe's
bias, with a mask, and the training branch's normalised-P forward, with
its row statistics where the checkout writes them), beside SDPA on the
same q, k, v (the output alone; with the bias or the pair mask as a float
mask; its backward alone through autograd where the checkout's
``chip_smoke.py`` has ``sdpa_backward``). A checkout whose attention
backward reads the forward's output and statistics gets them from one
forward launch first. Both also time the heuristic train step, and a
topk@0.7 bf16 b256 forward (median of 10); a
checkout whose attention takes a validity mask also times, per launch as
above, the masked attention, and an ATS@0.7 forward; one whose backward takes the
mask also times the masked backward (heuristic's block-3 mask, no
by-product cotangents, as its train step runs it) per launch, and the
heuristic and DyViT@0.7 forwards. Both also time, per launch as above,
every bf16 GEMM of a DeiT-S block at B=256, N=197 (``gemm_times``: the
forward's qkv, proj and fc2 with their residuals and fc1 with GELU, with
and without GELU'; the backward's four dY . W products, fp32 out where
the LayerNorm backward reads them, fc2's with the GELU' factor and the
column sums; the four weight gradients with their bias sums) and a ToMe@0.7
forward. They also time, per launch as above, the rectangular attention
at each of ATS's (M, N) pairs with the checkout's kept rows and mask
(``rect_times``, beside the kept query rows gathered, then SDPA), the
LayerNorm backward at B=256 and N = 197, 138, 97, 68 (``ln_bwd_times``,
beside ``aten.native_layer_norm_backward``), and the other hand-written
kernels (``standalone_times``: ``layer_norm`` of bf16, fp32 and gathered
rows beside ``F.layer_norm``; ``sum_partials`` at every shape that one
LayerNorm backward and the block's weight gradients give it in that
checkout, beside ``part.sum(0)``; ``head_mean_keys`` beside the head mean
of the packed keys). They also time ``head_mean_keys`` at ToMe@0.7's
widths (B=256) and at B=32, N=197 (``keys_times``), and each training
branch backward's partial sums at B=256, N = 197 and 68
(``branch_sum_times``: the pairs recorded from one backward in that
checkout, timed as the checkout launches them, one launch a pair and one
``part.sum(0)`` a pair), each per call by events and by
``torch.profiler``'s device time (``device_ms``). These kernels and their
library calls (``standalone_times`` too) run over copies of their inputs
(``cold``) that cycle through more than twice the card's L2, so that each
call reads from HBM, as the bytes of its bound. Then the host time of
each branch backward (``_bwd_cuda``: median of 30 calls, the queue
drained before each, no synchronisation inside). Each run also prints the
ptxas registers of the attention kernels' variants
(``attention_registers``, from its checkout's build log), of the
LayerNorm backward's, the sums' and the head-mean keys'. Both also time
validate's default precision and the DyViT teacher's (``fp32_times``):
per launch as above the fp32 GEMM (qkv, proj and fc2 with their
residuals, fc1 with GELU) and the fp32 attention (without and with row0
and colsum) at B=256, N=197, the fp32 full block (median of 20), the fp32
dense and topk@0.7 b256 forwards (median of 5), and the DyViT@0.7
distilled train step with its fp32 teacher's forward (``distill_ms``:
the median of steps 3-6, the teacher's mean by CUDA events). And the
fp32 training backward's kernels (``fp32_bwd_times``), per launch as
above at B=256 and B=32, N=197: the attention backward without options,
with the row0 cotangent, with the bias, both cotangents and dbias, and
with heuristic's block-3 mask without and with both cotangents, beside
SDPA's fp32 backward; the rectangular attention at ATS@0.7's pairs
(138x197 also at B=32) beside the kept query rows gathered, then SDPA;
the eight GEMM layouts of a block's backward (dY . W, weight gradients)
beside cuBLAS SGEMM; and the fp32 topk@0.7 train step (no amp, median of
steps 3-6) and the ATS@0.7 fp32 forward (median of 5) at b256.
``--once DIR`` runs the child once in one checkout and prints its line.
``--attention`` times, per launch as above, the bf16 attention forwards
and backwards alone (``attention_x10``, ``attention_times``,
``rect_times``, ``bwd_times``): the kernels of
``csrc/attention_sm90.cu``, in minutes rather than the full run's.
``--tools`` times, per launch as above, the kernel tools'
``tune_kernels.attn_joint`` (with row0 and colsum) and
``tune_kernels.mlp_chunked`` beside their routes
(``current_attention``, ``current_mlp``) at ``chip_smoke.TOOLS_N``, B=256,
with ``chip_smoke.tool_weights``, and every arrangement of
``proto_attn.proto_attn`` and ``proto_attn_bwd.proto_attn_bwd`` beside
their routes (``current_route``) at their tools' widths, B=256, with
``chip_smoke.proto_weights``.
The first line is the card's name and power limit (nvidia-smi); the last
lines give each checkout's medians over its runs. Needs one CUDA card;
numbers from separate calls are not compared.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

_CHILD = r"""
import functools, inspect, itertools, json, os, re, statistics, time, torch
from chip_smoke import D, H4, HEADS, SCALE, block_params, cuda_ms, train_run
from tokenreduction_tpu_torch import create_model
from tokenreduction_tpu_torch.ops import _build
from tokenreduction_tpu_torch.ops.fused_full_block import fused_full_block

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.kernels()
B, N = 256, 197
bf16 = torch.bfloat16
g = torch.Generator().manual_seed(0)
p = block_params(bf16, g)
x = torch.randn(B, N, D, generator=g).to("cuda", bf16)
ln = torch.randn(B * N, D, generator=g).to("cuda", bf16)
qkv = torch.empty(B, N, 3 * D, device="cuda", dtype=bf16)
hidden = torch.empty(B * N, H4, device="cuda", dtype=bf16)
merged = torch.empty(B, N, D, device="cuda", dtype=bf16)
ln_out = torch.empty_like(ln)

def ten(fn):
    def run():
        for _ in range(10):
            fn()
    return cuda_ms(run, 20) / 10

def cold(make, nbytes):
    # make()'s calls in turn, each on its own copies of the inputs: so
    # many that the calls between two uses of one copy touch twice the
    # card's L2, and a timed call reads its nbytes from HBM, not from the
    # L2 that its previous call filled (at most 256 copies)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    copies = min(256, 1 + -(-2 * l2 // max(1, nbytes)))
    calls = itertools.cycle([make() for _ in range(copies)])
    return lambda: next(calls)()

def summed(pairs):
    # gemm_wgrad and layer_norm_bwd return the pairs of their partial sums
    # for the caller's sum_partials_many launch; in a checkout without it
    # (5c803b4) they launch their sums themselves and return None
    if pairs:
        _build.sum_partials_many(pairs)

model, _ = create_model("deit_small_patch16_224_local", device="cuda",
                        generator=torch.Generator().manual_seed(1))
model = model.to(bf16).eval()
images = torch.randn(B, 3, 224, 224, generator=g).to("cuda", bf16)
qkv_gemm = lambda: _build.gemm(ln, p["wqkv"], p["bqkv"], qkv.view(B * N, -1))
def forward_ms(name):
    m, _ = create_model(name, device="cuda", reduction_loc=(3, 6, 9),
                        keep_rate=(0.7,),
                        generator=torch.Generator().manual_seed(1))
    m = m.to(bf16).eval()
    return cuda_ms(lambda: m(images), 10)

def ats_times():
    # ATS's kernels and model, in a checkout that has them
    if "mask" not in inspect.signature(_build.short_attention).parameters:
        return {}
    mask = (torch.rand(B, N, generator=g) > 0.2).to("cuda")
    return dict(
        attention_mask_x10=ten(lambda: _build.short_attention(
            qkv, merged, HEADS, SCALE, mask=mask)),
        ats_forward=forward_ms("ats_small_patch16_224"))

def rect_times():
    # the rectangular attention per launch at ATS's (M, N), with the
    # checkout's kept rows (CLS pads, a dead slot) and token mask, beside
    # the kept query rows gathered, then SDPA
    from chip_smoke import RECT_MN, kept_ids, library_rect, token_mask
    out = {}
    for M, Nk in RECT_MN:
        qkv_r = torch.randn(B, Nk, 3 * D, generator=g).to("cuda", bf16)
        mask = token_mask(B, Nk, g)
        idx = kept_ids(B, Nk, M, mask, g)
        ids = idx.to(torch.int32)
        o = torch.empty(B, M, D, device="cuda", dtype=bf16)
        out[f"rect_{M}x{Nk}_x10"] = ten(lambda: _build.short_attention(
            qkv_r, o, HEADS, SCALE, mask=mask, ids=ids))
        out[f"rect_{M}x{Nk}_sdpa_x10"] = ten(
            lambda: library_rect(qkv_r, idx, mask))
    return out

def ln_bwd_times():
    # the LayerNorm backward per launch at B=256 and the training widths,
    # beside aten.native_layer_norm_backward (dLN cast to bf16 once, the
    # forward's mean and rstd from aten.native_layer_norm)
    out = {}
    for Nl in (197, 138, 97, 68):
        M = B * Nl
        xl = torch.randn(M, D, generator=g).to("cuda", bf16)
        dln = torch.randn(M, D, generator=g).to("cuda")
        dx = torch.empty_like(xl)
        dwb = torch.empty(2, D, device="cuda", dtype=bf16)
        _, mean, rstd = torch.ops.aten.native_layer_norm(
            xl, [D], p["ls1"], p["lb1"], 1e-6)
        dy = dln.to(bf16)
        out[f"ln_bwd_{Nl}_x10"] = ten(lambda: summed(_build.layer_norm_bwd(
            xl, p["ls1"], dln, dx, dwb, eps=1e-6)))
        out[f"ln_bwd_{Nl}_aten_x10"] = ten(
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, xl, [D], mean, rstd, p["ls1"], p["lb1"],
                [True, True, True]))
    return out

def standalone_times():
    # the other hand-written kernels per launch, over cold copies of their
    # inputs: layer_norm of bf16, fp32 and gathered rows (F.layer_norm
    # beside the bf16 rows), sum_partials at every [S, L] that one
    # layer_norm_bwd and the block's four gemm_wgrad calls give it in this
    # checkout, beside part.sum(0), and head_mean_keys beside the head
    # mean of the packed keys
    import torch.nn.functional as F
    out, shapes = {}, []
    K = 138
    idx = torch.stack([torch.randperm(N, generator=g)[:K]
                       for _ in range(B)]).to("cuda", torch.int32)

    def layer_norm(x, rows=B * N, **kw):
        return cold(lambda: functools.partial(
            _build.layer_norm, x.clone(), p["ls1"], p["lb1"], torch.empty(
                rows, D, device="cuda", dtype=bf16), eps=1e-6, **kw),
            rows * D * (x.element_size() + 2))

    out["layer_norm_bf16_x10"] = ten(layer_norm(ln))
    out["layer_norm_bf16_F_x10"] = ten(cold(lambda: functools.partial(
        F.layer_norm, ln.clone(), (D,), p["ls1"], p["lb1"], 1e-6),
        B * N * D * 4))
    out["layer_norm_fp32_x10"] = ten(layer_norm(ln.float()))
    out["layer_norm_gathered_x10"] = ten(layer_norm(
        ln, B * K, idx=idx, rows_out=K, rows_in=N))
    real = _build.sum_partials
    if not hasattr(_build, "sum_partials_many"):
        # 5c803b4 only: there the launchers sum their partials themselves,
        # one sum_partials launch a sum
        def record(part, o):
            shapes.append(tuple(part.shape))
            real(part, o)
        record.launches = 0  # the checkout's launcher may count on its name
        _build.sum_partials = record
    try:
        dln = torch.randn(B * N, D, generator=g).to("cuda")
        rets = [_build.layer_norm_bwd(
            ln, p["ls1"], dln, torch.empty_like(ln),
            torch.empty(2, D, device="cuda", dtype=bf16), eps=1e-6)]
        for n_out, k_in in ((3 * D, D), (D, D), (H4, D), (D, H4)):
            dyw = torch.randn(B * N, n_out, generator=g).to("cuda", bf16)
            xw = torch.randn(B * N, k_in, generator=g).to("cuda", bf16)
            rets.append(_build.gemm_wgrad(
                dyw, xw, torch.empty(n_out, k_in, device="cuda", dtype=bf16),
                torch.empty(n_out, device="cuda", dtype=bf16)))
    finally:
        _build.sum_partials = real
    for ret in rets:  # the pairs, where the launchers return them
        shapes.extend(tuple(part.shape) for part, _ in ret or ())
    for S, L in dict.fromkeys(shapes):
        part = torch.randn(S, L, generator=g).to("cuda")
        nbytes = S * L * 4 + L * 2
        out[f"sum_partials_{S}x{L}_x10"] = ten(cold(
            lambda: functools.partial(real, part.clone(), torch.empty(
                L, device="cuda", dtype=bf16)), nbytes))
        out[f"sum_partials_{S}x{L}_sum_x10"] = ten(cold(
            lambda: functools.partial(torch.sum, part.clone(), 0), nbytes))
    nbytes = B * N * (D + D // HEADS) * 2
    keys = torch.empty(B, N, D // HEADS, device="cuda", dtype=bf16)
    out["head_mean_keys_x10"] = ten(cold(lambda: functools.partial(
        _build.head_mean_keys, qkv.clone(), torch.empty_like(keys), HEADS),
        nbytes))
    out["head_mean_keys_mean_x10"] = ten(cold(lambda: functools.partial(
        mean_keys, qkv.clone()), nbytes))
    return out

def mean_keys(q):
    # the head mean of the packed keys in one PyTorch call
    Bq, Nq, _ = q.shape
    return q[..., D:2 * D].view(Bq, Nq, HEADS, D // HEADS).mean(2)

def device_ms(fn, calls=10):
    # the card's time per call of fn: torch.profiler's device time of the
    # kernels of ten back-to-back calls, over ten (None when the profiler
    # saw no device events)
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / calls / 1e3 if us > 0 else None

def keys_times():
    # head_mean_keys per launch (events and device time, over cold copies
    # of qkv) at ToMe@0.7's widths, B=256, and at B=32, N=197, beside the
    # head mean of the packed keys
    out = {}
    for Bk, Nk in ((256, 197), (256, 138), (256, 97), (256, 68), (32, 197)):
        qkv_k = torch.randn(Bk, Nk, 3 * D, generator=g).to("cuda", bf16)
        nbytes = Bk * Nk * (D + D // HEADS) * 2
        run = cold(lambda: functools.partial(
            _build.head_mean_keys, qkv_k.clone(), torch.empty(
                Bk, Nk, D // HEADS, device="cuda", dtype=bf16), HEADS),
            nbytes)
        mean = cold(lambda: functools.partial(mean_keys, qkv_k.clone()),
                    nbytes)
        tag = f"keys_{Bk}x{Nk}"
        out.update({f"{tag}_x10": ten(run), f"{tag}_dev": device_ms(run),
                    f"{tag}_mean_x10": ten(mean),
                    f"{tag}_mean_dev": device_ms(mean)})
    return out

def branch_inputs(Nb):
    from tokenreduction_tpu_torch.ops import fused_block_train as fbt
    from tokenreduction_tpu_torch.ops import fused_mlp_train as fmt
    xb, dyb = (torch.randn(B, Nb, D, generator=g).to("cuda", bf16)
               for _ in range(2))
    drow0 = torch.randn(B, HEADS, Nb, generator=g).to("cuda")
    attn = ("ls1", "lb1", "wqkv", "bqkv", "wproj", "bproj")
    mlp = ("ls2", "lb2", "w1", "b1", "w2", "b2")
    saved_a = fbt._fwd_cuda(xb, *(p[k] for k in attn), HEADS, SCALE, 1e-6)[2]
    saved_m = fmt._fwd_cuda(xb, *(p[k] for k in mlp), 1e-6)[1]
    return dict(
        attention=lambda: fbt._bwd_cuda(xb, p["ls1"], p["wqkv"], p["wproj"],
                                        saved_a, dyb, drow0, HEADS, SCALE,
                                        1e-6),
        mlp=lambda: fmt._bwd_cuda(xb, p["ls2"], p["w1"], p["w2"], saved_m,
                                  dyb, 1e-6))

def branch_sum_times():
    # each branch backward's partial sums at B=256 and N = 197 and 68, the
    # pairs recorded from one backward in this checkout: as the checkout
    # launches them (one batched launch, or one launch a pair), as one
    # launch a pair, and as one part.sum(0) a pair; events and device
    # time, over cold copies of the pairs. Then the host time of each branch backward (median of 30, the
    # queue drained before each, no synchronisation inside)
    import time
    out = {}
    real_sum = _build.sum_partials
    # None only in 5c803b4, whose branches launch one sum_partials a sum
    batched = getattr(_build, "sum_partials_many", None)
    name = "sum_partials" if batched is None else "sum_partials_many"
    for Nb in (197, 68):
        for branch, bwd in branch_inputs(Nb).items():
            pairs = []
            setattr(_build, name, pairs.extend if batched else
                    lambda part, o: pairs.append((part, o)))
            try:
                bwd()
            finally:
                setattr(_build, name, batched or real_sum)
            nbytes = sum(part.numel() * 4 + o.numel() * o.element_size()
                         for part, o in pairs)

            def timed(fn, pairs=pairs, nbytes=nbytes):
                return cold(lambda: functools.partial(fn, [
                    (part.clone(), torch.empty_like(o))
                    for part, o in pairs]), nbytes)

            singles = timed(lambda ps: [real_sum(*pair) for pair in ps])
            launch = timed(batched) if batched else singles
            calls = timed(lambda ps: [part.sum(0) for part, _ in ps])
            tag = f"sums_{branch}_{Nb}"
            out.update({
                f"{tag}_jobs": len(pairs),
                f"{tag}_x10": ten(launch), f"{tag}_dev": device_ms(launch),
                f"{tag}_single_x10": ten(singles),
                f"{tag}_single_dev": device_ms(singles),
                f"{tag}_sum_x10": ten(calls),
                f"{tag}_sum_dev": device_ms(calls)})
            host = []
            for _ in range(33):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bwd()
                host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            out[f"bwd_host_{branch}_{Nb}"] = 1e3 * statistics.median(host[3:])
    return out

# whether the checkout's attention backward reads the forward's output,
# row0 and row statistics (the sm_90a kernels)
RESIDUALS = "stats" in inspect.signature(
    _build.short_attention_bwd_heads).parameters

def attention_times():
    # every forward variant the main path launches, per launch, and SDPA
    # (the output alone) on the same q, k, v views
    import torch.nn.functional as F
    from chip_smoke import float_mask
    from tokenreduction_tpu_torch.ops.flash_attention import packed_heads
    row0 = torch.empty(B, HEADS, N, device="cuda")
    colsum = torch.empty_like(row0)
    bias = torch.log(torch.randint(1, 5, (B, N), generator=g).float()) \
        .to("cuda")
    mask = (torch.rand(B, N, generator=g) > 0.2).to("cuda")
    train = dict(row0=row0, norm_p=True)
    if RESIDUALS:
        train["stats"] = torch.empty(B, HEADS, N, 2, device="cuda")
    q, k, v = packed_heads(qkv, HEADS)
    sdpa = lambda m=None: ten(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m, scale=SCALE))
    return dict(
        attention_scores_x10=ten(lambda: _build.short_attention(
            qkv, merged, HEADS, SCALE, row0=row0, colsum=colsum)),
        attention_bias_x10=ten(lambda: _build.short_attention(
            qkv, merged, HEADS, SCALE, bias=bias, row0=row0, colsum=colsum)),
        attention_mask_scores_x10=ten(lambda: _build.short_attention(
            qkv, merged, HEADS, SCALE, mask=mask, row0=row0, colsum=colsum)),
        attention_normp_x10=ten(lambda: _build.short_attention(
            qkv, merged, HEADS, SCALE, **train)),
        sdpa_x10=sdpa(), sdpa_bias_x10=sdpa(float_mask(bf16, bias)),
        sdpa_mask_x10=sdpa(float_mask(bf16, None, mask, mask)))

def bwd_call(q, k, v, dout, grads, **kw):
    # one backward launch; where the backward reads the forward's
    # residuals, they come from one forward launch first
    if not RESIDUALS:
        return lambda: _build.short_attention_bwd_heads(
            q, k, v, dout, *grads, SCALE, **kw)
    hd = D // HEADS
    out = torch.empty(B, N, HEADS, hd, device="cuda",
                      dtype=bf16).transpose(1, 2)
    row0 = torch.empty(B, HEADS, N, device="cuda")
    stats = torch.empty(B, HEADS, N, 2, device="cuda")
    _build.short_attention_heads(q, k, v, out, SCALE, bias=kw.get("bias"),
                                 mask=kw.get("mask"), row0=row0, stats=stats)
    return lambda: _build.short_attention_bwd_heads(
        q, k, v, out, dout, *grads, SCALE, stats=stats, row0=row0, **kw)

def bwd_times():
    # the attention backward per launch; with the mask where the checkout
    # has it; SDPA's backward alone (autograd) on the same q, k, v
    hd = D // HEADS
    q, k, v = (t.contiguous() for t in
               torch.randn(3, B, HEADS, N, hd, generator=g).to("cuda", bf16))
    dout = torch.randn(B, HEADS, N, hd, generator=g).to("cuda", bf16)
    drow0, dcs, bias = (torch.randn(B, HEADS, N, generator=g).to("cuda")
                        for _ in range(3))
    bias = bias[:, 0].contiguous()
    grads = torch.empty(3, B, HEADS, N, hd, device="cuda",
                        dtype=bf16).unbind(0)
    dbias = torch.empty(B, HEADS, N, device="cuda")
    out = dict(
        attention_bwd_x10=ten(bwd_call(q, k, v, dout, grads, drow0=drow0)),
        attention_bwd_bias_x10=ten(bwd_call(
            q, k, v, dout, grads, bias=bias, drow0=drow0, dcs=dcs,
            dbias=dbias)))
    if RESIDUALS:  # a checkout whose chip_smoke.py has the SDPA backward
        from chip_smoke import sdpa_backward
        out["sdpa_bwd_x10"] = ten(sdpa_backward(q, k, v, dout))
    if "mask" in inspect.signature(
            _build.short_attention_bwd_heads).parameters:
        from chip_smoke import batch_mask, heuristic_block_masks
        mask = batch_mask(heuristic_block_masks()[3], B)
        out.update(
            attention_bwd_mask_x10=ten(bwd_call(q, k, v, dout, grads,
                                                mask=mask)),
            heuristic_forward=forward_ms("heuristic_small_patch16_224"),
            dyvit_forward=forward_ms("dyvit_small_patch16_224"))
    return out

def attention_registers():
    # "Used N registers" of each attention and LayerNorm backward kernel
    # variant, by the kernel's mangled name, from this checkout's build log
    log = (_build.kernels().path.parent / "build.log").read_text()
    regs, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and any(k in name for k in (
                "attention", "layer_norm_bwd", "sum_partials",
                "head_mean_keys")) and (
                    used := re.search(r"Used (\d+) registers", line)):
            regs[name[-70:]] = int(used[1])
    return regs

def gemm_times():
    # each GEMM of the block per launch (both checkouts take these calls)
    f32 = torch.float32
    M = B * N
    heads, h, dy, dq, dh, res = (
        torch.randn(M, n, generator=g).to("cuda", bf16)
        for n in (D, H4, D, 3 * D, H4, D))
    gp = torch.randn(M, H4, generator=g).to("cuda")
    parts = torch.empty(-(-M // 128), H4, device="cuda")
    y_d, y_h = (torch.empty(M, n, device="cuda", dtype=bf16) for n in (D, H4))
    y_d32, gp_out = (torch.empty(M, n, device="cuda") for n in (D, H4))
    dw = {k: torch.empty_like(p[k]) for k in ("wqkv", "wproj", "w1", "w2",
                                              "bqkv", "bproj", "b2")}
    gemm = _build.gemm
    wgrad = lambda *a: summed(_build.gemm_wgrad(*a))
    return dict(
        gemm_proj_res_x10=ten(lambda: gemm(heads, p["wproj"], p["bproj"],
                                           y_d, res=res)),
        gemm_fc1_gelu_grad_x10=ten(lambda: gemm(
            ln, p["w1"], p["b1"], y_h, gelu=True, gelu_grad=gp_out)),
        gemm_fc2_res_x10=ten(lambda: gemm(h, p["w2"], p["b2"], y_d,
                                          res=res)),
        gemm_dyw_qkv_x10=ten(lambda: gemm(dq, p["wqkv"], None, y_d32,
                                          w_kn=True)),
        gemm_dyw_proj_x10=ten(lambda: gemm(dy, p["wproj"], None, y_d,
                                           w_kn=True)),
        gemm_dyw_fc2_x10=ten(lambda: gemm(dy, p["w2"], None, y_h, w_kn=True,
                                          mul=gp, col_sums=parts)),
        gemm_dyw_fc1_x10=ten(lambda: gemm(dh, p["w1"], None, y_d32,
                                          w_kn=True)),
        wgrad_qkv_x10=ten(lambda: wgrad(dq, ln, dw["wqkv"], dw["bqkv"])),
        wgrad_proj_x10=ten(lambda: wgrad(dy, heads, dw["wproj"],
                                         dw["bproj"])),
        wgrad_fc1_x10=ten(lambda: wgrad(dh, ln, dw["w1"])),
        wgrad_fc2_x10=ten(lambda: wgrad(dy, h, dw["w2"], dw["b2"])),
        tome_forward=forward_ms("tome_small_patch16_224"))

def train_ms(label):
    return 1e3 * statistics.median(train_run(label, 6)[0][2:])

def fp32_times():
    # validate's default precision and the DyViT teacher's: the fp32 GEMM
    # and attention per launch at B=256, N=197, the fp32 full block, the
    # fp32 dense and topk@0.7 forwards at b256, and the DyViT@0.7 distilled
    # step with its fp32 teacher's forward (CUDA events)
    f32 = torch.float32
    M = B * N
    q32 = block_params(f32, g)
    ln32, h32, res32 = (torch.randn(M, n, generator=g).to("cuda")
                        for n in (D, H4, D))
    y3, yd, yh = (torch.empty(M, n, device="cuda") for n in (3 * D, D, H4))
    qkv32 = torch.randn(B, N, 3 * D, generator=g).to("cuda")
    merged32 = torch.empty(B, N, D, device="cuda")
    row0 = torch.empty(B, HEADS, N, device="cuda")
    colsum = torch.empty_like(row0)
    x32 = torch.randn(B, N, D, generator=g).to("cuda")
    images32 = torch.randn(B, 3, 224, 224, generator=g).to("cuda")
    gemm = _build.gemm
    out = dict(
        fp32_gemm_qkv_x10=ten(lambda: gemm(ln32, q32["wqkv"], q32["bqkv"],
                                           y3)),
        fp32_gemm_proj_res_x10=ten(lambda: gemm(
            ln32, q32["wproj"], q32["bproj"], yd, res=res32)),
        fp32_gemm_fc1_gelu_x10=ten(lambda: gemm(ln32, q32["w1"], q32["b1"],
                                                yh, gelu=True)),
        fp32_gemm_fc2_res_x10=ten(lambda: gemm(h32, q32["w2"], q32["b2"], yd,
                                               res=res32)),
        fp32_attention_x10=ten(lambda: _build.short_attention(
            qkv32, merged32, HEADS, SCALE)),
        fp32_attention_row0_colsum_x10=ten(lambda: _build.short_attention(
            qkv32, merged32, HEADS, SCALE, row0=row0, colsum=colsum)),
        fp32_full_block=cuda_ms(lambda: fused_full_block(
            x32, *q32.values(), HEADS, SCALE), 20))
    for label, name, kw in (
            ("dense", "deit_small_patch16_224_local", {}),
            ("topk", "topk_small_patch16_224",
             dict(reduction_loc=(3, 6, 9), keep_rate=(0.7,)))):
        m, _ = create_model(name, device="cuda",
                            generator=torch.Generator().manual_seed(1), **kw)
        m = m.eval()
        out[f"fp32_{label}_forward"] = cuda_ms(lambda: m(images32), 5)
        del m
    return out

def fp32_bwd_times():
    # the fp32 training backward's kernels and the fp32 rectangular
    # attention per launch: the attention backward at B=256 and B=32,
    # N=197 (no option; the branch's row0 cotangent; ToMe's core: bias,
    # both cotangents, dbias; heuristic's block-3 mask without and with
    # both cotangents) beside SDPA's fp32 backward alone; the rectangular
    # attention at ATS@0.7's pairs (B=256) and 138x197 at B=32 beside the
    # kept query rows gathered, then SDPA; the backward's GEMM layouts
    # (dY . W with W untransposed, fc2's with the GELU' factor and the
    # column sums; the weight gradients with their bias sums and the
    # partial sums' launch) beside cuBLAS SGEMM (matmul, matmul(dy.t(),
    # x)); last the fp32 topk@0.7 train step (no amp) and the ATS@0.7 fp32
    # forward at b256
    from chip_smoke import (RECT_MN, batch_mask, float_mask,
                            heuristic_block_masks, kept_ids,
                            label_smoothing_loss, library_rect,
                            sdpa_backward, token_mask)
    from tokenreduction_tpu_torch.train.optim import (OptimConfig,
                                                      create_optimizer)
    from tokenreduction_tpu_torch.train.step import (StepConfig,
                                                     init_train_state,
                                                     make_train_step)
    f32 = torch.float32
    hd = D // HEADS
    out = {}
    for Bb in (256, 32):
        q, k, v, dout = (t.contiguous() for t in torch.randn(
            4, Bb, HEADS, N, hd, generator=g).to("cuda"))
        drow0, dcs, bias = (torch.randn(Bb, HEADS, N, generator=g).to("cuda")
                            for _ in range(3))
        bias = bias[:, 0].contiguous()
        mask = batch_mask(heuristic_block_masks()[3], Bb)
        grads = torch.empty(3, Bb, HEADS, N, hd, device="cuda").unbind(0)
        dbias = torch.empty(Bb, HEADS, N, device="cuda")
        for name, kw, lib in (
                ("plain", {}, None),
                ("row0", dict(drow0=drow0), None),
                ("bias", dict(bias=bias, drow0=drow0, dcs=dcs, dbias=dbias),
                 float_mask(f32, bias)),
                ("mask", dict(mask=mask), float_mask(f32, None, mask, mask)),
                ("mask_cotangents", dict(mask=mask, drow0=drow0, dcs=dcs),
                 None)):
            out[f"fp32_bwd_{name}_b{Bb}_x10"] = ten(
                lambda kw=kw: _build.short_attention_bwd_heads(
                    q, k, v, None, dout, *grads, SCALE, **kw))
            if name in ("plain", "bias", "mask"):
                out[f"fp32_sdpa_bwd_{name}_b{Bb}_x10"] = ten(
                    sdpa_backward(q, k, v, dout, lib))
        del q, k, v, dout, grads
    for Bb, M, Nk in ((256, *RECT_MN[0]), (256, *RECT_MN[1]),
                      (256, *RECT_MN[2]), (32, *RECT_MN[0])):
        qkv_r = torch.randn(Bb, Nk, 3 * D, generator=g).to("cuda")
        mask = token_mask(Bb, Nk, g)
        idx = kept_ids(Bb, Nk, M, mask, g)
        ids = idx.to(torch.int32)
        o = torch.empty(Bb, M, D, device="cuda")
        tag = f"fp32_rect_{M}x{Nk}_b{Bb}"
        out[f"{tag}_x10"] = ten(lambda: _build.short_attention(
            qkv_r, o, HEADS, SCALE, mask=mask, ids=ids))
        out[f"{tag}_sdpa_x10"] = ten(lambda: library_rect(qkv_r, idx, mask))
    q32 = block_params(f32, g)
    for Bb in (256, 32):
        M = Bb * N
        dq, dy, dh, xin, xh = (torch.randn(M, n, generator=g).to("cuda")
                               for n in (3 * D, D, H4, D, H4))
        gp = torch.randn(M, H4, generator=g).to("cuda")
        parts = torch.empty(-(-M // 128), H4, device="cuda")
        yd, yh = (torch.empty(M, n, device="cuda") for n in (D, H4))
        dw = {k: torch.empty_like(q32[k]) for k in (
            "wqkv", "wproj", "w1", "w2", "bqkv", "bproj", "b2")}
        wgrad = lambda *a: summed(_build.gemm_wgrad(*a))
        for name, run, lib in (
                ("dyw_qkv", lambda: _build.gemm(dq, q32["wqkv"], None, yd,
                                                w_kn=True),
                 lambda: dq @ q32["wqkv"]),
                ("dyw_proj", lambda: _build.gemm(dy, q32["wproj"], None, yd,
                                                 w_kn=True),
                 lambda: dy @ q32["wproj"]),
                ("dyw_fc2", lambda: _build.gemm(dy, q32["w2"], None, yh,
                                                w_kn=True, mul=gp,
                                                col_sums=parts),
                 lambda: dy @ q32["w2"]),
                ("dyw_fc1", lambda: _build.gemm(dh, q32["w1"], None, yd,
                                                w_kn=True),
                 lambda: dh @ q32["w1"]),
                ("wgrad_qkv", lambda: wgrad(dq, xin, dw["wqkv"], dw["bqkv"]),
                 lambda: dq.t() @ xin),
                ("wgrad_proj", lambda: wgrad(dy, xin, dw["wproj"],
                                             dw["bproj"]),
                 lambda: dy.t() @ xin),
                ("wgrad_fc1", lambda: wgrad(dh, xin, dw["w1"]),
                 lambda: dh.t() @ xin),
                ("wgrad_fc2", lambda: wgrad(dy, xh, dw["w2"], dw["b2"]),
                 lambda: dy.t() @ xh)):
            out[f"fp32_gemm_{name}_b{Bb}_x10"] = ten(run)
            out[f"fp32_gemm_{name}_b{Bb}_cublas_x10"] = ten(lib)
        del dq, dy, dh, xin, xh, gp, yd, yh
    # the JAX CLI's default precision: an fp32 train step (bench.py's
    # recipe without amp, median of steps 3-6 on the host clock)
    model, _ = create_model("topk_small_patch16_224", device="cuda",
                            drop_path_rate=0.1, reduction_loc=(3, 6, 9),
                            keep_rate=(0.7,),
                            generator=torch.Generator().manual_seed(1))
    opt, _ = create_optimizer(dict(model.named_parameters()),
                              OptimConfig(lr=1e-3, clip_grad=1.0,
                                          backbone_lr_scale=0.01),
                              lambda s: 1e-3, [])
    state = init_train_state(model, opt, ema=True, device="cuda")
    step = make_train_step(model, label_smoothing_loss, opt,
                           StepConfig(ema_decay=0.99996, amp=False),
                           torch.Generator(device="cuda").manual_seed(5))
    data = torch.Generator(device="cuda").manual_seed(3)
    seconds = []
    with torch.enable_grad():
        for _ in range(6):
            batch = {"image": torch.randn(B, 3, 224, 224, generator=data,
                                          device="cuda"),
                     "label": torch.randint(0, 1000, (B,), generator=data,
                                            device="cuda")}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
    out["fp32_train_topk"] = 1e3 * statistics.median(seconds[2:])
    del model, opt, state, step
    m, _ = create_model("ats_small_patch16_224", device="cuda",
                        reduction_loc=(3, 6, 9), keep_rate=(0.7,),
                        generator=torch.Generator().manual_seed(1))
    m = m.eval()
    images32 = torch.randn(B, 3, 224, 224, generator=g).to("cuda")
    out["fp32_ats_forward"] = cuda_ms(lambda: m(images32), 5)
    return out

def distill_ms():
    seconds, _, _, extra = train_run("dyvit@0.7 distill", 6)
    return dict(train_dyvit_distill=1e3 * statistics.median(seconds[2:]),
                dyvit_teacher=extra["teacher_ms"])

if os.environ.get("PORT_AB_TOOLS"):
    # --tools: the kernel tools' joint attention and chunked MLP, each
    # beside the port's route for the same half, per launch
    from chip_smoke import TOOLS_N, tool_weights
    from tokenreduction_tpu_torch.tools import tune_kernels
    tw = tool_weights(torch.Generator().manual_seed(9))
    twm = dict(tw, ls=tw["ls2"], lb=tw["lb2"])
    times = {}
    with torch.no_grad():
        for n in TOOLS_N:
            xt = torch.randn(B, n, D, generator=g).to("cuda", bf16)
            times[f"attn_joint_{n}_x10"] = ten(
                lambda: tune_kernels.attn_joint(xt, tw, HEADS, SCALE,
                                                with_scores=True))
            times[f"attn_route_{n}_x10"] = ten(
                lambda: tune_kernels.current_attention(xt, tw))
            times[f"mlp_chunked_{n}_x10"] = ten(
                lambda: tune_kernels.mlp_chunked(xt, twm, 4))
            times[f"mlp_route_{n}_x10"] = ten(
                lambda: tune_kernels.current_mlp(xt, twm))
    # the attention-core arrangements (#14) and the recomputing branch
    # backward (#15) at their tools' widths, each beside the port's route
    # for the same function (proto_attn.current_route: the qkv GEMM,
    # short_attention, the proj GEMM; proto_attn_bwd.current_route: #9's
    # forward and backward)
    from chip_smoke import proto_weights
    from tokenreduction_tpu_torch.tools import _measure
    from tokenreduction_tpu_torch.tools import proto_attn, proto_attn_bwd
    pw = proto_weights()
    pwa = {k: pw[k] for k in ("wqkv", "wproj")}
    with torch.no_grad():
        for n in proto_attn.WIDTHS:
            xt = _measure.inputs(B, n, "cuda", seed=n)
            for variant in proto_attn.VARIANTS:
                times[f"proto_attn_{variant}_{n}_x10"] = ten(
                    lambda: proto_attn.proto_attn(xt, pwa, variant))
            times[f"proto_attn_route_{n}_x10"] = ten(
                lambda: proto_attn.current_route(xt, pwa))
    for n in proto_attn_bwd.WIDTHS:
        xt = _measure.inputs(B, n, "cuda", seed=n)
        dy, drow0 = proto_attn_bwd.cotangents(B, n, "cuda", seed=n + 1)
        for variant in proto_attn_bwd.VARIANTS:
            times[f"proto_attn_bwd_{variant}_{n}_x10"] = ten(
                lambda: proto_attn_bwd.proto_attn_bwd(xt, pw, dy, drow0,
                                                      variant))
        times[f"proto_attn_bwd_route_{n}_x10"] = ten(
            lambda: proto_attn_bwd.current_route(xt, pw, dy, drow0))
    print(json.dumps(times))
    print(json.dumps(dict(attention_registers=attention_registers())))
    raise SystemExit(0)
if os.environ.get("PORT_AB_ATTENTION"):
    # --attention: the bf16 attention forwards and backwards alone, per
    # launch
    with torch.no_grad():
        fwd = dict(attention_x10=ten(lambda: _build.short_attention(
            qkv, merged, HEADS, SCALE)), **attention_times(), **rect_times())
    print(json.dumps(dict(**fwd, **bwd_times())))
    print(json.dumps(dict(attention_registers=attention_registers())))
    raise SystemExit(0)
steps = dict(train_topk=train_ms("topk@0.7"), train_dense=train_ms("dense"),
             train_tome=train_ms("tome@0.7"),
             train_heuristic=train_ms("heuristic"), **distill_ms())
with torch.no_grad():
    print(json.dumps(dict(
        **steps,
        full_block=cuda_ms(lambda: fused_full_block(x, *p.values(), HEADS,
                                                    SCALE), 50),
        gemm_qkv=cuda_ms(qkv_gemm, 50),
        dense_forward=cuda_ms(lambda: model(images), 10),
        gemm_qkv_x10=ten(qkv_gemm),
        gemm_fc1_x10=ten(lambda: _build.gemm(ln, p["w1"], p["b1"], hidden,
                                             gelu=True)),
        attention_x10=ten(lambda: _build.short_attention(qkv, merged, HEADS,
                                                         SCALE)),
        layer_norm_x10=ten(lambda: _build.layer_norm(
            ln, p["ls1"], p["lb1"], ln_out, eps=1e-6)),
        topk_forward=forward_ms("topk_small_patch16_224"),
        **ats_times(), **attention_times(), **bwd_times(),
        **gemm_times(), **rect_times(), **ln_bwd_times(),
        **standalone_times(), **keys_times(), **branch_sum_times(),
        **fp32_times(), **fp32_bwd_times())))
print(json.dumps(dict(attention_registers=attention_registers())))
"""


def run(checkout: pathlib.Path, part: str | None = None) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    if part:
        env[f"PORT_AB_{part.upper()}"] = "1"
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=checkout,
                          env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: {proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    print(checkout.name, lines[-1], flush=True)  # the registers
    return json.loads(lines[-2])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=pathlib.Path, nargs="?")
    ap.add_argument("change", type=pathlib.Path, nargs="?")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--once", type=pathlib.Path,
                    help="run the child once in this checkout alone")
    part = ap.add_mutually_exclusive_group()
    part.add_argument("--attention", action="store_const",
                      const="attention", dest="part",
                      help="time the bf16 attention forwards and "
                      "backwards alone")
    part.add_argument("--tools", action="store_const", const="tools",
                      dest="part", help="time the kernel tools' joint "
                      "attention, chunked MLP and attention prototypes "
                      "beside their routes")
    args = ap.parse_args()
    # the card and its power limit, beside which every time stands
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.once:
        print("once", json.dumps(run(args.once.resolve(), args.part)),
              flush=True)
        return
    if args.parent is None or args.change is None:
        ap.error("PARENT_DIR and CHANGE_DIR, or --once DIR")
    results = {"parent": [], "change": []}
    for _ in range(args.pairs):
        for label in ("parent", "change", "change", "parent"):
            out = run(getattr(args, label).resolve(), args.part)
            results[label].append(out)
            print(label, json.dumps(out), flush=True)
    for label, runs in results.items():
        # a device time the profiler did not see (None) is left out
        medians = {k: statistics.median(v) if (v := [
            r[k] for r in runs if r[k] is not None]) else None
            for k in runs[0]}
        print(f"median {label} (ms): {json.dumps(medians)}", flush=True)


if __name__ == "__main__":
    main()
