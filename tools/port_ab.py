"""Time the PyTorch port in two checkouts, in turns, on one card.

    python3 tools/port_ab.py PARENT_DIR CHANGE_DIR [--pairs 3]

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
of the packed keys). Each run also prints the ptxas registers of the
attention kernels' variants (``attention_registers``, from its
checkout's build log), and of the LayerNorm backward's.
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
import inspect, json, re, statistics, torch
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
        out[f"ln_bwd_{Nl}_x10"] = ten(lambda: _build.layer_norm_bwd(
            xl, p["ls1"], dln, dx, dwb, eps=1e-6))
        out[f"ln_bwd_{Nl}_aten_x10"] = ten(
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, xl, [D], mean, rstd, p["ls1"], p["lb1"],
                [True, True, True]))
    return out

def standalone_times():
    # the other hand-written kernels per launch: layer_norm of bf16, fp32
    # and gathered rows (F.layer_norm beside the bf16 rows), sum_partials
    # at every [S, L] that one layer_norm_bwd and the block's four
    # gemm_wgrad calls give it in this checkout (recorded), beside
    # part.sum(0), and head_mean_keys beside the head mean of the packed
    # keys
    import torch.nn.functional as F
    out, shapes = {}, []
    x32 = ln.float()
    ln_y = torch.empty_like(ln)
    out["layer_norm_bf16_x10"] = ten(lambda: _build.layer_norm(
        ln, p["ls1"], p["lb1"], ln_y, eps=1e-6))
    out["layer_norm_bf16_F_x10"] = ten(lambda: F.layer_norm(
        ln, (D,), p["ls1"], p["lb1"], 1e-6))
    out["layer_norm_fp32_x10"] = ten(lambda: _build.layer_norm(
        x32, p["ls1"], p["lb1"], ln_y, eps=1e-6))
    K = 138
    idx = torch.stack([torch.randperm(N, generator=g)[:K]
                       for _ in range(B)]).to("cuda", torch.int32)
    y_k = torch.empty(B * K, D, device="cuda", dtype=bf16)
    out["layer_norm_gathered_x10"] = ten(lambda: _build.layer_norm(
        ln, p["ls1"], p["lb1"], y_k, eps=1e-6, idx=idx, rows_out=K,
        rows_in=N))
    real = _build.sum_partials

    def record(part, o):
        shapes.append(tuple(part.shape))
        real(part, o)

    record.launches = 0  # the checkout's launcher may count on its name
    _build.sum_partials = record
    try:
        dln = torch.randn(B * N, D, generator=g).to("cuda")
        _build.layer_norm_bwd(ln, p["ls1"], dln, torch.empty_like(ln),
                              torch.empty(2, D, device="cuda", dtype=bf16),
                              eps=1e-6)
        for n_out, k_in in ((3 * D, D), (D, D), (H4, D), (D, H4)):
            dyw = torch.randn(B * N, n_out, generator=g).to("cuda", bf16)
            xw = torch.randn(B * N, k_in, generator=g).to("cuda", bf16)
            _build.gemm_wgrad(dyw, xw, torch.empty(n_out, k_in, device="cuda",
                                                   dtype=bf16),
                              torch.empty(n_out, device="cuda", dtype=bf16))
    finally:
        _build.sum_partials = real
    for S, L in dict.fromkeys(shapes):
        part = torch.randn(S, L, generator=g).to("cuda")
        o = torch.empty(L, device="cuda", dtype=bf16)
        out[f"sum_partials_{S}x{L}_x10"] = ten(lambda: real(part, o))
        out[f"sum_partials_{S}x{L}_sum_x10"] = ten(lambda: part.sum(0))
    keys = torch.empty(B, N, D // HEADS, device="cuda", dtype=bf16)
    out["head_mean_keys_x10"] = ten(lambda: _build.head_mean_keys(
        qkv, keys, HEADS))
    out["head_mean_keys_mean_x10"] = ten(lambda: qkv[..., D:2 * D].view(
        B, N, HEADS, D // HEADS).mean(2))
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
        elif name and ("attention" in name or "layer_norm_bwd" in name) \
                and "registers" in line:
            regs[name[-70:]] = int(re.search(r"Used (\d+) registers",
                                             line)[1])
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
    gemm, wgrad = _build.gemm, _build.gemm_wgrad
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

steps = dict(train_topk=train_ms("topk@0.7"), train_dense=train_ms("dense"),
             train_tome=train_ms("tome@0.7"),
             train_heuristic=train_ms("heuristic"))
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
        **standalone_times())))
print(json.dumps(dict(attention_registers=attention_registers())))
"""


def run(checkout: pathlib.Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=checkout,
                          env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: {proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    print(checkout.name, lines[-1], flush=True)  # the registers
    return json.loads(lines[-2])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=pathlib.Path)
    ap.add_argument("change", type=pathlib.Path)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    # the card and its power limit, beside which every time stands
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    results = {"parent": [], "change": []}
    for _ in range(args.pairs):
        for label in ("parent", "change", "change", "parent"):
            out = run(getattr(args, label).resolve())
            results[label].append(out)
            print(label, json.dumps(out), flush=True)
    for label, runs in results.items():
        medians = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        print(f"median {label} (ms): {json.dumps(medians)}", flush=True)


if __name__ == "__main__":
    main()
