"""Time the PyTorch port in two checkouts, in turns, on one card.

    python3 tools/port_ab.py PARENT_DIR CHANGE_DIR [--pairs 3]

Each checkout runs in its own process, with its own kernel build, in the
order parent, change, change, parent, repeated ``--pairs`` times. The
child takes its timer (``cuda_ms``, CUDA events) and its seeded DeiT-S
block weights (``block_params``) from that checkout's ``chip_smoke.py``.
Each run prints the times, in ms, of one full block (``fused_full_block``,
bf16, B=256, N=197, median of 50), of the qkv GEMM alone at the same rows
(median of 50), and of a dense DeiT-S bf16 b256 forward (median of 10), of
the topk@0.7 and dense train steps (``train_run``: bench.py's recipe at
b256, the median of steps 3-6 on the host clock), and, per launch, of ten
back-to-back launches between one pair of events (median of 20), so
that the host's launch cost is hidden: the qkv GEMM, the fc1 GEMM with
GELU, the attention and the LayerNorm at the same shapes. The last lines give each checkout's medians over its runs. Needs
one CUDA card; numbers from separate calls are not compared.
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
import json, statistics, torch
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
def train_ms(label):
    return 1e3 * statistics.median(train_run(label, 6)[0][2:])

steps = dict(train_topk=train_ms("topk@0.7"), train_dense=train_ms("dense"))
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
            ln, p["ls1"], p["lb1"], ln_out, eps=1e-6)))))
"""


def run(checkout: pathlib.Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=checkout,
                          env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: {proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=pathlib.Path)
    ap.add_argument("change", type=pathlib.Path)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
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
