"""The port's bf16 GEMM (csrc/gemm_sm90.cu) in two checkouts, on one card:
its machine code and its launches' times.

    python3 tools/gemm_ab.py PARENT_DIR CHANGE_DIR [--pairs 2]

Each checkout builds its kernels in its own process (its own
``ops/_build.py``, into its own ``build/``). Then:

1. the SASS of every ``gemm_sm90_kernel`` variant in each build's library
   (``cuobjdump -sass``), the instructions' addresses and encodings left
   out; each of the parent's variants is matched to the change's variant
   with the same template arguments (a change that adds a last template
   argument is matched at its value false) and printed as the same
   instructions or as the count of lines that differ;
2. each bf16 GEMM launch of a DeiT-S block at B=256, N=197, as phase 2 of
   the checkout's ``chip_smoke.py`` builds it (``gemm_cases``), timed per
   launch by that checkout's ``per_launch_ms`` (ten back-to-back launches
   between two CUDA events, median of 20), in the order parent, change,
   change, parent, ``--pairs`` times, then the medians of each checkout.

Needs one CUDA card and the CUDA toolkit's ``cuobjdump``. The card's name
and power limit are printed first; times from separate calls are not
compared.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

_CHILD = r"""
import json, torch
from chip_smoke import gemm_cases, per_launch_ms
from tokenreduction_tpu_torch.ops import _build

lib = _build.kernels()
times = {}
for launch, label, run, *_ in gemm_cases(256 * 197,
                                         torch.Generator().manual_seed(5)):
    run()
    times[f"{launch} {label}"] = per_launch_ms(run)
print(json.dumps(dict(lib=str(lib.path), times=times)))
"""

FUNCTION = re.compile(r"^\s*Function : (\S+)")
ADDRESS = re.compile(r"/\*[0-9a-f]{4,}\*/")
ENCODING = re.compile(r"/\* 0x[0-9a-f]+ \*/")
VARIANT = re.compile(r"gemm_sm90_kernelI((?:Lb[01]E)+)E")


def run(checkout: pathlib.Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=checkout,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: {proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def gemm_sass(lib: str) -> dict:
    """{template arguments (bools): instruction lines} of every
    gemm_sm90_kernel variant in the library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, body = {}, None
    for line in text.splitlines():
        head = FUNCTION.match(line)
        if head:
            variant = VARIANT.search(head[1])
            body = None
            if variant:
                args = tuple(int(b) for b in re.findall(r"Lb([01])E",
                                                        variant[1]))
                body = out.setdefault(args, [])
            continue
        if body is None:
            continue
        code = ENCODING.sub("", ADDRESS.sub("", line)).strip()
        if code:
            body.append(code)
    return out


def compare_sass(parent_lib: str, change_lib: str):
    parent, change = gemm_sass(parent_lib), gemm_sass(change_lib)
    for args, body in sorted(parent.items()):
        other = change.get(args)
        if other is None and (*args, 0) in change:
            other = change[(*args, 0)]
        name = f"gemm_sm90_kernel<{', '.join(map(str, args))}>"
        if other is None:
            print(f"sass {name}: no such variant in the change", flush=True)
        elif other == body:
            print(f"sass {name}: the same {len(body)} instruction lines in "
                  "both", flush=True)
        else:
            differ = sum(a != b for a, b in zip(body, other)) + abs(
                len(body) - len(other))
            print(f"sass {name}: {differ} of {len(body)} lines differ "
                  f"(change {len(other)} lines)", flush=True)
    for args in sorted(set(change) - {(*a, 0) for a in parent}
                       - set(parent)):
        print(f"sass gemm_sm90_kernel<{', '.join(map(str, args))}>: the "
              f"change's own ({len(change[args])} lines)", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=pathlib.Path)
    ap.add_argument("change", type=pathlib.Path)
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    results, libs = {"parent": [], "change": []}, {}
    for _ in range(args.pairs):
        for label in ("parent", "change", "change", "parent"):
            out = run(getattr(args, label).resolve())
            libs[label] = out["lib"]
            results[label].append(out["times"])
            print(label, json.dumps(out["times"]), flush=True)
    compare_sass(libs["parent"], libs["change"])
    for label, runs in results.items():
        medians = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        print(f"median {label} (ms): {json.dumps(medians)}", flush=True)


if __name__ == "__main__":
    main()
