"""The machine code of one of the port's CUDA sources in two checkouts,
compared kernel by kernel.

    python3 tools/sass_ab.py PARENT_DIR CHANGE_DIR [--source attention_sm90.cu]

Each checkout's ``tokenreduction_tpu_torch/csrc/<source>`` is compiled by
``nvcc`` into a cubin, with the change's ``ops/_build.py`` flags
(``COMPILE_FLAGS``, ``-cubin`` in place of ``-c``), and ``cuobjdump -sass``
prints each kernel's instructions; their addresses and encodings are left
out. For each kernel (by its mangled name, an anonymous namespace's
per-build hash left out) the script prints "same" with
its count of instruction lines, or how many lines differ (``difflib``),
or that one side lacks it (``--show N``: and the first N differing
lines, ``-`` the parent's, ``+`` the change's); the last line is one JSON
object
``{"source", "kernels", "same", "differ", "missing"}``. Needs the CUDA
toolkit (``nvcc``, ``cuobjdump``), no card. It exits 1 if any kernel
differs or is missing.
"""

from __future__ import annotations

import argparse
import difflib
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

FUNCTION = re.compile(r"^\s*Function : (\S+)")
ADDRESS = re.compile(r"/\*[0-9a-f]{4,}\*/")
ENCODING = re.compile(r"/\* 0x[0-9a-f]+ \*/")
# the per-build hash of an anonymous namespace in a mangled name
UNNAMED = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def tool(name: str) -> str:
    return shutil.which(name) or f"/usr/local/cuda/bin/{name}"


def compile_flags(change: pathlib.Path) -> list[str]:
    sys.path.insert(0, str(change))
    try:
        from tokenreduction_tpu_torch.ops import _build
    finally:
        sys.path.pop(0)
    return [f for f in _build.COMPILE_FLAGS if f not in ("-c", "-Xptxas=-v")]


def kernel_sass(checkout: pathlib.Path, source: str, flags: list[str],
                out: pathlib.Path) -> dict:
    """{mangled kernel name: its instruction lines}."""
    src = checkout / "tokenreduction_tpu_torch" / "csrc" / source
    subprocess.run([tool("nvcc"), *flags, "-cubin", "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    text = subprocess.run([tool("cuobjdump"), "-sass", str(out)],
                          check=True, capture_output=True, text=True).stdout
    kernels, body = {}, None
    for line in text.splitlines():
        head = FUNCTION.match(line)
        if head:
            body = kernels.setdefault(UNNAMED.sub("_GLOBAL__N__", head[1]), [])
        elif body is not None and ADDRESS.search(line):
            body.append(ENCODING.sub("", ADDRESS.sub("", line)).strip())
    return kernels


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("parent", type=pathlib.Path)
    p.add_argument("change", type=pathlib.Path)
    p.add_argument("--source", default="attention_sm90.cu")
    p.add_argument("--show", type=int, default=0,
                   help="print up to this many differing lines a kernel")
    args = p.parse_args(argv)
    flags = compile_flags(args.change.resolve())
    with tempfile.TemporaryDirectory() as tmp:
        sides = [kernel_sass(d.resolve(), args.source, flags,
                             pathlib.Path(tmp) / f"{i}.cubin")
                 for i, d in enumerate((args.parent, args.change))]
    parent, change = sides
    same = differ = missing = 0
    for name in sorted(set(parent) | set(change)):
        if name not in parent or name not in change:
            missing += 1
            side = "change" if name in change else "parent"
            print(f"{name}: only in the {side}")
            continue
        a, b = parent[name], change[name]
        if a == b:
            same += 1
            print(f"{name}: same, {len(a)} instruction lines")
        else:
            differ += 1
            diff = [d for d in difflib.ndiff(a, b) if d[:1] in "+-"]
            print(f"{name}: {len(diff)} lines differ ({len(a)} against "
                  f"{len(b)})")
            for line in diff[:args.show]:
                print("   ", line)
    print(json.dumps(dict(source=args.source, kernels=same + differ + missing,
                          same=same, differ=differ, missing=missing)))
    return 0 if differ == missing == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
