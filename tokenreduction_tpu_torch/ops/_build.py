"""Builds the hand-written CUDA kernels and binds them with ctypes.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into one shared
library with a plain C interface, under ``build/tokenreduction_tpu_torch/``
at the root of the checkout, in a directory named by a hash of the
sources and flags, so an edited source builds anew and an unchanged one
loads the library already built. Nothing here runs at import time: the
kernel wrappers import this module only on their CUDA branch.

Each launcher takes tensors the wrapper has already checked, passes their
pointers and PyTorch's current stream, and raises if the C call returns a
non-zero ``cudaError_t``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[2] / "build"
              / "tokenreduction_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "libtokenreduction_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "tr_layer_norm": (_I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _F, _P, _P),
    "tr_gemm": (_I, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P,
                _P),
    "tr_short_attention": (_I, _P, _P, _P, _P, _I, _I, _I, _F, _P),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class Kernels:
    lib: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float  # 0.0 when the library was already built
    build_log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels are built from csrc/ at first use")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(out: pathlib.Path) -> tuple[float, str]:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sources() if p.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    (out.parent / "build.log").write_text(log)
    return seconds, log


@functools.lru_cache(maxsize=None)
def kernels() -> Kernels:
    """Build (once per source hash) and load the kernel library."""
    path = BUILD_ROOT / source_hash() / LIB_NAME
    seconds, log = 0.0, ""
    if not path.is_file():
        seconds, log = _build(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tr_error_string.argtypes = (_I,)
    lib.tr_error_string.restype = ctypes.c_char_p
    return Kernels(lib, path, seconds, log)


def check_operands(name: str, x: torch.Tensor, *params: torch.Tensor):
    """Raise unless x and every param are contiguous, 16-byte aligned
    tensors of x's dtype (float32 or bfloat16) on x's CUDA device."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} is neither float32 nor "
                        "bfloat16")
    for t in (x, *params):
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: operand dtype {t.dtype} != {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


def check_shapes(name: str, *pairs):
    """Raise unless each (tensor, shape) pair matches."""
    for t, shape in pairs:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")


def check_idx(name: str, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """idx [B, K] integer ids on x's device -> contiguous int32. (An id
    outside 0..N-1 is caught on the card: the kernel faults.)"""
    B = x.shape[0]
    if idx.dim() != 2 or idx.shape[0] != B:
        raise ValueError(f"{name}: idx must be [B={B}, K], got "
                         f"{tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: idx dtype {idx.dtype} is not an integer "
                        "type")
    if idx.device != x.device:
        raise ValueError(f"{name}: idx on {idx.device}, x on {x.device}")
    return idx.to(torch.int32).contiguous()


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check(name: str, err: int):
    if err != 0:
        msg = kernels().lib.tr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def layer_norm(x, w, b, y, *, eps, idx=None, rows_out=1, rows_in=1):
    """y[M, K] = LN(x rows), in w's dtype; see csrc/ln_gemm.cu. Row m
    reads x row m, or, with idx int32 [M], row (m // rows_out) * rows_in
    + idx[m]. x is w's dtype or float32; contiguous CUDA tensors, checked
    by the caller."""
    M, K = y.shape
    err = kernels().lib.tr_layer_norm(
        _DTYPE_CODE[w.dtype], _DTYPE_CODE[x.dtype], _ptr(x), _ptr(idx), M, K,
        rows_out, rows_in, _ptr(w), _ptr(b), eps, _ptr(y),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check("tr_layer_norm", err)


def gemm(x, w, bias, y, *, gelu=False, res=None, idx=None, rows_out=1,
         rows_in=1):
    """y[M, n_out] = epi(x @ w.T + bias): optional GELU, then an optional
    residual, whose row m is gathered like ``layer_norm``'s rows when idx
    is given; see csrc/ln_gemm.cu. x, w and bias share one dtype; res and
    y have it too or, with bf16 operands, float32. Contiguous CUDA
    tensors, checked by the caller."""
    M, n_out = y.shape
    res_dtype = _DTYPE_CODE[x.dtype if res is None else res.dtype]
    err = kernels().lib.tr_gemm(
        _DTYPE_CODE[x.dtype], _ptr(x), M, x.shape[1], _ptr(w), _ptr(bias),
        n_out, int(gelu), res_dtype, _ptr(res), _ptr(idx), rows_out, rows_in,
        _DTYPE_CODE[y.dtype], _ptr(y),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check("tr_gemm", err)


def short_attention(qkv, out, num_heads, scale, *, row0=None, colsum=None):
    """out [B, N, D] = softmax(q k^T * scale) v per head, off qkv
    [B, N, 3D]; optional fp32 row0 / colsum [B, H, N]. See
    csrc/short_attention.cu."""
    B, N, _ = qkv.shape
    err = kernels().lib.tr_short_attention(
        _DTYPE_CODE[qkv.dtype], _ptr(qkv), _ptr(out), _ptr(row0),
        _ptr(colsum), B, N, num_heads, scale,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    _check("tr_short_attention", err)
