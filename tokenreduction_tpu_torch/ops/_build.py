"""Builds the hand-written CUDA kernels and binds them with ctypes.

At first use, ``nvcc`` compiles each ``csrc/*.cu`` into an object, all
sources at once in parallel processes, and links them into one shared
library with a plain C interface, under ``build/tokenreduction_tpu_torch/``
at the root of the checkout, in a directory named by a hash of the
sources and flags, so an edited source builds anew and an unchanged one
loads the library already built. Nothing here runs at import time: the
kernel wrappers import this module only on their CUDA branch.

Each launcher takes tensors the wrapper has already checked, passes their
pointers and PyTorch's current stream, and raises if the C call returns a
non-zero ``cudaError_t``. Launchers that reduce over rows allocate their
fp32 partials with ``torch.empty`` and return them with their outputs, for
the caller to sum in a fixed order in one ``sum_partials_many`` launch.
"""

from __future__ import annotations

import array
import ctypes
import dataclasses
import enum
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from tokenreduction_tpu_torch.ops.flash_attention import (
    SHORT_ATTENTION_MAX_N,
    merged_heads,
    packed_heads,
)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[2] / "build"
              / "tokenreduction_tpu_torch")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas=-v", "-c")
LINK_FLAGS = (*ARCH, "-shared")
LIB_NAME = "libtokenreduction_kernels.so"
GEMM_TILE = 128  # rows of a gemm output tile (and of each col_sums row)
# the jobs of one sum_partials_many launch: csrc/ln_gemm.cu's kSumJobs,
# whose entry point refuses more
SUM_JOBS = 8
# layer_norm_bwd's plan makes at most one band for each LN_BWD_WARPS rows
# (a row for each warp of a block at K = 384)
LN_BWD_WARPS = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_S = ctypes.POINTER(ctypes.c_longlong)  # strides, in elements
_SIGNATURES = {
    "tr_layer_norm": (_I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _F, _P, _P),
    "tr_layer_norm_bwd": (_I, _P, _P, _I, _I, _P, _F, _P, _P, _I, _I, _P,
                          _P),
    "tr_gemm": (_I, _P, _I, _I, _P, _I, _P, _I, _I, _P, _P, _I, _P, _P, _I,
                _I, _I, _P, _P, _P, _I, _P),
    "tr_gemm_wgrad": (_I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "tr_sum_partials_many": (_I, _P, _P, _P),
    "tr_short_attention": (_I, _P, _P, _P, _P, _S, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _F, _I, _P),
    "tr_short_attention_bwd": (_I, _P, _P, _P, _P, _P, _P, _P, _S, _P, _P, _P,
                               _P, _P, _I, _I, _I, _F, _P),
    "tr_head_mean_keys": (_I, _P, _P, _I, _I, _I, _P),
    "tr_gemm_sm90_config": (_P,),
    "tr_attention_sm90": (_P, _P, _P, _P, _S, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _F, _I, _P),
    "tr_attention_bwd_sm90": (_P, _P, _P, _P, _P, _P, _P, _P, _S, _P, _P, _P,
                              _P, _P, _P, _P, _I, _I, _I, _F, _P),
    "tr_attention_sm90_smem": (_I, _I, _P),
    "tr_attention_wide_sm90": (_P, _P, _P, _P, _S, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _F, _I, _P),
    "tr_attention_wide_bwd_sm90": (_P, _P, _P, _P, _P, _P, _P, _P, _S, _P,
                                   _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _F, _P),
    "tr_attention_wide_smem": (_I, _P),
    "tr_attention_wide_tf32": (_P, _P, _P, _P, _S, _P, _P, _P, _P, _P, _I,
                               _I, _I, _I, _F, _P),
    "tr_attention_wide_tf32_smem": (_I,),
    "tr_gemm_tf32_config": (_P,),
    "tr_gemm_tf32_bwd_config": (_P,),
    "tr_attention_tf32_plan": (_I, _I, _P),
    "tr_row_scale": (_I, _P, _P, _I, _I, _I, _P, _P),
    "tr_mlp_chunked": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _F, _P, _P),
    "tr_mlp_chunked_config": (_P,),
    "tr_attn_joint": (_P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P),
    "tr_attn_joint_smem": (),
    "tr_proto_attn": (_P, _I, _I, _I, _F, _I, _P, _P),
    "tr_proto_attn_smem": (_I, _I, _I),
    "tr_proto_attn_bwd": (_P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P),
    "tr_proto_attn_bwd_smem": (_I,),
}
# the arrangements of csrc/proto_attn.cu and csrc/proto_attn_bwd.cu, by
# their C codes
PROTO_ATTN_VARIANTS = {"loop": 0, "avpair": 1, "stacked": 2}
PROTO_ATTN_BWD_VARIANTS = {"loop": 0, "pack2": 1}
# what tr_gemm_sm90_config and tr_gemm_tf32_config report, in their order
_GEMM_CONFIG = ("BM", "BN", "BK", "STAGES", "SMEM_BYTES")
# and tr_gemm_tf32_bwd_config
_GEMM_BWD_CONFIG = ("BM", "BN", "BK", "SPLIT_STAGES", "RAW_STAGES_DYW",
                    "RAW_STAGES_WGRAD", "SMEM_BYTES_DYW", "SMEM_BYTES_WGRAD")
# the share of whole waves of blocks that the fp32 weight gradient's tiles
# of all slices fill at least (wgrad_split_tf32)
WGRAD_FILL = 0.9
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
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    return log


def _build(out: pathlib.Path) -> tuple[float, str]:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    units = [p for p in sources() if p.suffix == ".cu"]
    objs = [out.with_name(f"{p.stem}.{tag}.o") for p in units]
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for p, o in zip(units, objs)]
    logs, failed = [], []
    for p, proc in zip(units, procs):
        text, _ = proc.communicate()
        logs.append(f"== {p.name}\n{text}")
        if proc.returncode != 0:
            failed.append(p.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out.with_name(f"{out.name}.{tag}")
    logs.append(_run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]))
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    log = "\n".join(logs)
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


def heads_loadable(t: torch.Tensor) -> bool:
    """Whether the attention kernels read the [B, H, N, hd] operand t
    through its strides: a contiguous head dim, other strides that are
    multiples of 8 and a 16-byte aligned start (they load rows of 8
    elements at once)."""
    return (t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def check_heads(name: str, *heads: torch.Tensor):
    """Raise unless every [B, H, N, hd] operand has the first one's dtype
    (float32 or bfloat16), shape and CUDA device and ``heads_loadable``."""
    first = heads[0]
    if first.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {first.dtype} is neither float32 nor "
                        "bfloat16")
    for t in heads:
        if t.dim() != 4 or t.shape != first.shape:
            raise ValueError(f"{name}: expected [B, H, N, hd] operands of "
                             f"shape {tuple(first.shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != first.dtype or t.device != first.device:
            raise TypeError(f"{name}: operands of {t.dtype} on {t.device} and "
                            f"{first.dtype} on {first.device}")
        if not heads_loadable(t):
            raise ValueError(f"{name}: an operand's head dim must be "
                             "contiguous, its other strides multiples of 8 "
                             "and its start 16-byte aligned")


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


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def layer_norm(x, w, b, y, *, eps, idx=None, rows_out=1, rows_in=1):
    """y[M, K] = LN(x rows), in w's dtype; see csrc/ln_gemm.cu. Row m
    reads x row m, or, with idx int32 [M], row (m // rows_out) * rows_in
    + idx[m]. x is w's dtype or float32; contiguous CUDA tensors, checked
    by the caller. ``layer_norm.launches`` counts the launches."""
    M, K = y.shape
    err = kernels().lib.tr_layer_norm(
        _DTYPE_CODE[w.dtype], _DTYPE_CODE[x.dtype], _ptr(x), _ptr(idx), M, K,
        rows_out, rows_in, _ptr(w), _ptr(b), eps, _ptr(y), _stream(x))
    _check("tr_layer_norm", err)
    layer_norm.launches += 1


layer_norm.launches = 0


def ln_bwd_plan(M: int, sms: int) -> tuple[int, int]:
    """(bands, rows a band) of ``layer_norm_bwd`` over M rows on a card of
    ``sms`` SMs: block i takes the consecutive rows [i * rows, min(M,
    (i + 1) * rows)), at most one block an SM and one for each
    LN_BWD_WARPS rows (a row a warp), the last band the shortest. The
    bands, and so every bit of the result, depend on M and the SM count
    alone (not on K nor on the order the blocks run in)."""
    rows = max(1, _cdiv(M, max(1, min(sms, _cdiv(M, LN_BWD_WARPS)))))
    return _cdiv(M, rows), rows


def layer_norm_bwd(x, w, dln, dx, dwb, *, eps, res=None):
    """dx [M, K] (x's dtype) and dwb [2, K] = (d gamma, d beta) in dwb's
    dtype, from x [M, K], gamma w [K] and the fp32 dln [M, K]; see
    csrc/ln_gemm.cu. The rows in the bands of ``ln_bwd_plan``; each
    band's fp32 partial sums of the parameter gradients are summed in band
    order by the caller's ``sum_partials_many`` launch, so dwb is written
    by that launch: returns the [(partials, dwb)] it takes. With res [M, K]
    (x's dtype) dx is dx + res, added in fp32 before its rounding (the
    residual-fused branch's variant). Contiguous CUDA tensors, checked by
    the caller. ``layer_norm_bwd.launches`` counts the launches of the
    LayerNorm backward's kernel without res, ``layer_norm_bwd.res_launches``
    those with it."""
    M, K = x.shape
    bands, rows = ln_bwd_plan(M, _sms(x.device))
    part = torch.empty(bands, 2 * K, dtype=torch.float32, device=x.device)
    err = kernels().lib.tr_layer_norm_bwd(
        _DTYPE_CODE[x.dtype], _ptr(x), _ptr(dln), M, K, _ptr(w), eps,
        _ptr(dx), _ptr(part), bands, rows, _ptr(res), _stream(x))
    _check("tr_layer_norm_bwd", err)
    if res is None:
        layer_norm_bwd.launches += 1
    else:
        layer_norm_bwd.res_launches += 1
    return [(part, dwb.view(2 * K))]


layer_norm_bwd.launches = 0
layer_norm_bwd.res_launches = 0


def row_scale(x, s, y, *, rows):
    """y [M, K] = round(s[m // rows] * x [M, K]) in x's dtype, s fp32
    [M // rows]: a residual branch's cotangent under its per-image
    drop-path scale (csrc/ln_gemm.cu row_scale_kernel). Contiguous CUDA
    tensors, K a multiple of 8, checked by the caller.
    ``row_scale.launches`` counts the launches."""
    M, K = x.shape
    err = kernels().lib.tr_row_scale(_DTYPE_CODE[x.dtype], _ptr(x), _ptr(s),
                                     M, K, rows, _ptr(y), _stream(x))
    _check("tr_row_scale", err)
    row_scale.launches += 1


row_scale.launches = 0


class Gelu(enum.IntEnum):
    """The GEMM epilogue's activation, as tr_gemm's ``gelu`` code."""
    NONE = 0
    ERF = 1  # the exact-erf GELU, the model's
    TANH = 2  # its tanh form: bf16, forward layout, no GELU' (proto_gelu)


def gemm(x, w, bias, y, *, w_kn=False, gelu=Gelu.NONE, gelu_grad=None,
         mul=None, res=None, idx=None, rows_out=1, rows_in=1, col_sums=None,
         row_scale=None, scale_rows=1):
    """y[M, n_out] = epi(x @ w.T + bias), or epi(x @ w) with ``w_kn`` (w
    [K, n_out], read untransposed). epi: the activation ``gelu``
    (``Gelu``; with ``Gelu.ERF`` its fp32 derivative at the pre-activation
    may be written to ``gelu_grad``), then an optional fp32 factor ``mul``
    [M, n_out], then an optional residual, whose row m is gathered like
    ``layer_norm``'s rows when idx is given;
    ``col_sums`` [ceil(M / 128), n_out] fp32 receives the column sums of
    each 128-row tile of the result before its rounding. x, w and bias
    share one dtype; res and y have it too or, with bf16 operands, float32.
    Contiguous CUDA tensors, checked by the caller. bf16 runs
    csrc/gemm_sm90.cu, counted by ``gemm.launches``; fp32 runs 3xTF32 on
    the tensor cores: the forward layout (``w_kn`` false; GELU' out too)
    csrc/gemm_tf32_sm90.cu, counted by ``gemm.tf32_launches``, and the
    layout that only the fp32 backward launches (``w_kn``)
    csrc/gemm_tf32_bwd_sm90.cu, counted by ``gemm.tf32_bwd_launches``
    (csrc/ln_gemm.cu's tr_gemm picks by the same rule). ``row_scale``
    (fp32 [M // scale_rows], bf16 forward layout without GELU only): row
    m's result times row_scale[m // scale_rows] before the residual is
    added, a variant of csrc/gemm_sm90.cu counted by
    ``gemm.scaled_launches``."""
    M, n_out = y.shape
    res_dtype = _DTYPE_CODE[x.dtype if res is None else res.dtype]
    err = kernels().lib.tr_gemm(
        _DTYPE_CODE[x.dtype], _ptr(x), M, x.shape[1], _ptr(w), int(w_kn),
        _ptr(bias), n_out, int(Gelu(gelu)),
        _ptr(gelu_grad), _ptr(mul), res_dtype, _ptr(res), _ptr(idx),
        rows_out, rows_in, _DTYPE_CODE[y.dtype], _ptr(y), _ptr(col_sums),
        _ptr(row_scale), scale_rows, _stream(x))
    _check("tr_gemm", err)
    if row_scale is not None:
        gemm.scaled_launches += 1
    elif x.dtype == torch.bfloat16:
        gemm.launches += 1
    elif not w_kn:
        gemm.tf32_launches += 1
    else:
        gemm.tf32_bwd_launches += 1


gemm.launches = 0
gemm.tf32_launches = 0
gemm.tf32_bwd_launches = 0
gemm.scaled_launches = 0


@functools.lru_cache(maxsize=None)
def gemm_config() -> dict:
    """The bf16 GEMM's tile, stages and dynamic shared memory a block, as
    its library reports them (csrc/gemm_sm90.cu): {"BM", "BN", "BK",
    "STAGES", "SMEM_BYTES"}."""
    out = (ctypes.c_int * len(_GEMM_CONFIG))()
    _check("tr_gemm_sm90_config",
           kernels().lib.tr_gemm_sm90_config(ctypes.addressof(out)))
    return dict(zip(_GEMM_CONFIG, out))


@functools.lru_cache(maxsize=None)
def gemm_tf32_config() -> dict:
    """The fp32 forward GEMM's tile, stages and dynamic shared memory a
    block (csrc/gemm_tf32_sm90.cu), as its library reports them
    (tr_gemm_tf32_config); its grid is persistent, one block an SM and at
    most one a tile."""
    out = (ctypes.c_int * len(_GEMM_CONFIG))()
    _check("tr_gemm_tf32_config",
           kernels().lib.tr_gemm_tf32_config(ctypes.addressof(out)))
    return dict(zip(_GEMM_CONFIG, out))


@functools.lru_cache(maxsize=None)
def gemm_tf32_bwd_config() -> dict:
    """The fp32 backward GEMM's tile, rings and dynamic shared memory a
    block for each layout (csrc/gemm_tf32_bwd_sm90.cu), as its library
    reports them (tr_gemm_tf32_bwd_config): {"BM", "BN", "BK",
    "SPLIT_STAGES", "RAW_STAGES_DYW", "RAW_STAGES_WGRAD",
    "SMEM_BYTES_DYW", "SMEM_BYTES_WGRAD"}; its grid is persistent, one
    block an SM and at most one a tile."""
    out = (ctypes.c_int * len(_GEMM_BWD_CONFIG))()
    _check("tr_gemm_tf32_bwd_config",
           kernels().lib.tr_gemm_tf32_bwd_config(ctypes.addressof(out)))
    return dict(zip(_GEMM_BWD_CONFIG, out))


def gemm_wgrad(dy, x, dw, db=None):
    """dw [n_out, K] = dy^T x summed over the M rows of dy [M, n_out] and
    x [M, K], and db [n_out] (if given) = the column sums of dy, both in
    their own dtype. The rows are cut into slices of whole K steps of the
    dtype's kernel (``wgrad_plan``); each slice's fp32 partials are written
    apart and summed in a fixed order, so the result is the same bits from
    run to run, by the caller's ``sum_partials_many`` launch, so dw and
    db are written by that launch: returns the [(partials, dw),
    (partials, db)] it takes (db's if given). Contiguous CUDA tensors,
    checked by the caller. ``gemm_wgrad.launches`` counts the bf16
    launches (csrc/gemm_sm90.cu), ``gemm_wgrad.tf32_launches`` the fp32
    ones (csrc/gemm_tf32_bwd_sm90.cu, 3xTF32 on the tensor cores)."""
    M, n_out = dy.shape
    K = x.shape[1]
    splits, rows_per_split = wgrad_plan(M, n_out, K, dy.device, dy.dtype)
    ws = torch.empty(splits, n_out * K, dtype=torch.float32, device=dy.device)
    bws = None if db is None else torch.empty(
        splits, n_out, dtype=torch.float32, device=dy.device)
    err = kernels().lib.tr_gemm_wgrad(
        _DTYPE_CODE[dy.dtype], _ptr(dy), _ptr(x), M, n_out, K, splits,
        rows_per_split, _ptr(ws), _ptr(bws), _stream(dy))
    _check("tr_gemm_wgrad", err)
    if dy.dtype == torch.bfloat16:
        gemm_wgrad.launches += 1
    else:
        gemm_wgrad.tf32_launches += 1
    pairs = [(ws, dw.view(-1))]
    if db is not None:
        pairs.append((bws, db))
    return pairs


gemm_wgrad.launches = 0
gemm_wgrad.tf32_launches = 0


def wgrad_plan(M: int, n_out: int, K: int, device,
               dtype=torch.bfloat16) -> tuple[int, int]:
    """(splits, rows a split) of ``gemm_wgrad`` over M rows on ``device``
    in ``dtype``: bf16 ``wgrad_split`` with the bf16 GEMM's tile, fp32
    ``wgrad_split_tf32`` with the fp32 backward GEMM's, both with the
    card's SMs."""
    if dtype == torch.float32:
        cfg = gemm_tf32_bwd_config()
        return wgrad_split_tf32(M, n_out, K, _sms(device), cfg["BM"],
                                cfg["BN"], cfg["BK"])
    cfg = gemm_config()
    return wgrad_split(M, n_out, K, _sms(device), cfg["BM"], cfg["BN"],
                       cfg["BK"])


def wgrad_split(M: int, n_out: int, K: int, sms: int, bm: int, bn: int,
                bk: int) -> tuple[int, int]:
    """(splits, rows a split) of the weight gradient over M rows: whole K
    steps (bk rows), as many slices as leave each of ``sms`` SMs one
    bm x bn output tile of one slice; slice z takes rows [z * rows,
    (z + 1) * rows)."""
    tiles = _cdiv(n_out, bm) * _cdiv(K, bn)
    steps = max(1, _cdiv(M, bk))
    per = _cdiv(steps, max(1, min(steps, sms // tiles)))
    return _cdiv(steps, per), per * bk


def wave_fill(blocks: int, sms: int) -> float:
    """The share of whole waves of ``sms`` SMs that ``blocks`` fill."""
    return blocks / (_cdiv(blocks, sms) * sms)


@functools.lru_cache(maxsize=1024)
def wgrad_split_tf32(M: int, n_out: int, K: int, sms: int, bm: int, bn: int,
                     bk: int) -> tuple[int, int]:
    """(splits, rows a split) of the fp32 weight gradient over M rows, for
    a persistent grid of one block an SM walking the bm x bn output tiles
    of every slice: slices of whole K steps (bk rows), the fewest whose
    tiles fill WGRAD_FILL of whole waves of ``sms`` (the fewest write the
    fewest fp32 partials); where no count does, the fullest. Slice z takes
    rows [z * rows, (z + 1) * rows)."""
    tiles = _cdiv(n_out, bm) * _cdiv(K, bn)
    steps = max(1, _cdiv(M, bk))
    fullest = (0.0, 1, steps * bk)
    for s in range(1, steps + 1):
        per = _cdiv(steps, s)
        if _cdiv(steps, per) != s:
            continue  # the slices of a smaller count
        fill = wave_fill(s * tiles, sms)
        if fill >= WGRAD_FILL:
            return s, per * bk
        if fill > fullest[0]:
            fullest = (fill, s, per * bk)
    return fullest[1:]


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def sum_order(shapes) -> list[list[int]]:
    """The launches of ``sum_partials_many`` for jobs of [S, L] partials
    (``shapes``, in the caller's order): the jobs in groups of SUM_JOBS in
    that order, a launch a group, each launch's jobs tallest first (larger
    S first, equal S in the caller's order), so that the long chains start
    first. The launch gives each job its blocks in this order."""
    return [sorted(range(start, min(len(shapes), start + SUM_JOBS)),
                   key=lambda j: -shapes[j][0])
            for start in range(0, len(shapes), SUM_JOBS)]


def sum_partials_many(pairs):
    """out [L] = part [S, L] (fp32) summed over S in z order, in out's
    dtype, for every (part, out) of ``pairs``: one launch for each
    SUM_JOBS pairs, in ``sum_order``'s order (each column's order, and so
    its bits, are those of a launch of its pair alone). Contiguous CUDA
    tensors on one device, the partials 16-byte aligned, checked by the
    caller. ``sum_partials_many.launches`` counts the launches."""
    # the host's cost is what one launch saves, so the table goes as two
    # flat arrays: (part, out) pointers and (S, L, out dtype)
    for launch in _cached_sum_order(tuple(part.shape for part, _ in pairs)):
        ptrs, ints = array.array("Q"), array.array("i")
        for j in launch:
            part, out = pairs[j]
            ptrs.extend((part.data_ptr(), out.data_ptr()))
            ints.extend((*part.shape, _DTYPE_CODE[out.dtype]))
        err = kernels().lib.tr_sum_partials_many(
            len(launch), ptrs.buffer_info()[0], ints.buffer_info()[0],
            _stream(pairs[launch[0]][0]))
        _check("tr_sum_partials_many", err)
        sum_partials_many.launches += 1


sum_partials_many.launches = 0
_cached_sum_order = functools.lru_cache(maxsize=1024)(sum_order)


def sum_partials(part, out):
    """out [L] = part [S, L] (fp32) summed over S in order, in out's
    dtype: ``sum_partials_many`` of one pair."""
    sum_partials_many([(part, out)])


def _strides(*heads):
    """The (batch, head, row) strides of [B, H, N, hd] operands, as the
    kernels take them."""
    vals = [s for t in heads for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def wide(N: int, M: int | None = None) -> bool:
    """Whether an attention of N keys (and M query rows) runs the wide
    kernels (csrc/attention_wide_sm90.cu, csrc/attention_wide_tf32.cu):
    above SHORT_ATTENTION_MAX_N tokens, where the single-pass kernels
    stop; every launch at or below it is theirs."""
    return max(N, N if M is None else M) > SHORT_ATTENTION_MAX_N


def short_attention_heads(q, k, v, out, scale, *, bias=None, mask=None,
                          ids=None, row0=None, colsum=None, stats=None,
                          norm_p=False):
    """out = softmax(q k^T * scale [+ bias] [pair mask]) v per (image,
    head): q, k, v [B, H, N, 64] and out [B, H, M, 64] with the head dim
    contiguous and any other strides (multiples of 8 in bf16); optional
    fp32 bias [B, N] (per key), bool mask [B, N] (a pair whose query or key
    is invalid gets -FLT_MAX) and fp32 row0 / colsum [B, H, N]. ``norm_p``
    rounds the normalised probabilities before the value product (the
    training branch's forward), else the unnormalised ones (eval, and the
    training core's forward). With ids (contiguous int32 [B, M], a mask,
    no bias, no by-products) out row m is query row ids[b, m] over all N
    keys; without, M = N. bf16: the sm_90a kernel
    (csrc/attention_sm90.cu), which also writes the row statistics to
    ``stats`` (fp32 [B, H, N, 2]: the row max of the logits and 1/sum)
    when given; ``short_attention_heads.launches`` counts its square
    launches and ``short_attention_heads.rect_launches`` its rectangular
    ones. fp32: csrc/short_attention.cu's short_attention_tf32_kernel (no
    stats), 3xTF32 on the tensor cores, its square variants counted by
    ``short_attention_heads.tf32_launches`` and its rectangular ones (RECT,
    ATS in fp32) by ``short_attention_heads.tf32_rect_launches``. Above
    256 keys or query rows (``wide``) the wide kernels run instead, the
    same contract up to 2048: bf16 csrc/attention_wide_sm90.cu
    (``wide_launches``, ``wide_rect_launches``), fp32
    csrc/attention_wide_tf32.cu (``wide_tf32_launches``,
    ``wide_tf32_rect_launches``)."""
    B, H, N, _ = q.shape
    M = out.shape[2]
    rect = "rect_" if ids is not None else ""
    if q.dtype == torch.bfloat16:
        fn = "tr_attention_wide_sm90" if wide(N, M) else "tr_attention_sm90"
        err = getattr(kernels().lib, fn)(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _strides(q, k, v, out),
            _ptr(bias), _ptr(mask), _ptr(ids), _ptr(row0), _ptr(colsum),
            _ptr(stats), B, N, M, H, scale, int(norm_p), _stream(q))
        _check(fn, err)
        counter = ("wide_" if wide(N, M) else "") + rect + "launches"
    else:
        if stats is not None:
            raise ValueError("short_attention: the row statistics come from "
                             "the bf16 attention only")
        strides = _strides(q, k, v, out)
        args = (_ptr(bias), _ptr(mask), _ptr(ids), _ptr(row0), _ptr(colsum),
                B, N, M, H, scale)
        if wide(N, M):
            fn = "tr_attention_wide_tf32"
            err = kernels().lib.tr_attention_wide_tf32(
                _ptr(q), _ptr(k), _ptr(v), _ptr(out), strides, *args,
                _stream(q))
            counter = "wide_tf32_" + rect + "launches"
        else:
            fn = "tr_short_attention"
            err = kernels().lib.tr_short_attention(
                _DTYPE_CODE[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(out),
                strides, *args, int(norm_p), _stream(q))
            counter = "tf32_" + rect + "launches"
        _check(fn, err)
    setattr(short_attention_heads, counter,
            getattr(short_attention_heads, counter) + 1)


short_attention_heads.launches = 0
short_attention_heads.rect_launches = 0
short_attention_heads.tf32_launches = 0
short_attention_heads.tf32_rect_launches = 0
short_attention_heads.wide_launches = 0
short_attention_heads.wide_rect_launches = 0
short_attention_heads.wide_tf32_launches = 0
short_attention_heads.wide_tf32_rect_launches = 0


@functools.lru_cache(maxsize=None)
def attention_tf32_plan(n: int, m: int | None = None) -> dict:
    """The fp32 attention kernels' plan at n keys (csrc/short_attention.cu
    short_attention_tf32_kernel, csrc/short_attention_bwd.cu
    short_attention_bwd_tf32_kernel), as
    their library reports it (tr_attention_tf32_plan): {"smem": the square
    forward's dynamic shared memory a block in bytes (Q, K and V, rows
    padded to whole chunks, a row of colsum partials and the row
    statistics of each pair of warps), "threads" (every variant),
    "chunks": the 32-key chunks of a row of S held in a pair's registers,
    the kernel variant, "rect_smem": the rectangular forward's at m query
    rows (default n), "bwd_smem": the backward's (two resident operands,
    each group of 4 warps' two 16-row tiles and four partial tiles, the
    row statistics and the per-token vectors)}."""
    out = (ctypes.c_int * 5)()
    _check("tr_attention_tf32_plan", kernels().lib.tr_attention_tf32_plan(
        n, n if m is None else m, ctypes.addressof(out)))
    return dict(zip(("smem", "threads", "chunks", "rect_smem", "bwd_smem"),
                    out))


def short_attention(qkv, out, num_heads, scale, *, bias=None, mask=None,
                    ids=None, row0=None, colsum=None, stats=None,
                    norm_p=False):
    """``short_attention_heads`` off a packed qkv [B, N, 3D], written as
    merged heads out [B, M, D]."""
    short_attention_heads(*packed_heads(qkv, num_heads),
                          merged_heads(out, num_heads), scale, bias=bias,
                          mask=mask, ids=ids, row0=row0, colsum=colsum,
                          stats=stats, norm_p=norm_p)


def short_attention_bwd_heads(q, k, v, out, dout, dq, dk, dv, scale, *,
                              stats=None, row0=None, bias=None, mask=None,
                              drow0=None, dcs=None, dbias=None):
    """dq, dk, dv of the attention with the normalised probabilities
    (every operand [B, H, N, 64] as in ``short_attention_heads``) from
    q, k, v, the forward's output ``out``, the output's gradient dout, the
    fp32 bias [B, N], the bool validity mask [B, N] (the forward's pair
    mask, and dS zeroed at every masked pair) and the fp32 cotangents of
    row0 (drow0) and colsum (dcs) [B, H, N]; with dbias [B, H, N] fp32
    also the per-head bias gradient, the unscaled dS summed over the
    queries. None is zero (no mask; for dbias, not written). bf16: the
    sm_90a kernel (csrc/attention_sm90.cu), which reads the forward's
    ``stats`` and ``row0`` (with drow0) and ``out`` (delta's shortcut
    form), counted by ``short_attention_bwd_heads.launches``; fp32:
    csrc/short_attention_bwd.cu's short_attention_bwd_tf32_kernel, 3xTF32 on
    the tensor cores, which recomputes everything from q, k, v, counted by
    ``short_attention_bwd_heads.tf32_launches``. Above 256 keys the bf16
    backward is csrc/attention_wide_sm90.cu's two launches (dQ and delta,
    then dK, dV and dbias, with an fp32 [B, H, N] delta between them),
    counted once by ``short_attention_bwd_heads.wide_launches``; there is
    no fp32 backward above 256 (it raises)."""
    B, H, N, _ = q.shape
    if q.dtype == torch.bfloat16:
        if stats is None or out is None or (drow0 is not None
                                            and row0 is None):
            raise ValueError("short_attention_bwd: the bf16 backward reads "
                             "the forward's output, stats and row0")
        ptrs = (_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout), _ptr(dq),
                _ptr(dk), _ptr(dv), _strides(q, k, v, out, dout, dq, dk, dv),
                _ptr(stats), _ptr(row0), _ptr(bias), _ptr(mask), _ptr(drow0),
                _ptr(dcs), _ptr(dbias))
        if wide(N):
            delta = torch.empty(B, H, N, dtype=torch.float32, device=q.device)
            err = kernels().lib.tr_attention_wide_bwd_sm90(
                *ptrs, _ptr(delta), B, N, H, scale, _stream(q))
            _check("tr_attention_wide_bwd_sm90", err)
            short_attention_bwd_heads.wide_launches += 1
            return
        err = kernels().lib.tr_attention_bwd_sm90(*ptrs, B, N, H, scale,
                                                  _stream(q))
        _check("tr_attention_bwd_sm90", err)
        short_attention_bwd_heads.launches += 1
        return
    if wide(N):
        raise ValueError(f"short_attention_bwd: N={N}: the fp32 backward "
                         f"takes at most {SHORT_ATTENTION_MAX_N} tokens")
    err = kernels().lib.tr_short_attention_bwd(
        _DTYPE_CODE[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(dq),
        _ptr(dk), _ptr(dv), _strides(q, k, v, dout, dq, dk, dv), _ptr(bias),
        _ptr(mask), _ptr(drow0), _ptr(dcs), _ptr(dbias), B, N, H, scale,
        _stream(q))
    _check("tr_short_attention_bwd", err)
    short_attention_bwd_heads.tf32_launches += 1


short_attention_bwd_heads.launches = 0
short_attention_bwd_heads.tf32_launches = 0
short_attention_bwd_heads.wide_launches = 0


def short_attention_bwd(qkv, out, dout, drow0, dqkv, num_heads, scale, *,
                        stats=None, row0=None):
    """``short_attention_bwd_heads`` off a packed qkv [B, N, 3D], the
    forward's merged heads out and their gradient dout [B, N, D], written
    as the packed dqkv [B, N, 3D]."""
    short_attention_bwd_heads(*packed_heads(qkv, num_heads),
                              merged_heads(out, num_heads),
                              merged_heads(dout, num_heads),
                              *packed_heads(dqkv, num_heads), scale,
                              stats=stats, row0=row0, drow0=drow0)


@functools.lru_cache(maxsize=None)
def attention_smem(n: int, m: int | None = None) -> dict:
    """The dynamic shared memory a block of the sm_90a attention takes at
    n keys, as its library reports it: {"forward", "backward",
    "rectangular"} bytes, the last at m query rows (default n)."""
    out = (ctypes.c_int * 3)()
    _check("tr_attention_sm90_smem", kernels().lib.tr_attention_sm90_smem(
        n, n if m is None else m, ctypes.addressof(out)))
    return dict(zip(("forward", "backward", "rectangular"), out))


@functools.lru_cache(maxsize=None)
def attention_wide_smem(n: int) -> dict:
    """The dynamic shared memory a block of each wide attention kernel
    takes at n keys, as its library reports it: {"forward" (bf16, square
    and rectangular), "dq", "dkv" (the bf16 backward's two launches),
    "tf32" (the fp32 forward)} bytes."""
    out = (ctypes.c_int * 3)()
    _check("tr_attention_wide_smem", kernels().lib.tr_attention_wide_smem(
        n, ctypes.addressof(out)))
    return {**dict(zip(("forward", "dq", "dkv"), out)),
            "tf32": kernels().lib.tr_attention_wide_tf32_smem(n)}


def head_mean_keys(qkv, keys, num_heads):
    """keys [B, N, hd] = the head mean of the keys of a packed qkv
    [B, N, 3D], summed in fp32 in head order and rounded once. See
    csrc/short_attention.cu: 3, 6 or 12 heads of a width that is a
    multiple of 8 (bf16) or 4 (fp32), 16-byte aligned, or the launch is
    refused. ``head_mean_keys.launches`` counts the launches."""
    B, N, D3 = qkv.shape
    err = kernels().lib.tr_head_mean_keys(
        _DTYPE_CODE[qkv.dtype], _ptr(qkv), _ptr(keys), B * N, num_heads,
        D3 // 3 // num_heads, _stream(qkv))
    _check("tr_head_mean_keys", err)
    head_mean_keys.launches += 1


head_mean_keys.launches = 0


def mlp_chunked(x, ls, lb, w1, b1, w2, b2, out, *, eps):
    """out [M, 384] = x + fc2(gelu(fc1(LN x))) over rows x [M, 384] with
    the hidden units on chip (csrc/mlp_chunked.cu): w1 [H4, 384], w2
    [384, H4] (nn.Linear's layout), H4 a multiple of
    ``mlp_chunked_config()["HC"]``; contiguous bf16 CUDA tensors, checked by
    the caller. ``mlp_chunked.launches`` counts the launches."""
    M, K = x.shape
    err = kernels().lib.tr_mlp_chunked(
        _ptr(x), M, K, _ptr(ls), _ptr(lb), _ptr(w1), _ptr(b1), _ptr(w2),
        _ptr(b2), w1.shape[0], eps, _ptr(out), _stream(x))
    _check("tr_mlp_chunked", err)
    mlp_chunked.launches += 1


mlp_chunked.launches = 0


@functools.lru_cache(maxsize=None)
def mlp_chunked_config() -> dict:
    """The chunked MLP kernel's rows a block, hidden units a slice and
    dynamic shared memory a block, as its library reports them:
    {"BM", "HC", "SMEM_BYTES"}."""
    out = (ctypes.c_int * 3)()
    _check("tr_mlp_chunked_config",
           kernels().lib.tr_mlp_chunked_config(ctypes.addressof(out)))
    return dict(zip(("BM", "HC", "SMEM_BYTES"), out))


def attn_joint(ln, wqkv, bqkv, merged, num_heads, scale, *, row0=None,
               colsum=None):
    """merged [B, N, D] (bf16) = the attention of each (image, head) over
    q, k, v = ln . Wqkv^T + bqkv made on chip (csrc/attn_joint.cu) from
    the LayerNorm'd rows ln [B, N, D] and wqkv [3D, D], bqkv [3D]; row0 and
    colsum [B, H, N] fp32 when given. Head dim 64, N <= 256; contiguous
    bf16 CUDA tensors, checked by the caller. ``attn_joint.launches``
    counts the launches."""
    B, N, D = ln.shape
    err = kernels().lib.tr_attn_joint(
        _ptr(ln), _ptr(wqkv), _ptr(bqkv), B, N, D, num_heads, scale,
        _ptr(merged), _ptr(row0), _ptr(colsum), _stream(ln))
    _check("tr_attn_joint", err)
    attn_joint.launches += 1


attn_joint.launches = 0


def attn_joint_smem() -> int:
    """The dynamic shared memory a block of ``attn_joint`` takes (the same
    at every N), as its library reports it."""
    return kernels().lib.tr_attn_joint_smem()


def proto_attn(qkv, merged, num_heads, scale, *, variant):
    """merged [B, N, D] (bf16) = each (image, head)'s attention over the
    packed qkv [B, N, 3D] in the arrangement ``variant`` of
    csrc/proto_attn.cu ("loop", "avpair": an even head count, "stacked");
    head dim 64, N <= 256; contiguous bf16 CUDA tensors, checked by the
    caller. ``proto_attn.launches`` counts the launches."""
    B, N, _ = qkv.shape
    err = kernels().lib.tr_proto_attn(
        _ptr(qkv), B, N, num_heads, scale, PROTO_ATTN_VARIANTS[variant],
        _ptr(merged), _stream(qkv))
    _check("tr_proto_attn", err)
    proto_attn.launches += 1


proto_attn.launches = 0


def proto_attn_smem(n: int, num_heads: int, variant: str) -> int:
    """The dynamic shared memory a block of ``proto_attn``'s arrangement
    takes at n keys and ``num_heads`` heads, as its library reports it."""
    return kernels().lib.tr_proto_attn_smem(n, num_heads,
                                            PROTO_ATTN_VARIANTS[variant])


def proto_attn_bwd(qkv, dout, drow0, merged, dqkv, num_heads, scale, *,
                   variant):
    """merged [B, N, D] and the packed dqkv [B, N, 3D] (bf16) of each
    (image, head)'s attention recomputed from the packed qkv [B, N, 3D],
    with the merged heads' cotangent dout [B, N, D] (bf16) and the row0
    cotangent drow0 [B, H, N] (fp32), in the arrangement ``variant`` of
    csrc/proto_attn_bwd.cu ("loop" or "pack2"); head dim 64, N <= 256;
    contiguous CUDA tensors, checked by the caller.
    ``proto_attn_bwd.launches`` counts the launches."""
    B, N, _ = qkv.shape
    err = kernels().lib.tr_proto_attn_bwd(
        _ptr(qkv), _ptr(dout), _ptr(drow0), B, N, num_heads, scale,
        PROTO_ATTN_BWD_VARIANTS[variant], _ptr(merged), _ptr(dqkv),
        _stream(qkv))
    _check("tr_proto_attn_bwd", err)
    proto_attn_bwd.launches += 1


proto_attn_bwd.launches = 0


def proto_attn_bwd_smem(n: int) -> int:
    """The dynamic shared memory a block of ``proto_attn_bwd`` takes at n
    keys, as its library reports it."""
    return kernels().lib.tr_proto_attn_bwd_smem(n)
