"""Build and load the port's CUDA kernels.

Each `csrc/<family>.cu` is compiled by nvcc, on its own, into a shared
library with a plain C interface and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -I csrc -o build/repro_torch/<family>-<hash>.so

The library name carries a hash of the sources and flags, so a changed
source builds anew and an unchanged one is loaded from `build/`. Builds
happen at first use (or all at once, in parallel, through `build()`);
importing this module compiles nothing and needs no GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {"scan_filter": "scan_filter.cu", "aggregate": "aggregate.cu",
           "scan_aggregate": "scan_aggregate.cu",
           "scan_compressed": "scan_compressed.cu",
           "group_aggregate": "group_aggregate.cu",
           "flash_attention": "flash_attention.cu",
           "decode_attention": "decode_attention.cu",
           "ssd_chunk": "ssd_chunk.cu"}
HEADERS = ("bitweave.cuh", "error.cuh", "hopper.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _U, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_longlong)
# C entry points and argument types of each family's library; every pointer
# and the stream are c_void_p, and each entry returns cudaGetLastError()
SIGNATURES = {
    "scan_filter": {
        # (words, out, n, code_bits, is_eq, const_packed, invert, stream)
        "scan_filter_launch": (_P, _P, _LL, _I, _I, _U, _I, _P)},
    "aggregate": {
        # (words, mask, scratch, out, n, code_bits, stream)
        "aggregate_launch": (_P, _P, _P, _P, _LL, _I, _P),
        # (words, mask, out, n_chunks, n_words, code_bits, stream)
        "aggregate_batched_launch": (_P, _P, _P, _LL, _LL, _I, _P)},
    "scan_aggregate": {
        # (pred, agg, valid, scratch, out, n, code_bits, is_eq,
        #  const_packed, invert, stream)
        "scan_aggregate_launch": (_P, _P, _P, _P, _P, _LL, _I, _I, _U, _I,
                                  _P),
        # (consts, flags, pred, agg, valid, out, n_chunks, n_words,
        #  code_bits, stream)
        "scan_aggregate_batched_launch": (_P, _P, _P, _P, _P, _P, _LL, _LL,
                                          _I, _P)},
    "scan_compressed": {
        # (values, lengths, out, n_runs, constant, op, code_bits, route,
        #  stream)
        "rle_scan_aggregate_launch": (_P, _P, _P, _LL, _I, _I, _I, _I, _P),
        # (values, lengths, out, n_chunks, n_runs, constant, op, code_bits,
        #  route, stream)
        "rle_scan_aggregate_batched_launch": (_P, _P, _P, _LL, _LL, _I, _I,
                                              _I, _I, _P)},
    "group_aggregate": {
        # (keys, vals, sel, group_keys, scratch, out, n_chunks, per_chunk,
        #  n_groups, stream)
        "group_sum_count_launch": (_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _P),
        # (values, lengths, group_keys, out, n_chunks, n_runs, n_groups,
        #  has_pred, prim, constant, invert, route, stream)
        "rle_group_accumulate_launch": (_P, _P, _P, _P, _LL, _LL, _I, _I, _I,
                                        _I, _I, _I, _P)},
    "flash_attention": {
        # (q, k, v, out, dtype, b, kvh, g, sq, skv, d, window, route,
        #  stream)
        "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL,
                                   _I, _I, _I, _P)},
    "decode_attention": {
        # (dtype, b, kvh, g, s, d, plan: four int64 out)
        "decode_attention_plan": (_I, _I, _I, _I, _LL, _I, _P),
        # (q, k, v, q_pos, kv_pos, scratch, copied, out, dtype, b, kvh, g,
        #  s, d, n_splits, window, stream)
        "decode_attention_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _LL, _I, _I, _I, _P)},
    "ssd_chunk": {
        # (x, dt, a_log, b, c, h_in, cb, states, total, y, h_out, dtype,
        #  route, b, s, h, p, n, q, stream)
        "ssd_chunk_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _I, _I, _I, _I, _P)},
}
# kernel operand dtypes -> the `dtype` code the float kernels take
FLOAT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: dict[str, ctypes.CDLL] = {}
# False in the ranks of a spawned world (repro_torch.dist.world): a rank
# loads what the caller built and never starts nvcc itself
BUILDS_ALLOWED = True


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are compiled from csrc/ at first use")
    return path


def library_path(name: str) -> Path:
    """build/repro_torch/<name>-<hash of sources and flags>.so"""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (SOURCES[name], *HEADERS):
        h.update(fname.encode())
        h.update((CSRC / fname).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named families (default: all) that are not built yet,
    one nvcc per source, all started together. Returns
    {name: {"seconds": wall seconds, "log": nvcc's ptxas report}}; a
    family already built reports seconds 0.0 and an empty log. Raises
    RuntimeError with nvcc's output when a build fails."""
    names = tuple(SOURCES) if names is None else tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas=-v", "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {name: {"seconds": 0.0, "log": ""} for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {SOURCES[name]} (exit {proc.returncode})\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The family's library, built first if needed, with its C entry
    points' argtypes/restype declared."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        if not BUILDS_ALLOWED:
            raise RuntimeError(
                f"{path.name} is not built, and a rank of a world does not "
                f"compile kernels: call repro_torch.kernels._build.build() "
                f"before spawning the world")
        build((name,))
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def require_hopper(device: torch.device) -> None:
    """The kernels are compiled for sm_90a only."""
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{cap[0]}.{cap[1]}; the port's kernels are built for sm_90a "
            f"(Hopper, 9.0). Use mode='torch_ref' for the plain PyTorch "
            f"versions")


def check_operand(t: torch.Tensor, what: str, like: torch.Tensor | None = None,
                  ndim: int = 1, dtypes=(torch.int32,)) -> None:
    """Kernel operands are contiguous CUDA tensors of `ndim` dimensions
    and one of `dtypes`: by default int32 — 1-D packed words or per-chunk
    constants/flags, 2-D (n_chunks, n_words) batched planes (bit views of
    the packed uint32 words) or (n_chunks, n_runs) run planes; the float
    kernels' operands (attention q/k/v, the SSD scan's) are float32 or
    bfloat16 (FLOAT_DTYPES) and 16-byte aligned. With `like`, the same
    shape (and dtype) on the same device."""
    if not t.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {t.device}")
    if t.dtype not in dtypes:
        kind = ("packed words are torch.int32 bit views of uint32"
                if dtypes == (torch.int32,) else f"expected one of {dtypes}")
        raise ValueError(f"{what}: dtype {t.dtype}; {kind}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: shape {tuple(t.shape)}; expected a "
                         f"{ndim}-D operand")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
    if like is not None and (t.shape != like.shape or t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"{what}: {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"does not match {like.dtype} {tuple(like.shape)} "
                         f"on {like.device}")
    if t.dtype in FLOAT_DTYPES and t.data_ptr() % 16:
        raise ValueError(f"{what}: not 16-byte aligned (the kernels load 16 "
                         f"bytes at a time)")


# The current stream's handle by device index, read without building a
# Stream object: a private call of torch's, kept for its speed on the
# decode path. Where a torch build lacks it, stream_of falls back to the
# public torch.cuda.current_stream, which gives the same handle.
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current stream of t's device, where kernels
    launch."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def call_on(t: torch.Tensor, fn, *args) -> int:
    """fn(*args) with t's device the current one (a kernel launches on the
    current device); switches device only when it is not."""
    index = t.get_device()
    if torch.cuda.current_device() == index:
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)
