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
           "scan_aggregate": "scan_aggregate.cu"}
HEADERS = ("bitweave.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _U, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_longlong)
# C entry point and argument types of each family; every pointer and the
# stream are c_void_p, and each entry returns cudaGetLastError()
SIGNATURES = {
    # (words, out, n, code_bits, is_eq, const_packed, invert, stream)
    "scan_filter": ("scan_filter_launch", (_P, _P, _LL, _I, _I, _U, _I, _P)),
    # (words, mask, scratch, out, n, code_bits, stream)
    "aggregate": ("aggregate_launch", (_P, _P, _P, _P, _LL, _I, _P)),
    # (pred, agg, valid, scratch, out, n, code_bits, is_eq, const_packed,
    #  invert, stream)
    "scan_aggregate": ("scan_aggregate_launch",
                       (_P, _P, _P, _P, _P, _LL, _I, _I, _U, _I, _P)),
}

_LIBS: dict[str, ctypes.CDLL] = {}


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
    point's argtypes/restype declared."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build((name,))
    lib = ctypes.CDLL(str(path))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    lib.bitweave_error_string.argtypes = [ctypes.c_int]
    lib.bitweave_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if err != 0:
        msg = lib.bitweave_error_string(err).decode()
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


def check_operand(t: torch.Tensor, what: str, like: torch.Tensor | None = None
                  ) -> None:
    """Kernel operands are contiguous 1-D int32 CUDA tensors (bit views of
    the packed uint32 words), all of one length on one device."""
    if not t.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{what}: dtype {t.dtype}; packed words are "
                         f"torch.int32 bit views of uint32")
    if t.dim() != 1:
        raise ValueError(f"{what}: shape {tuple(t.shape)}; expected 1-D "
                         f"packed words")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
    if like is not None and (t.shape != like.shape
                             or t.device != like.device):
        raise ValueError(f"{what}: shape {tuple(t.shape)} on {t.device} "
                         f"does not match {tuple(like.shape)} on "
                         f"{like.device}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
