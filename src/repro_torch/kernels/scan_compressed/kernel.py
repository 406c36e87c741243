"""ctypes wrappers of the CUDA RLE scan+aggregate (csrc/scan_compressed.cu).

Counterparts of repro/kernels/scan_compressed/kernel.py::
rle_scan_aggregate_packed (one chunk) and ::rle_scan_aggregate_batched_packed
(every chunk in one launch). Both entry points run the same kernel body on
one of two routes that `route` picks from the launch's shape: "warp" (a
warp a chunk, eight chunks a block, reduced by shuffles alone) for short
chunks, "block" (a 256-thread block a chunk) for long ones.

At the store path's shapes a launch moves kilobytes, so the wrappers' host
work is most of a call: each reads its operands' attributes once, checks
them in one test (and only on a failure runs the full checks that name
the fault), allocates its output with one torch.empty and switches device
only when it must.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.aggregate.ref import identity_row
from repro_torch.kernels.scan_filter.ref import OPS

LAUNCHES = 0           # real CUDA launches of the single-chunk entry
BATCHED_LAUNCHES = 0   # ... of the batched entry

ROUTES = ("block", "warp")   # the launch's route code is the index
WARP_RUNS = 128        # a chunk the warp route takes at any chunk count
WARP_MAX_RUNS = 1536   # the longest chunk it takes at any count

_OP_CODES = {op: i for i, op in enumerate(OPS)}
_CODE_BITS = (2, 4, 8, 16)
_INT32 = torch.int32


def warp_limit(n_chunks: int) -> int:
    """The longest chunk the warp route takes in a launch of `n_chunks`
    chunks: n_chunks // 2 runs, within [WARP_RUNS, WARP_MAX_RUNS].

    Device time a launch on the H100 (tools/rle_routes.py; PERF.md): at
    any chunk count a chunk of up to 128 runs (a 16-byte load a lane) is
    faster on a warp than on a block, which idles most of its threads and
    pays a block reduction. Longer chunks serialize on the warp's lanes,
    and the block route's one wave of blocks wins until the chunks
    outnumber what a wave holds: the warp route wins up to about
    n_chunks / 2 runs (256 at 528 chunks, 512 at 1056) and up to 1536
    from 2112 chunks on, where n_chunks // 2 leaves 1536-run chunks on
    the block route at 2112 (~10% slower); at 2048 runs the block route
    is as fast or faster."""
    return min(WARP_MAX_RUNS, max(WARP_RUNS, n_chunks // 2))


def route(n_chunks: int, n_runs: int) -> str:
    """The route of a launch over `n_chunks` chunks of `n_runs` runs each:
    "warp" (a warp a chunk) up to warp_limit(n_chunks) runs, "block" (a
    block a chunk) past it."""
    return "warp" if n_runs <= warp_limit(n_chunks) else "block"


def _codes(op: str, constant: int, code_bits: int,
           way: str | None) -> int:
    """The predicate's launch code, after the argument checks (`way`, a
    forced route, included)."""
    code = _OP_CODES.get(op)
    if code is None:
        raise ValueError(f"unknown predicate op {op!r}; expected one of "
                         f"{OPS}")
    if code_bits not in _CODE_BITS:
        raise ValueError(f"code_bits={code_bits}; expected 2, 4, 8 or 16")
    if not -2**31 <= int(constant) < 2**31:
        raise ValueError(f"constant {constant} is not an int32")
    if way is not None and way not in ROUTES:
        raise ValueError(f"route {way!r}; expected one of {ROUTES}")
    return code


def _check_planes(values: torch.Tensor, lengths: torch.Tensor, names,
                  ndim: int) -> None:
    """The planes must be contiguous int32 CUDA tensors of `ndim`
    dimensions and one shape on one device: one test, and only where it
    fails, _build.check_operand's checks, which name the fault."""
    index = values.get_device()      # -1 on the CPU
    if (index < 0 or lengths.get_device() != index
            or values.dtype != _INT32 or lengths.dtype != _INT32
            or values.dim() != ndim or lengths.shape != values.shape
            or not (values.is_contiguous() and lengths.is_contiguous())):
        _build.check_operand(values, names[0], ndim=ndim)
        _build.check_operand(lengths, names[1], like=values, ndim=ndim)


def rle_scan_aggregate_packed(values: torch.Tensor, lengths: torch.Tensor,
                              *, constant: int, op: str, code_bits: int,
                              way: str | None = None) -> torch.Tensor:
    """(n_runs,) int32 run values/lengths of one chunk on a CUDA device ->
    int32[1, 5] = [sum_lo, sum_hi, count, min, max] over the rows the
    selected runs stand for. Zero runs return the identity row without a
    launch. `way` None takes route(); "warp" or "block" forces that route
    (for measurement). Launches on the current stream and does not
    synchronise."""
    global LAUNCHES
    code = _codes(op, constant, code_bits, way)
    _check_planes(values, lengths, ("values", "lengths"), 1)
    n_runs = values.shape[0]
    if n_runs == 0:
        return identity_row(code_bits, values.device)
    out = torch.empty(1, 5, dtype=_INT32, device=values.device)
    lib = _build.load("scan_compressed")
    err = _build.call_on(values, lib.rle_scan_aggregate_launch,
                         values.data_ptr(), lengths.data_ptr(),
                         out.data_ptr(), n_runs, int(constant), code,
                         code_bits, ROUTES.index(way or route(1, n_runs)),
                         _build.stream_of(values))
    _build.check(lib, err, "rle_scan_aggregate")
    LAUNCHES += 1
    return out


def rle_scan_aggregate_batched_packed(values2: torch.Tensor,
                                      lengths2: torch.Tensor, *,
                                      constant: int, op: str, code_bits: int,
                                      way: str | None = None
                                      ) -> torch.Tensor:
    """(n_chunks, n_runs) int32 run planes on a CUDA device ->
    int32[n_chunks, 5], one row per chunk, all chunks in one launch.
    Ragged chunks are padded with zero-length runs, which select nothing.
    Zero chunks or zero runs return the identity rows without a launch.
    `way` as in rle_scan_aggregate_packed. Launches on the current stream
    and does not synchronise."""
    global BATCHED_LAUNCHES
    code = _codes(op, constant, code_bits, way)
    _check_planes(values2, lengths2, ("values2", "lengths2"), 2)
    n_chunks, n_runs = values2.shape
    if n_chunks == 0 or n_runs == 0:
        return identity_row(code_bits, values2.device).repeat(n_chunks, 1)
    out = torch.empty(n_chunks, 5, dtype=_INT32, device=values2.device)
    lib = _build.load("scan_compressed")
    err = _build.call_on(values2, lib.rle_scan_aggregate_batched_launch,
                         values2.data_ptr(), lengths2.data_ptr(),
                         out.data_ptr(), n_chunks, n_runs, int(constant),
                         code, code_bits,
                         ROUTES.index(way or route(n_chunks, n_runs)),
                         _build.stream_of(values2))
    _build.check(lib, err, "rle_scan_aggregate_batched")
    BATCHED_LAUNCHES += 1
    return out
