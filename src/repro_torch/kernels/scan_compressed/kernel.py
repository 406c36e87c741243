"""ctypes wrappers of the CUDA RLE scan+aggregate (csrc/scan_compressed.cu).

Counterparts of repro/kernels/scan_compressed/kernel.py::
rle_scan_aggregate_packed (one chunk) and ::rle_scan_aggregate_batched_packed
(every chunk in one launch). Both entry points run the same kernel body;
the single-chunk one launches it with one block.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.aggregate.ref import identity_row
from repro_torch.kernels.scan_filter.ref import OPS

LAUNCHES = 0           # real CUDA launches of the single-chunk entry
BATCHED_LAUNCHES = 0   # ... of the batched entry


def _check(op: str, constant: int, code_bits: int) -> None:
    if op not in OPS:
        raise ValueError(f"unknown predicate op {op!r}; expected one of "
                         f"{OPS}")
    if code_bits not in (2, 4, 8, 16):
        raise ValueError(f"code_bits={code_bits}; expected 2, 4, 8 or 16")
    if not -2**31 <= int(constant) < 2**31:
        raise ValueError(f"constant {constant} is not an int32")


def rle_scan_aggregate_packed(values: torch.Tensor, lengths: torch.Tensor,
                              *, constant: int, op: str, code_bits: int
                              ) -> torch.Tensor:
    """(n_runs,) int32 run values/lengths of one chunk on a CUDA device ->
    int32[1, 5] = [sum_lo, sum_hi, count, min, max] over the rows the
    selected runs stand for. Zero runs return the identity row without a
    launch. Launches on the current stream and does not synchronise."""
    global LAUNCHES
    _check(op, constant, code_bits)
    _build.check_operand(values, "values")
    _build.check_operand(lengths, "lengths", like=values)
    n_runs = values.shape[0]
    if n_runs == 0:
        return identity_row(code_bits, values.device)
    out = torch.empty((1, 5), dtype=torch.int32, device=values.device)
    lib = _build.load("scan_compressed")
    with torch.cuda.device(values.device):
        err = lib.rle_scan_aggregate_launch(
            values.data_ptr(), lengths.data_ptr(), out.data_ptr(), n_runs,
            int(constant), OPS.index(op), code_bits,
            _build.stream_of(values))
    _build.check(lib, err, "rle_scan_aggregate")
    LAUNCHES += 1
    return out


def rle_scan_aggregate_batched_packed(values2: torch.Tensor,
                                      lengths2: torch.Tensor, *,
                                      constant: int, op: str, code_bits: int
                                      ) -> torch.Tensor:
    """(n_chunks, n_runs) int32 run planes on a CUDA device ->
    int32[n_chunks, 5], one row per chunk, all chunks in one launch.
    Ragged chunks are padded with zero-length runs, which select nothing.
    Zero chunks or zero runs return the identity rows without a launch.
    Launches on the current stream and does not synchronise."""
    global BATCHED_LAUNCHES
    _check(op, constant, code_bits)
    _build.check_operand(values2, "values2", ndim=2)
    _build.check_operand(lengths2, "lengths2", like=values2, ndim=2)
    n_chunks, n_runs = values2.shape
    if n_chunks == 0 or n_runs == 0:
        return identity_row(code_bits, values2.device).repeat(n_chunks, 1)
    out = torch.empty((n_chunks, 5), dtype=torch.int32,
                      device=values2.device)
    lib = _build.load("scan_compressed")
    with torch.cuda.device(values2.device):
        err = lib.rle_scan_aggregate_batched_launch(
            values2.data_ptr(), lengths2.data_ptr(), out.data_ptr(),
            n_chunks, n_runs, int(constant), OPS.index(op), code_bits,
            _build.stream_of(values2))
    _build.check(lib, err, "rle_scan_aggregate_batched")
    BATCHED_LAUNCHES += 1
    return out
