"""Plain PyTorch version of the scan-over-compressed (RLE) fused aggregate
(counterpart of repro/kernels/scan_compressed/ref.py).

The run planes are an exact RLE of a code column: a run of length n with
value v stands for n identical rows. A run selected by the predicate
contributes n to the count, n * v to the sum and v to min/max; zero-length
runs are layout padding and select nothing. Sums are taken in int64; the
store bounds a chunk's sum below 2^31 (65536 rows of payloads < 2^15), so
the normalized 16-bit planes equal the reference's int32 ones.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.aggregate.ref import as_dict, identity, identity_row
from repro_torch.kernels.scan_filter.ref import OPS

_CMP = {"lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
        "eq": torch.eq, "ne": torch.ne}


def rle_scan_aggregate_batched_ref(values2, lengths2, constant: int, op: str,
                                   code_bits: int) -> torch.Tensor:
    """(n_chunks, n_runs) int32 run planes -> int32[n_chunks, 5] of
    [sum_lo, sum_hi, count, min, max] rows, one per chunk."""
    if op not in OPS:
        raise ValueError(f"unknown predicate op {op!r}; expected one of "
                         f"{OPS}")
    n_chunks, n_runs = values2.shape
    if n_chunks == 0 or n_runs == 0:
        return identity_row(code_bits, values2.device).repeat(n_chunks, 1)
    vmax = (1 << (code_bits - 1)) - 1
    v = values2.to(torch.int64)
    n = lengths2.to(torch.int64)
    sel = _CMP[op](values2, int(constant)) & (lengths2 > 0)
    s = torch.where(sel, v * n, 0).sum(1)
    return torch.stack([
        s & 0xFFFF, s >> 16, torch.where(sel, n, 0).sum(1),
        torch.where(sel, v, vmax).amin(1),
        torch.where(sel, v, 0).amax(1)], dim=1).to(torch.int32)


def rle_scan_aggregate_ref(values, lengths, constant: int, op: str,
                           code_bits: int) -> dict:
    """SELECT agg(col) WHERE col <op> constant over one RLE-encoded chunk's
    (n_runs,) planes -> dict(sum_lo, sum_hi, count, min, max)."""
    if op not in OPS:
        raise ValueError(f"unknown predicate op {op!r}; expected one of "
                         f"{OPS}")
    if values.numel() == 0:
        return identity(code_bits, values.device)
    return as_dict(rle_scan_aggregate_batched_ref(
        values[None], lengths[None], constant, op, code_bits)[0])
