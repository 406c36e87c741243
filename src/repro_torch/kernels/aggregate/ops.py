"""Public masked-aggregate API, dispatched through
repro_torch.kernels.dispatch (counterpart of
repro/kernels/aggregate/ops.py).

Aggregates carry the sum as two normalized 16-bit planes (sum_hi, sum_lo),
as the reference does, so results compare field for field; `finalize`
reassembles the exact Python int on the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.aggregate import kernel as K
from repro_torch.kernels.aggregate import ref
from repro_torch.kernels.aggregate.ref import (AggRow, as_dict, identity,
                                               identity_row, split_sum)

__all__ = ["aggregate", "aggregate_batched", "finalize",
           "finalize_row", "identity",
           "split_sum", "sum_bound_block_rows", "to3d_words"]

LANES = 128          # the reference's tile width (words per tile row)


def sum_bound_block_rows(code_bits: int) -> int:
    """The reference's tile bound: largest block_rows whose per-tile sum
    partial is int32-exact, block_rows * LANES words * codes/word * vmax
    < 2^31. The CUDA kernels sum in 64 bits and need no such bound."""
    cpw = 32 // code_bits
    vmax = (1 << (code_bits - 1)) - 1
    return max(1, (2**31 - 1) // (LANES * cpw * vmax))


def finalize(d: AggRow) -> dict:
    """Device aggregate dict -> exact host ints, planes reassembled. One
    copy of the 5-field row to the host (which also waits for the
    device)."""
    return finalize_row(d.row.tolist())


def finalize_row(row) -> dict:
    """A host [sum_lo, sum_hi, count, min, max] row -> exact host ints."""
    lo, hi, count, vmin, vmax = row
    return {"sum": (hi << 16) + lo, "count": count, "min": vmin,
            "max": vmax}


def aggregate(words, mask_words, code_bits: int, mode=None) -> dict:
    """words/mask_words: (n_words,) int32 ->
    dict(sum_lo, sum_hi, count, min, max) of 0-d int32 tensors.

    Codes in padded tail words have mask delimiter bits 0 and are ignored.
    """
    use_kernel = dispatch.resolve(mode, words)
    dispatch.count_launch("aggregate")
    if not use_kernel:
        return ref.aggregate_ref(words, mask_words, code_bits)
    return as_dict(K.aggregate_packed(words, mask_words,
                                      code_bits=code_bits)[0])


def to3d_words(words3, lanes: int = LANES):
    """(n_chunks, n_words) packed planes -> (n_chunks, rows, lanes) tiles,
    lane-padded with zero words, which no mask ever selects: the
    reference's TPU tile layout. The port's batched kernels read the
    (n_chunks, n_words) planes as they are; this stays for layout parity."""
    n_chunks, n_words = words3.shape
    pad = (-n_words) % lanes
    return torch.nn.functional.pad(words3, (0, pad)).reshape(
        n_chunks, -1, lanes)


def aggregate_batched(words3, mask3, code_bits: int, mode=None):
    """All chunks of one column in one launch: (n_chunks, n_words) packed
    words + packed masks -> int32[n_chunks, 5], each row equal to the
    per-chunk `aggregate` at that chunk's words/mask. Padded words carry
    zero mask bits."""
    use_kernel = dispatch.resolve(mode, words3)
    dispatch.count_launch("aggregate")
    n_chunks, n_words = words3.shape
    if n_chunks == 0 or n_words == 0:       # empty-selection identities
        return identity_row(code_bits, words3.device).repeat(n_chunks, 1)
    if not use_kernel:
        return ref.aggregate_batched_ref(words3, mask3, code_bits)
    return K.aggregate_batched_packed(words3, mask3, code_bits=code_bits)


def _example(rng):
    from repro_torch.kernels.scan_filter import ref as scan_ref
    codes = rng.integers(0, 128, 6000)
    packed = scan_ref.to_torch(scan_ref.pack(codes, 8), "cpu")
    mask = scan_ref.scan_ref(packed, 64, "lt", 8)
    return (packed, mask, 8), {}


dispatch.register("aggregate", fn=aggregate, ref=ref.aggregate_ref,
                  example=_example)
