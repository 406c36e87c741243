"""Public masked-aggregate API, dispatched through
repro_torch.kernels.dispatch (counterpart of
repro/kernels/aggregate/ops.py; the batched entry comes with the
compressed store).

Aggregates carry the sum as two normalized 16-bit planes (sum_hi, sum_lo),
as the reference does, so results compare field for field; `finalize`
reassembles the exact Python int on the host.
"""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.aggregate import kernel as K
from repro_torch.kernels.aggregate import ref
from repro_torch.kernels.aggregate.ref import (AggRow, as_dict, identity,
                                               split_sum)

__all__ = ["aggregate", "finalize", "identity", "split_sum",
           "sum_bound_block_rows"]

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
    lo, hi, count, vmin, vmax = d.row.tolist()
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


def _example(rng):
    from repro_torch.kernels.scan_filter import ref as scan_ref
    codes = rng.integers(0, 128, 6000)
    packed = scan_ref.to_torch(scan_ref.pack(codes, 8), "cpu")
    mask = scan_ref.scan_ref(packed, 64, "lt", 8)
    return (packed, mask, 8), {}


dispatch.register("aggregate", fn=aggregate, ref=ref.aggregate_ref,
                  example=_example)
