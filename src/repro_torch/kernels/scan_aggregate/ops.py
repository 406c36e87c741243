"""Public fused scan+aggregate API, dispatched through
repro_torch.kernels.dispatch (counterpart of
repro/kernels/scan_aggregate/ops.py; the batched entry comes with the
compressed store).

The full predicate set {lt, le, gt, ge, eq, ne} is composed from the
kernel's {ge, eq} primitives plus its in-kernel complement, mirroring
scan_filter's composition rules; the two degenerate compositions (gt at the
payload max, le at or above it) short-circuit to the empty-selection
identity and a plain validity-mask aggregate respectively.
"""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.aggregate import ops as agg_ops
from repro_torch.kernels.aggregate.ref import as_dict, identity
from repro_torch.kernels.scan_aggregate import kernel as K
from repro_torch.kernels.scan_aggregate import ref
from repro_torch.kernels.scan_filter.ref import OPS


def scan_aggregate(pred_words, agg_words, valid_words, constant: int,
                   op: str, code_bits: int, mode=None) -> dict:
    """Fused SELECT agg(agg_col) WHERE pred_col <op> constant over packed
    words of one shared code width ->
    dict(sum_lo, sum_hi, count, min, max); reassemble the exact sum with
    repro_torch.kernels.aggregate.ops.finalize.

    valid_words is the packed delimiter-bit validity mask (bits set only
    for real rows); it cancels tail-of-word padding.
    """
    if op not in OPS:
        raise ValueError(f"unknown predicate op {op!r}; expected one of {OPS}")
    use_kernel = dispatch.resolve(mode, pred_words)
    dispatch.count_launch("scan_aggregate")
    if not use_kernel:
        return ref.scan_aggregate_ref(pred_words, agg_words, valid_words,
                                      constant, op, code_bits)
    if pred_words.numel() == 0:
        return identity(code_bits, pred_words.device)

    vmax = (1 << (code_bits - 1)) - 1
    c = int(constant)
    if op in ("ge", "eq"):
        prim, cc, inv = op, c, False
    elif op == "lt":
        prim, cc, inv = "ge", c, True
    elif op == "ne":
        prim, cc, inv = "eq", c, True
    elif op == "gt":
        if c >= vmax:                 # nothing exceeds the payload max
            return identity(code_bits, pred_words.device)
        prim, cc, inv = "ge", c + 1, False
    else:  # le
        if c >= vmax:                 # everything valid matches
            return agg_ops.aggregate(agg_words, valid_words, code_bits,
                                     mode=mode)
        prim, cc, inv = "ge", c + 1, True
    return as_dict(K.scan_aggregate_packed(
        pred_words, agg_words, valid_words, constant=cc, op=prim,
        invert=inv, code_bits=code_bits)[0])


def _example(rng):
    import numpy as np

    from repro_torch.kernels.scan_filter import ref as scan_ref
    n = 5001                                  # exercises the tail validity
    pw = scan_ref.pack(rng.integers(0, 128, n), 8)
    aw = scan_ref.pack(rng.integers(0, 128, n), 8)
    valid = scan_ref.pack_mask(np.arange(pw.size * 4) < n, 8)
    return tuple(scan_ref.to_torch(x, "cpu") for x in (pw, aw, valid)) \
        + (64, "lt", 8), {}


dispatch.register("scan_aggregate", fn=scan_aggregate,
                  ref=ref.scan_aggregate_ref, example=_example)
