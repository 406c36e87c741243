"""Plain PyTorch version of the fused scan+aggregate: scan -> valid-mask ->
aggregate, one slice of words at a time (counterpart of
repro/kernels/scan_aggregate/ref.py)."""
from __future__ import annotations

from repro_torch.kernels.aggregate.ref import Partial, as_dict, identity
from repro_torch.kernels.scan_filter.ref import OPS, SLICE_WORDS, scan_slice


def scan_aggregate_ref(pred_words, agg_words, valid_words, constant: int,
                       op: str, code_bits: int) -> dict:
    """Predicate scan over pred_words, validity-masked, aggregated over
    agg_words. valid_words is a packed delimiter-bit mask with bits set only
    for real (non-padding) rows, so tail/shard padding never matches."""
    if op not in OPS:
        raise ValueError(f"unknown predicate op {op!r}; expected one of "
                         f"{OPS}")
    if agg_words.numel() == 0:
        return identity(code_bits, agg_words.device)
    acc = Partial(code_bits, agg_words.device)
    for lo in range(0, agg_words.shape[0], SLICE_WORDS):
        hi = lo + SLICE_WORDS
        mask = scan_slice(pred_words[lo:hi], constant, op, code_bits) \
            & valid_words[lo:hi]
        acc.add(agg_words[lo:hi], mask, code_bits)
    return as_dict(acc.row())
