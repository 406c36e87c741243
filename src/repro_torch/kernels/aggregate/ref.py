"""Plain PyTorch version of the masked aggregate over packed columns
(counterpart of repro/kernels/aggregate/ref.py).

Aggregates leave every path as the reference's int32 row
[sum_lo, sum_hi, count, min, max] (sum = sum_hi * 65536 + sum_lo, planes
normalized: sum_lo < 2^16), exposed as a dict of 0-d int32 tensors. The
plain version walks the words in slices and combines the partials in
int64, so it is exact at any size a card holds (the reference's jnp
oracle is exact only up to 2^27 codes).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.scan_filter.ref import (SLICE_WORDS, unpack,
                                                 unpack_mask)

FIELDS = ("sum_lo", "sum_hi", "count", "min", "max")


class AggRow(dict):
    """{field: 0-d tensor} views of one (5,) int32 row; `row` keeps the
    row itself so finalize copies it to the host in one piece."""

    def __init__(self, row):
        super().__init__((f, row[i]) for i, f in enumerate(FIELDS))
        self.row = row


def as_dict(row) -> AggRow:
    """(5,) int32 row -> {field: 0-d tensor}."""
    return AggRow(row)


def split_sum(vals):
    """Exact sum of non-negative int32 codes (< 2^16 each) as normalized
    16-bit planes (lo, hi): sum == hi * 65536 + lo."""
    s = vals.to(torch.int64).sum()
    return (s & 0xFFFF).to(torch.int32), (s >> 16).to(torch.int32)


def identity_row(code_bits: int, device) -> torch.Tensor:
    """The empty-selection aggregate as an int32[1, 5] row: what every
    path returns for zero selected (or zero existing) rows."""
    vmax = (1 << (code_bits - 1)) - 1
    return torch.tensor([[0, 0, 0, vmax, 0]], dtype=torch.int32,
                        device=device)


def identity(code_bits: int, device) -> dict:
    """identity_row as a dict of 0-d tensors."""
    return as_dict(identity_row(code_bits, device)[0])


class Partial:
    """int64 running [sum, count, min, max] over slices, kept on the
    device (no host sync until the row is read)."""

    def __init__(self, code_bits: int, device):
        z = torch.zeros((), dtype=torch.int64, device=device)
        self.vmax = (1 << (code_bits - 1)) - 1
        self.sum, self.count, self.max = z, z.clone(), z.clone()
        self.min = z + self.vmax

    def add(self, words, mask_words, code_bits: int) -> None:
        vals = unpack(words, code_bits).to(torch.int64)
        sel = unpack_mask(mask_words, code_bits)
        self.sum = self.sum + torch.where(sel, vals, 0).sum()
        self.count = self.count + sel.sum()
        self.min = torch.minimum(self.min,
                                 torch.where(sel, vals, self.vmax).min())
        self.max = torch.maximum(self.max, torch.where(sel, vals, 0).max())

    def row(self) -> torch.Tensor:
        """The normalized (5,) int32 row."""
        return torch.stack([self.sum & 0xFFFF, self.sum >> 16, self.count,
                            self.min, self.max]).to(torch.int32)


def aggregate_ref(words, mask_words, code_bits: int) -> dict:
    """dict(sum_lo, sum_hi, count, min, max) over codes whose delimiter
    bit is set in mask_words. Empty selection: sums/count/max 0,
    min=vmax."""
    if words.numel() == 0:
        return identity(code_bits, words.device)
    acc = Partial(code_bits, words.device)
    for lo in range(0, words.shape[0], SLICE_WORDS):
        hi = lo + SLICE_WORDS
        acc.add(words[lo:hi], mask_words[lo:hi], code_bits)
    return as_dict(acc.row())
