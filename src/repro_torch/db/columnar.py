"""Bit-packed in-memory column store on a torch device (counterpart of
repro/db/columnar.py).

Columns hold dictionary-encoded codes bit-packed into 32-bit words
(delimiter MSB per field kept 0 — see kernels/scan_filter), stored as
int32 bit views of the reference's uint32 words. A seed gives the same
words as the reference's `Table.synthetic`, and `table_from_arrays` takes
a reference table's words across bit for bit: this system's state is its
table.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.scan_filter import ref as packref

CODE_BITS = (2, 4, 8, 16)


def _check_code_bits(name: str, code_bits: int) -> None:
    if code_bits not in CODE_BITS:
        raise ValueError(
            f"column {name!r}: code_bits={code_bits} unsupported; must "
            f"be 2, 4, 8, or 16 (fields divide the 32-bit word, and "
            f"exact aggregation needs payloads < 2^16)")


def prefix_valid(n_words: int, n_rows: int, code_bits: int,
                 device) -> torch.Tensor:
    """(n_words,) packed delimiter-bit mask whose first `n_rows` rows are
    set, built on `device`: pack_mask(arange(n_words * cpw) < n_rows)
    without a row plane. Whole words of set rows are the delimiter mask,
    the word holding the last set row is partial, and words past it are
    0."""
    full, part = divmod(n_rows, 32 // code_bits)
    delim, _, _ = packref.field_masks(code_bits)
    valid = torch.zeros(n_words, dtype=torch.int32, device=device)
    valid[:full] = packref.as_int32(delim)
    if part:
        bits = sum(1 << (i * code_bits + code_bits - 1) for i in range(part))
        valid[full] = packref.as_int32(bits)
    return valid


@dataclass
class BitPackedColumn:
    name: str
    code_bits: int
    num_rows: int
    words: torch.Tensor                  # (n_words,) int32 bit views
    dictionary: np.ndarray | None = None   # code -> value (optional)
    _valid: torch.Tensor | None = field(default=None, repr=False,
                                        compare=False)

    @classmethod
    def from_values(cls, name: str, values, code_bits: int,
                    dictionary=None, device=None) -> "BitPackedColumn":
        """Pack codes on the host and place the words on `device` (the
        CUDA device unless the caller passes one)."""
        device = resolve_device(device)
        values = np.asarray(values)
        _check_code_bits(name, code_bits)
        vmax = (1 << (code_bits - 1)) - 1
        if values.min(initial=0) < 0:
            raise ValueError(
                f"column {name!r}: min code {int(values.min())} is "
                f"negative; dictionary codes are unsigned indices")
        if values.max(initial=0) > vmax:
            raise ValueError(
                f"column {name!r}: max code {int(values.max())} exceeds "
                f"the {code_bits}-bit payload max {vmax} (the delimiter "
                f"MSB must stay 0); widen code_bits or re-encode the "
                f"dictionary")
        words = packref.pack(values, code_bits)
        return cls(name, code_bits, len(values),
                   packref.to_torch(words, device),
                   None if dictionary is None else np.asarray(dictionary))

    @property
    def device(self) -> torch.device:
        return self.words.device

    @property
    def valid_words(self) -> torch.Tensor:
        """Packed delimiter-bit mask set only for real rows: cancels the
        pack()-to-a-word-multiple tail padding during query evaluation
        (cached on the column's device, built there). Bit-identical to
        pack_mask(arange(total) < num_rows): whole words of real rows are
        the delimiter mask, the word holding the last row is partial, and
        words past it are 0."""
        if self._valid is None:
            self._valid = prefix_valid(int(self.words.numel()),
                                       self.num_rows, self.code_bits,
                                       self.words.device)
        return self._valid

    @property
    def codes_per_word(self) -> int:
        return 32 // self.code_bits

    @property
    def nbytes(self) -> int:
        return int(self.words.numel()) * 4

    def decode(self) -> np.ndarray:
        vals = packref.unpack(self.words, self.code_bits).cpu().numpy()
        vals = vals[:self.num_rows].astype(np.uint32)
        if self.dictionary is not None:
            return self.dictionary[vals]
        return vals


@dataclass
class Table:
    name: str
    columns: dict[str, BitPackedColumn] = field(default_factory=dict)

    @property
    def num_rows(self) -> int:
        return next(iter(self.columns.values())).num_rows if self.columns else 0

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns.values())

    @property
    def device(self) -> torch.device | None:
        """The device every column lives on (None for no columns)."""
        return (next(iter(self.columns.values())).device if self.columns
                else None)

    def add(self, col: BitPackedColumn) -> "Table":
        if self.columns and col.num_rows != self.num_rows:
            raise ValueError(
                f"column {col.name!r} has {col.num_rows} rows but table "
                f"{self.name!r} has {self.num_rows}; all columns of a "
                f"table share one row count")
        if self.columns and col.device != self.device:
            raise ValueError(
                f"column {col.name!r} lives on {col.device} but table "
                f"{self.name!r} lives on {self.device}")
        self.columns[col.name] = col
        return self

    @classmethod
    def synthetic(cls, name: str, num_rows: int, spec: dict[str, int],
                  seed: int = 0, device=None) -> "Table":
        """spec: column name -> code_bits; values uniform in payload range
        (the reference's numpy RNG path, so a seed gives its words)."""
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        t = cls(name)
        for cname, bits in spec.items():
            vmax = (1 << (bits - 1)) - 1
            vals = rng.integers(0, vmax + 1, num_rows)
            t.add(BitPackedColumn.from_values(cname, vals, bits,
                                              device=device))
        return t


def table_from_arrays(arrays: dict, name: str = "table",
                      device=None) -> Table:
    """Build a Table bit for bit from exported packed columns:
    {column: (uint32 words, code_bits, num_rows, dictionary or None)},
    e.g. `np.asarray(col.words)` of a reference table's columns. The words
    are checked (width, row count, delimiter bits 0) and copied to
    `device` (the CUDA device unless the caller passes one)."""
    device = resolve_device(device)
    t = Table(name)
    for cname, (words, code_bits, num_rows, dictionary) in arrays.items():
        _check_code_bits(cname, code_bits)
        words = np.asarray(words)
        if words.dtype != np.uint32 or words.ndim != 1:
            raise ValueError(
                f"column {cname!r}: words must be a 1-D uint32 array, got "
                f"{words.dtype} of shape {words.shape}")
        cpw = 32 // code_bits
        if not 0 <= num_rows <= words.size * cpw:
            raise ValueError(
                f"column {cname!r}: {num_rows} rows do not fit "
                f"{words.size} words of {cpw} codes")
        delim, _, _ = packref.field_masks(code_bits)
        if np.any(words & delim):
            raise ValueError(
                f"column {cname!r}: delimiter bits set in the packed words; "
                f"payload codes must stay below 2^{code_bits - 1}")
        t.add(BitPackedColumn(
            cname, code_bits, int(num_rows), packref.to_torch(words, device),
            None if dictionary is None else np.asarray(dictionary)))
    return t
