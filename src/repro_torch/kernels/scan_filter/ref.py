"""Plain PyTorch version of the BitWeaving-H predicate scan, plus the numpy
packers (counterpart of repro/kernels/scan_filter/ref.py).

Layout: `code_bits`-wide codes packed little-endian into 32-bit words, one
delimiter (MSB of each field) kept 0 in the data. codes_per_word =
32 // code_bits. A scan produces a packed mask word per data word with the
delimiter bit of each matching field set.

On the torch side packed words are `torch.int32` bit views of the
reference's uint32 words (`torch.from_numpy(words.view(np.int32))`): torch
has no uint32 shift or subtract on the CPU. int32 `>>` is arithmetic, so
every field shift here is followed by its field mask, which drops the sign
fill. Packing sets bit 31 as the int32 value -2^31, so words fold back
bit-exactly. The torch functions walk the words in slices of SLICE_WORDS,
so a column of 2^28 words is never unpacked whole.
"""
from __future__ import annotations

import numpy as np
import torch

OPS = ("lt", "le", "gt", "ge", "eq", "ne")

SLICE_WORDS = 1 << 22       # words per step of the plain versions


def codes_per_word(code_bits: int) -> int:
    return 32 // code_bits


def field_masks(code_bits: int):
    """(delimiter_mask, low_mask, value_mask) as uint32 scalars."""
    c = codes_per_word(code_bits)
    delim = 0
    low = 0
    for i in range(c):
        delim |= 1 << (i * code_bits + code_bits - 1)
        low |= 1 << (i * code_bits)
    value = (1 << (code_bits - 1)) - 1   # payload bits per field
    return np.uint32(delim), np.uint32(low), np.uint32(value)


def pack(codes, code_bits: int):
    """codes: (N,) ints in [0, 2^(bits-1)) -> packed uint32 words
    (N padded to a multiple of codes_per_word)."""
    codes = np.asarray(codes, np.uint32)
    c = codes_per_word(code_bits)
    n = len(codes)
    pad = (-n) % c
    codes = np.pad(codes, (0, pad))
    codes = codes.reshape(-1, c)
    out = np.zeros(len(codes), np.uint32)
    for i in range(c):
        out |= codes[:, i] << np.uint32(i * code_bits)
    return out


def pack_mask(sel, code_bits: int):
    """Boolean per-code selection -> packed delimiter-bit mask words
    (inverse of unpack_mask; selection padded to a word multiple with
    False). Used to build validity masks that cancel tail/shard padding."""
    sel = np.asarray(sel, bool)
    c = codes_per_word(code_bits)
    pad = (-len(sel)) % c
    sel = np.pad(sel, (0, pad)).reshape(-1, c)
    out = np.zeros(len(sel), np.uint32)
    for i in range(c):
        out |= sel[:, i].astype(np.uint32) << np.uint32(
            i * code_bits + code_bits - 1)
    return out


# --- torch side -------------------------------------------------------------

def as_int32(u32) -> int:
    """A uint32 bit pattern as the int32 scalar with the same bits."""
    u = int(u32) & 0xFFFFFFFF
    return u - (1 << 32) if u >= 1 << 31 else u


def to_torch(words, device) -> torch.Tensor:
    """numpy uint32 words -> a copy as int32 bit views on `device`."""
    w = np.array(words, dtype=np.uint32, copy=True).view(np.int32)
    return torch.from_numpy(w).to(device)


def unpack(words, code_bits: int) -> torch.Tensor:
    """(n_words,) int32 packed words -> (n_words * codes_per_word,) int32
    field values (the whole field, delimiter bit included)."""
    c = codes_per_word(code_bits)
    fmask = (1 << code_bits) - 1
    out = torch.empty((words.shape[0], c), dtype=torch.int32,
                      device=words.device)
    for i in range(c):
        out[:, i] = (words >> (i * code_bits)) & fmask
    return out.reshape(-1)


def unpack_mask(mask_words, code_bits: int) -> torch.Tensor:
    """Packed delimiter-bit mask -> boolean per code."""
    c = codes_per_word(code_bits)
    out = torch.empty((mask_words.shape[0], c), dtype=torch.bool,
                      device=mask_words.device)
    for i in range(c):
        out[:, i] = ((mask_words >> (i * code_bits + code_bits - 1)) & 1) \
            .bool()
    return out.reshape(-1)


def pack_bits(sel, code_bits: int) -> torch.Tensor:
    """(n_words * codes_per_word,) bool -> (n_words,) int32 packed
    delimiter-bit mask (the torch inverse of unpack_mask; rows must already
    fill whole words)."""
    c = codes_per_word(code_bits)
    sel = sel.reshape(-1, c)
    out = torch.zeros(sel.shape[0], dtype=torch.int32, device=sel.device)
    for i in range(c):
        out |= sel[:, i].to(torch.int32) * as_int32(
            1 << (i * code_bits + code_bits - 1))
    return out


def _compare(vals, constant: int, op: str):
    return {"lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
            "eq": torch.eq, "ne": torch.ne}[op](vals, int(constant))


def scan_slice(words, constant: int, op: str, code_bits: int):
    """scan_ref on one slice of words (no slicing of its own)."""
    return pack_bits(_compare(unpack(words, code_bits), constant, op),
                     code_bits)


def scan_ref(words, constant: int, op: str, code_bits: int):
    """Plain version: unpack -> compare -> repack delimiter-bit mask."""
    if op not in OPS:
        raise ValueError(f"unknown predicate op {op!r}; expected one of "
                         f"{OPS}")
    out = torch.empty_like(words)
    for lo in range(0, words.shape[0], SLICE_WORDS):
        hi = lo + SLICE_WORDS
        out[lo:hi] = scan_slice(words[lo:hi], constant, op, code_bits)
    return out
