"""ctypes wrappers of the CUDA masked aggregates (csrc/aggregate.cu).

Counterparts of repro/kernels/aggregate/kernel.py::aggregate_packed and
::aggregate_batched_packed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.aggregate.ref import identity_row

LAUNCHES = 0        # real CUDA launches of this kernel (not op calls)
BATCHED_LAUNCHES = 0   # ... of the batched kernel


def aggregate_packed(words: torch.Tensor, mask_words: torch.Tensor, *,
                     code_bits: int) -> torch.Tensor:
    """(n_words,) int32 packed codes + packed delimiter-bit mask on a CUDA
    device -> int32[1, 5] = [sum_lo, sum_hi, count, min, max]. Zero words
    return the identity row without a launch. Launches on the current
    stream and does not synchronise."""
    global LAUNCHES
    if code_bits not in (2, 4, 8, 16):
        raise ValueError(f"code_bits={code_bits}; expected 2, 4, 8 or 16")
    _build.check_operand(words, "words")
    _build.check_operand(mask_words, "mask_words", like=words)
    n = words.shape[0]
    if n == 0:
        return identity_row(code_bits, words.device)
    out = torch.empty((1, 5), dtype=torch.int32, device=words.device)
    scratch = torch.empty(5, dtype=torch.int64, device=words.device)
    lib = _build.load("aggregate")
    with torch.cuda.device(words.device):
        err = lib.aggregate_launch(
            words.data_ptr(), mask_words.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), n, code_bits, _build.stream_of(words))
    _build.check(lib, err, "aggregate")
    LAUNCHES += 1
    return out


def aggregate_batched_packed(words3: torch.Tensor, mask3: torch.Tensor, *,
                             code_bits: int) -> torch.Tensor:
    """(n_chunks, n_words) int32 packed codes + packed delimiter-bit masks
    on a CUDA device -> int32[n_chunks, 5], one [sum_lo, sum_hi, count,
    min, max] row per chunk, all chunks in one launch. Zero chunks or zero
    words return the identity rows without a launch. Launches on the
    current stream and does not synchronise."""
    global BATCHED_LAUNCHES
    if code_bits not in (2, 4, 8, 16):
        raise ValueError(f"code_bits={code_bits}; expected 2, 4, 8 or 16")
    _build.check_operand(words3, "words3", ndim=2)
    _build.check_operand(mask3, "mask3", like=words3, ndim=2)
    n_chunks, n_words = words3.shape
    if n_chunks == 0 or n_words == 0:
        return identity_row(code_bits, words3.device).repeat(n_chunks, 1)
    out = torch.empty((n_chunks, 5), dtype=torch.int32, device=words3.device)
    lib = _build.load("aggregate")
    with torch.cuda.device(words3.device):
        err = lib.aggregate_batched_launch(
            words3.data_ptr(), mask3.data_ptr(), out.data_ptr(), n_chunks,
            n_words, code_bits, _build.stream_of(words3))
    _build.check(lib, err, "aggregate_batched")
    BATCHED_LAUNCHES += 1
    return out
