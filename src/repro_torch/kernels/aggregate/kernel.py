"""ctypes wrapper of the CUDA masked aggregate (csrc/aggregate.cu).

Counterpart of repro/kernels/aggregate/kernel.py::aggregate_packed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.aggregate.ref import identity_row

LAUNCHES = 0        # real CUDA launches of this kernel (not op calls)


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
