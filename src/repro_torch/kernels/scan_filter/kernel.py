"""ctypes wrapper of the CUDA BitWeaving-H scan (csrc/scan_filter.cu).

Counterpart of repro/kernels/scan_filter/kernel.py::scan_packed. The
kernel takes the predicate primitive (ge | eq), the constant and the
complement flag at run time; ops.py composes the six predicates from
them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.scan_filter.ref import field_masks

LAUNCHES = 0        # real CUDA launches of this kernel (not op calls)


def packed_constant(constant: int, code_bits: int) -> int:
    """The constant's payload replicated into every field (delimiter bits
    stay 0)."""
    _, _, value = field_masks(code_bits)
    pc = 0
    for i in range(32 // code_bits):
        pc |= (int(constant) & int(value)) << (i * code_bits)
    return pc


def scan_packed(words: torch.Tensor, constant: int, *, op: str,
                code_bits: int, invert: bool = False) -> torch.Tensor:
    """(n_words,) int32 packed codes on a CUDA device -> (n_words,) int32
    packed delimiter-bit mask of `op` (ge | eq) against `constant`,
    complemented within the delimiter bits when `invert`. Launches on the
    current stream and does not synchronise."""
    global LAUNCHES
    if op not in ("ge", "eq"):
        raise ValueError(f"kernel primitive must be 'ge' or 'eq', got {op!r}")
    if code_bits not in (2, 4, 8, 16):
        raise ValueError(f"code_bits={code_bits}; expected 2, 4, 8 or 16")
    _build.check_operand(words, "words")
    out = torch.empty_like(words)
    n = words.shape[0]
    if n == 0:
        return out
    lib = _build.load("scan_filter")
    with torch.cuda.device(words.device):
        err = lib.scan_filter_launch(
            words.data_ptr(), out.data_ptr(), n, code_bits,
            int(op == "eq"), packed_constant(constant, code_bits),
            int(invert), _build.stream_of(words))
    _build.check(lib, err, "scan_filter")
    LAUNCHES += 1
    return out
