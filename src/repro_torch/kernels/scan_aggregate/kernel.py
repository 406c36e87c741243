"""ctypes wrapper of the CUDA fused scan+aggregate
(csrc/scan_aggregate.cu).

Counterpart of repro/kernels/scan_aggregate/kernel.py::scan_aggregate_packed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.aggregate.ref import identity_row
from repro_torch.kernels.scan_filter.kernel import packed_constant

LAUNCHES = 0        # real CUDA launches of this kernel (not op calls)


def scan_aggregate_packed(pred_words: torch.Tensor, agg_words: torch.Tensor,
                          valid_words: torch.Tensor, *, constant: int,
                          op: str, invert: bool, code_bits: int
                          ) -> torch.Tensor:
    """(n_words,) int32 packed predicate/aggregate/validity words on a CUDA
    device -> int32[1, 5] = [sum_lo, sum_hi, count, min, max] over the
    aggregate codes whose predicate field satisfies `op` (ge | eq) against
    `constant` (complemented when `invert`) and whose validity bit is set.
    Zero words return the identity row without a launch. Launches on the
    current stream and does not synchronise."""
    global LAUNCHES
    if op not in ("ge", "eq"):
        raise ValueError(f"kernel primitive must be 'ge' or 'eq', got {op!r}")
    if code_bits not in (2, 4, 8, 16):
        raise ValueError(f"code_bits={code_bits}; expected 2, 4, 8 or 16")
    _build.check_operand(pred_words, "pred_words")
    _build.check_operand(agg_words, "agg_words", like=pred_words)
    _build.check_operand(valid_words, "valid_words", like=pred_words)
    n = pred_words.shape[0]
    if n == 0:
        return identity_row(code_bits, pred_words.device)
    out = torch.empty((1, 5), dtype=torch.int32, device=pred_words.device)
    scratch = torch.empty(5, dtype=torch.int64, device=pred_words.device)
    lib = _build.load("scan_aggregate")
    with torch.cuda.device(pred_words.device):
        err = lib.scan_aggregate_launch(
            pred_words.data_ptr(), agg_words.data_ptr(),
            valid_words.data_ptr(), scratch.data_ptr(), out.data_ptr(), n,
            code_bits, int(op == "eq"), packed_constant(constant, code_bits),
            int(invert), _build.stream_of(pred_words))
    _build.check(lib, err, "scan_aggregate")
    LAUNCHES += 1
    return out
