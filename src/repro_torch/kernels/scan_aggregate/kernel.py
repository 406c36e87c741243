"""ctypes wrappers of the CUDA fused scan+aggregate
(csrc/scan_aggregate.cu).

Counterparts of repro/kernels/scan_aggregate/kernel.py::scan_aggregate_packed
and ::scan_aggregate_batched_packed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.aggregate.ref import identity_row
from repro_torch.kernels.scan_filter.kernel import packed_constant

LAUNCHES = 0        # real CUDA launches of this kernel (not op calls)
BATCHED_LAUNCHES = 0   # ... of the batched kernel


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


def scan_aggregate_batched_packed(consts: torch.Tensor, flags: torch.Tensor,
                                  pred3: torch.Tensor, agg3: torch.Tensor,
                                  valid3: torch.Tensor, *, code_bits: int
                                  ) -> torch.Tensor:
    """All chunks of one (pred, agg) column pair in one launch.

    consts/flags: (n_chunks,) int32 on the device, from
    scan_filter.ops.packed_triples (each chunk's packed constant; flags
    bit0 = eq primitive, bit1 = invert). pred3/agg3/valid3:
    (n_chunks, n_words) int32 packed planes. Returns int32[n_chunks, 5];
    zero chunks or zero words return the identity rows without a launch.
    Launches on the current stream and does not synchronise."""
    global BATCHED_LAUNCHES
    if code_bits not in (2, 4, 8, 16):
        raise ValueError(f"code_bits={code_bits}; expected 2, 4, 8 or 16")
    _build.check_operand(pred3, "pred3", ndim=2)
    _build.check_operand(agg3, "agg3", like=pred3, ndim=2)
    _build.check_operand(valid3, "valid3", like=pred3, ndim=2)
    n_chunks, n_words = pred3.shape
    for t, what in ((consts, "consts"), (flags, "flags")):
        _build.check_operand(t, what)
        if t.shape[0] != n_chunks or t.device != pred3.device:
            raise ValueError(f"{what}: shape {tuple(t.shape)} on {t.device}; "
                             f"expected ({n_chunks},) on {pred3.device}")
    if n_chunks == 0 or n_words == 0:
        return identity_row(code_bits, pred3.device).repeat(n_chunks, 1)
    out = torch.empty((n_chunks, 5), dtype=torch.int32, device=pred3.device)
    lib = _build.load("scan_aggregate")
    with torch.cuda.device(pred3.device):
        err = lib.scan_aggregate_batched_launch(
            consts.data_ptr(), flags.data_ptr(), pred3.data_ptr(),
            agg3.data_ptr(), valid3.data_ptr(), out.data_ptr(), n_chunks,
            n_words, code_bits, _build.stream_of(pred3))
    _build.check(lib, err, "scan_aggregate_batched")
    BATCHED_LAUNCHES += 1
    return out
