"""Public scan-filter API: all six predicates composed from the kernel's
{ge, eq} primitives and its complement flag, dispatched through
repro_torch.kernels.dispatch (counterpart of
repro/kernels/scan_filter/ops.py; the batched entries come with the
compressed store)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.scan_filter import kernel as K
from repro_torch.kernels.scan_filter import ref
from repro_torch.kernels.scan_filter.ref import OPS, as_int32, field_masks


def scan_filter(words, constant: int, op: str, code_bits: int, mode=None):
    """words: (n_words,) int32 packed codes -> (n_words,) packed mask.

    Composition rules (payload max = 2^(bits-1) - 1):
      lt = ~ge(C);  le = ~ge(C+1), or all if C == max;
      gt = ge(C+1), or none if C == max;  ne = ~eq.
    """
    if op not in OPS:
        raise ValueError(f"unknown predicate op {op!r}; expected one of "
                         f"{OPS}")
    use_kernel = dispatch.resolve(mode, words)
    dispatch.count_launch("scan_filter")
    if not use_kernel:
        return ref.scan_ref(words, constant, op, code_bits)

    delim, _, value = field_masks(code_bits)
    vmax = int(value)
    c = int(constant)

    def run(cc, prim, invert=False):
        return K.scan_packed(words, cc, op=prim, code_bits=code_bits,
                             invert=invert)

    if op == "ge":
        return run(c, "ge")
    if op == "lt":
        return run(c, "ge", invert=True)
    if op == "gt":
        return run(c + 1, "ge") if c < vmax else torch.zeros_like(words)
    if op == "le":
        return (run(c + 1, "ge", invert=True) if c < vmax
                else torch.full_like(words, as_int32(delim)))
    if op == "eq":
        return run(c, "eq")
    return run(c, "eq", invert=True)   # ne


# --------------------------------------------------------------------------
# predicate canonicalisation (shared with the batched paths to come)
# --------------------------------------------------------------------------

def canonical_pred(op: str, constant: int, code_bits: int):
    """Reduce any of the six predicates at any integer constant to the
    kernel-primitive triple (prim in {ge, eq}, constant in [0, vmax],
    invert) with tautologies folded: (ge, 0, False) selects every valid
    row, (ge, 0, True) selects none. Mirrors scan_filter's composition
    rules exactly (payload codes are unsigned, <= vmax)."""
    if op not in OPS:
        raise ValueError(f"unknown predicate op {op!r}; expected one of "
                         f"{OPS}")
    vmax = (1 << (code_bits - 1)) - 1
    c = int(constant)
    all_, none = ("ge", 0, False), ("ge", 0, True)
    if op == "ge":
        return all_ if c <= 0 else (none if c > vmax else ("ge", c, False))
    if op == "gt":
        return all_ if c < 0 else (none if c >= vmax else ("ge", c + 1,
                                                           False))
    if op == "lt":
        return none if c <= 0 else (all_ if c > vmax else ("ge", c, True))
    if op == "le":
        return none if c < 0 else (all_ if c >= vmax else ("ge", c + 1,
                                                           True))
    if op == "eq":
        return none if not 0 <= c <= vmax else ("eq", c, False)
    return all_ if not 0 <= c <= vmax else ("eq", c, True)   # ne


def packed_triples(triples, code_bits: int):
    """Canonical triples -> (consts, flags) int32 numpy planes for a
    batched launch: consts[k] is chunk k's constant replicated into every
    field of a packed word; flags bit0 = eq-primitive, bit1 = invert."""
    n = len(triples)
    consts = np.zeros(n, np.int32)
    flags = np.zeros(n, np.int32)
    for k, (prim, c, inv) in enumerate(triples):
        consts[k] = K.packed_constant(c, code_bits)  # delimiters 0: fits
        flags[k] = (1 if prim == "eq" else 0) | (2 if inv else 0)
    return consts, flags


def _example(rng):
    codes = rng.integers(0, 128, 4096)
    return (ref.to_torch(ref.pack(codes, 8), "cpu"), 64, "lt", 8), {}


dispatch.register("scan_filter", fn=scan_filter, ref=ref.scan_ref,
                  example=_example)
