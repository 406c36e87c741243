"""ctypes wrappers of the CUDA grouped aggregates (csrc/group_aggregate.cu).

Counterparts of repro/kernels/group_aggregate/kernel.py::
group_sum_count_batched_planes (dense GROUP BY over key/value/select
planes) and ::rle_group_accumulate_batched_planes (pre-grouped RLE runs).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0       # real CUDA launches of the dense kernel (not op calls)
RLE_LAUNCHES = 0   # ... of the RLE kernel

MAX_GROUPS = 1024  # group keys the kernels hold in shared memory
_PRIMS = ("ge", "eq")


def _check_keys(group_keys: torch.Tensor, like: torch.Tensor) -> int:
    _build.check_operand(group_keys, "group_keys")
    if group_keys.device != like.device:
        raise ValueError(f"group_keys on {group_keys.device}, planes on "
                         f"{like.device}")
    g = group_keys.shape[0]
    if not 1 <= g <= MAX_GROUPS:
        raise ValueError(f"{g} group keys; the kernels take 1 to "
                         f"{MAX_GROUPS} (larger domains take the fallback)")
    return g


def group_sum_count_batched_planes(keys3: torch.Tensor, vals3: torch.Tensor,
                                   sel3: torch.Tensor,
                                   group_keys: torch.Tensor) -> torch.Tensor:
    """(n_chunks, rows, 128) int32 key/value/select planes + sorted (G,)
    int32 group keys on a CUDA device -> int32[n_chunks, G, 3] of
    normalized [sum_lo, sum_hi, count], all chunks in one launch. Values
    must be below 2^16 (codes or FOR deltas). Launches on the current
    stream and does not synchronise."""
    global LAUNCHES
    _build.check_operand(keys3, "keys3", ndim=3)
    _build.check_operand(vals3, "vals3", like=keys3, ndim=3)
    _build.check_operand(sel3, "sel3", like=keys3, ndim=3)
    g = _check_keys(group_keys, keys3)
    n_chunks = keys3.shape[0]
    per_chunk = keys3.shape[1] * keys3.shape[2]
    if per_chunk >= 2**31:
        raise ValueError(f"{per_chunk} rows a chunk; counts are int32")
    out = torch.empty((n_chunks, g, 3), dtype=torch.int32,
                      device=keys3.device)
    if n_chunks == 0:
        return out
    if per_chunk == 0:
        return out.zero_()
    scratch = torch.empty((n_chunks, g, 2), dtype=torch.int64,
                          device=keys3.device)
    lib = _build.load("group_aggregate")
    with torch.cuda.device(keys3.device):
        err = lib.group_sum_count_launch(
            keys3.data_ptr(), vals3.data_ptr(), sel3.data_ptr(),
            group_keys.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            n_chunks, per_chunk, g, _build.stream_of(keys3))
    _build.check(lib, err, "group_sum_count_batched")
    LAUNCHES += 1
    return out


def rle_group_accumulate_batched_planes(values2: torch.Tensor,
                                        lengths2: torch.Tensor,
                                        group_keys: torch.Tensor, *,
                                        pred=None) -> torch.Tensor:
    """(n_chunks, n_runs) int32 run values/lengths + sorted (G,) int32
    group keys on a CUDA device -> int32[n_chunks, G, 3], all chunks in
    one launch. `pred` is None or a canonical (prim in {ge, eq}, const,
    invert) triple on the run value. Sums and counts are taken modulo
    2^32, as the reference's int32 ones. Launches on the current stream
    and does not synchronise."""
    global RLE_LAUNCHES
    _build.check_operand(values2, "values2", ndim=2)
    _build.check_operand(lengths2, "lengths2", like=values2, ndim=2)
    g = _check_keys(group_keys, values2)
    prim, const, invert = ("ge", 0, False) if pred is None else pred
    if prim not in _PRIMS:
        raise ValueError(f"predicate primitive {prim!r}; expected one of "
                         f"{_PRIMS}")
    if not -2**31 <= int(const) < 2**31:
        raise ValueError(f"constant {const} is not an int32")
    n_chunks, n_runs = values2.shape
    out = torch.empty((n_chunks, g, 3), dtype=torch.int32,
                      device=values2.device)
    if n_chunks == 0:
        return out
    if n_runs == 0:
        return out.zero_()
    lib = _build.load("group_aggregate")
    with torch.cuda.device(values2.device):
        err = lib.rle_group_accumulate_launch(
            values2.data_ptr(), lengths2.data_ptr(), group_keys.data_ptr(),
            out.data_ptr(), n_chunks, n_runs, g, int(pred is not None),
            _PRIMS.index(prim), int(const), int(bool(invert)),
            _build.stream_of(values2))
    _build.check(lib, err, "rle_group_accumulate_batched")
    RLE_LAUNCHES += 1
    return out
