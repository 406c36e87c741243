"""Public grouped-aggregation API, dispatched through
repro_torch.kernels.dispatch (counterpart of
repro/kernels/group_aggregate/ops.py).

`group_sum_count[_batched]` is the dense accumulator-plane strategy:
SELECT key, count(*), sum(val) GROUP BY key over int32 code planes, with
the group domain handed in explicitly (an arange when a FOR frame bounds
the key range, the sorted distinct build keys for a hash join).
`rle_group_accumulate[_batched]` is the pre-grouped strategy over RLE run
planes: a run of length n adds n to one group's count and n * value to
its sum. The fallback for high-cardinality keys lives in
repro_torch.query.relational (plain torch, not a kernel).

All paths return int32 `(G, 3)` (or batched `(n_chunks, G, 3)`) planes of
normalized [sum_lo, sum_hi, count] rows; `finalize_grouped` reassembles
exact host ints, including the FOR base fix-up sum += base * count.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.group_aggregate import kernel as K
from repro_torch.kernels.group_aggregate import ref
from repro_torch.kernels.scan_compressed.ops import stack_runs

# dense strategy cutoff: above this many groups chunks take the fallback
DENSE_MAX_GROUPS = 1024

LANES = 128          # the reference's tile width (codes per plane row)


def lift_chunks(chunks) -> torch.Tensor:
    """Ragged per-chunk 1-D code tensors on one device -> one (n_chunks,
    rows, LANES) int32 stack there, each chunk zero-padded to the widest
    (at least one row). One scatter of the concatenated chunks, not one
    copy per chunk; a single chunk that fills whole rows is reshaped
    without a copy."""
    flat = [torch.as_tensor(c, dtype=torch.int32).reshape(-1)
            for c in chunks]
    device = flat[0].device if flat else torch.device("cpu")
    sizes = [int(c.numel()) for c in flat]
    rows = max(max((-(-s // LANES) for s in sizes), default=0), 1)
    if len(flat) == 1 and sizes[0] == rows * LANES:
        return flat[0].reshape(1, rows, LANES)
    out = torch.zeros((len(flat), rows * LANES), dtype=torch.int32,
                      device=device)
    if sum(sizes):
        size_t = torch.tensor(sizes, device=device)
        chunk = torch.repeat_interleave(
            torch.arange(len(flat), device=device), size_t)
        starts = torch.cumsum(size_t, 0) - size_t
        pos = torch.arange(chunk.numel(), device=device) - starts[chunk]
        out[chunk, pos] = torch.cat(flat)
    return out.reshape(len(flat), rows, LANES)


def _keys(group_keys, device) -> torch.Tensor:
    """Sorted group keys as a contiguous int32 tensor on `device`."""
    return torch.as_tensor(group_keys).to(device=device,
                                          dtype=torch.int32).contiguous()


def group_sum_count_batched(keys3, vals3, sel3, group_keys, *, mode=None):
    """Dense grouped aggregate, all chunks in one launch.

    keys3/vals3/sel3: (n_chunks, rows, LANES) int32 code planes (padded
    rows carry sel = 0; values below 2^16); group_keys: sorted (G,) keys.
    Returns int32[n_chunks, G, 3] of normalized [sum_lo, sum_hi, count]
    rows."""
    use_kernel = dispatch.resolve(mode, keys3)
    dispatch.count_launch("group_aggregate")
    gk = _keys(group_keys, keys3.device)
    n_chunks, rows = keys3.shape[0], keys3.shape[1]
    g = gk.shape[0]
    if n_chunks == 0 or rows == 0 or g == 0:
        return torch.zeros((n_chunks, g, 3), dtype=torch.int32,
                           device=keys3.device)
    if not use_kernel:
        return ref.group_sum_count_batched_ref(keys3, vals3, sel3, gk)
    return K.group_sum_count_batched_planes(keys3, vals3, sel3, gk)


def group_sum_count(keys, vals, sel, group_keys, *, mode=None):
    """One-chunk dense grouped aggregate over 1-D int32 code tensors ->
    int32[G, 3]; a thin wrapper over the batched launch."""
    return group_sum_count_batched(
        lift_chunks([keys]), lift_chunks([vals]), lift_chunks([sel]),
        group_keys, mode=mode)[0]


def _canonical(pred):
    return None if pred is None else (str(pred[0]), int(pred[1]),
                                      bool(pred[2]))


def rle_group_accumulate_stacked(values2, lengths2, group_keys, *,
                                 pred=None, mode=None):
    """Pre-grouped accumulation over run planes already stacked by
    `stack_runs` ((n_chunks, n_runs) int32, padding runs of length 0), all
    chunks in one launch: run (v, n) adds n to group v's count and n * v
    to its sum. `pred` is an optional canonical (prim, const, invert)
    triple on the run value. Returns int32[n_chunks, G, 3]."""
    use_kernel = dispatch.resolve(mode, values2)
    dispatch.count_launch("group_aggregate_rle")
    gk = _keys(group_keys, values2.device)
    n_chunks, g = values2.shape[0], gk.shape[0]
    if n_chunks == 0 or g == 0:
        return torch.zeros((n_chunks, g, 3), dtype=torch.int32,
                           device=values2.device)
    pred = _canonical(pred)
    if not use_kernel:
        return ref.rle_group_accumulate_batched_ref(values2, lengths2, gk,
                                                    pred)
    return K.rle_group_accumulate_batched_planes(values2, lengths2, gk,
                                                 pred=pred)


def rle_group_accumulate_batched(run_planes, group_keys, *, pred=None,
                                 mode=None):
    """`rle_group_accumulate_stacked` over a sequence of (values, lengths)
    run-plane pairs, one per chunk (ragged run counts padded with
    zero-length runs, which are inert)."""
    values2, lengths2 = stack_runs(run_planes)
    if not len(run_planes):
        values2 = lengths2 = values2.to(torch.as_tensor(group_keys).device)
    return rle_group_accumulate_stacked(values2, lengths2, group_keys,
                                        pred=pred, mode=mode)


def rle_group_accumulate(values, lengths, group_keys, *, pred=None,
                         mode=None):
    """One chunk of RLE runs -> int32[G, 3]."""
    return rle_group_accumulate_batched([(values, lengths)], group_keys,
                                        pred=pred, mode=mode)[0]


def finalize_grouped(group_keys, plane, base: int = 0):
    """One (G, 3) accumulator plane -> exact host int64 numpy (keys, sums,
    counts) with the FOR base fix-up: the kernel summed deltas, so the
    logical sum is delta_sum + base * count. One host copy each of the
    keys and the plane."""
    p = torch.as_tensor(plane).cpu().numpy().astype(np.int64)
    keys = torch.as_tensor(group_keys).cpu().numpy().astype(np.int64)
    counts = p[:, 2]
    sums = (p[:, 1] << 16) + p[:, 0] + int(base) * counts
    return keys, sums, counts


def _example(rng):
    n_chunks, rows = 3, 1000            # not a multiple of LANES
    keys = rng.integers(0, 7, (n_chunks, rows))
    vals = rng.integers(0, 128, (n_chunks, rows))
    sel = rng.integers(0, 2, (n_chunks, rows))
    gk = torch.arange(7, dtype=torch.int32)
    return ((lift_chunks(list(torch.from_numpy(keys))),
             lift_chunks(list(torch.from_numpy(vals))),
             lift_chunks(list(torch.from_numpy(sel))), gk), {})


dispatch.register("group_aggregate", fn=group_sum_count_batched,
                  ref=ref.group_sum_count_batched_ref, example=_example)
