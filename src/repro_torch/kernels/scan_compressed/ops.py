"""Public scan-over-compressed API, dispatched through
repro_torch.kernels.dispatch (counterpart of
repro/kernels/scan_compressed/ops.py).

`rle_scan_aggregate` is the fused SELECT agg(col) WHERE col <op> const
over one RLE-encoded chunk: runs stream instead of rows. FOR-encoded
chunks need no kernel of their own: a FOR plane is a plain BitWeaving
plane at the delta width, so repro_torch.store.exec runs them through the
scan_filter / aggregate / scan_aggregate families.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.aggregate.ref import as_dict, identity
from repro_torch.kernels.scan_compressed import kernel as K
from repro_torch.kernels.scan_compressed import ref
from repro_torch.kernels.scan_filter.ref import OPS


def _check_op(op: str) -> None:
    if op not in OPS:
        raise ValueError(f"unknown predicate op {op!r}; expected one of "
                         f"{OPS}")


def rle_scan_aggregate(values, lengths, constant: int, op: str,
                       code_bits: int, mode=None) -> dict:
    """Fused predicate + aggregate over one chunk's (n_runs,) int32 run
    planes -> dict(sum_lo, sum_hi, count, min, max); reassemble the exact
    sum with repro_torch.kernels.aggregate.ops.finalize. Zero-length runs
    are inert padding."""
    _check_op(op)
    v = torch.as_tensor(values, dtype=torch.int32)
    n = torch.as_tensor(lengths, dtype=torch.int32)
    use_kernel = dispatch.resolve(mode, v)
    dispatch.count_launch("scan_compressed")
    if not use_kernel:
        return ref.rle_scan_aggregate_ref(v, n, constant, op, code_bits)
    if v.numel() == 0:
        return identity(code_bits, v.device)
    return as_dict(K.rle_scan_aggregate_packed(
        v, n, constant=constant, op=op, code_bits=code_bits)[0])


def stack_runs(planes):
    """A sequence of (values, lengths) run-plane pairs, one per chunk, of
    ragged run counts -> (n_chunks, n_runs) int32 planes, each chunk padded
    to the widest (at least one run) with zero-length runs. One gather over
    the concatenated runs, not one copy per chunk. No pairs give (0, 1)
    host planes."""
    if not len(planes):
        z = torch.zeros((0, 1), dtype=torch.int32)
        return z, z.clone()
    vals = [torch.as_tensor(v, dtype=torch.int32) for v, _ in planes]
    lens = [torch.as_tensor(n, dtype=torch.int32) for _, n in planes]
    dev = vals[0].device
    sizes = [int(v.numel()) for v in vals]
    width = max(max(sizes), 1)
    if all(s == width for s in sizes):
        return torch.stack(vals), torch.stack(lens)
    flat_v, flat_n = torch.cat(vals), torch.cat(lens)
    if flat_v.numel() == 0:
        z = torch.zeros((len(planes), width), dtype=torch.int32, device=dev)
        return z, z.clone()
    starts = torch.tensor([0, *sizes[:-1]], device=dev).cumsum(0)
    size_t = torch.tensor(sizes, device=dev)
    col = torch.arange(width, device=dev)
    real = col[None, :] < size_t[:, None]
    idx = torch.where(real, starts[:, None] + col[None, :], 0)
    return (torch.where(real, flat_v[idx], 0),
            torch.where(real, flat_n[idx], 0))


def rle_scan_aggregate_batched(planes, constant: int, op: str,
                               code_bits: int, mode=None):
    """All RLE chunks of a column in one launch.

    planes: sequence of (values, lengths) run-plane pairs, one per chunk
    (ragged run counts allowed). Returns int32[n_chunks, 5], one
    [sum_lo, sum_hi, count, min, max] row per chunk, each equal to
    `rle_scan_aggregate` on that chunk."""
    return rle_scan_aggregate_stacked(*stack_runs(planes), constant, op,
                                      code_bits, mode=mode)


def rle_scan_aggregate_stacked(values2, lengths2, constant: int, op: str,
                               code_bits: int, mode=None):
    """rle_scan_aggregate_batched over run planes already stacked by
    `stack_runs` ((n_chunks, n_runs) int32, padding runs of length 0)."""
    _check_op(op)
    use_kernel = dispatch.resolve(mode, values2)
    dispatch.count_launch("scan_compressed")
    if not use_kernel:
        return ref.rle_scan_aggregate_batched_ref(values2, lengths2,
                                                  constant, op, code_bits)
    return K.rle_scan_aggregate_batched_packed(
        values2, lengths2, constant=constant, op=op, code_bits=code_bits)


def _example(rng):
    n = 2000
    values = torch.from_numpy(rng.integers(0, 128, n).astype("int32"))
    lengths = torch.from_numpy(rng.integers(1, 9, n).astype("int32"))
    return (values, lengths, 64, "lt", 8), {}


dispatch.register("scan_compressed", fn=rle_scan_aggregate,
                  ref=ref.rle_scan_aggregate_ref, example=_example)
