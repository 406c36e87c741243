"""Plain PyTorch versions of the grouped aggregates over int32 code planes
(counterpart of repro/kernels/group_aggregate/ref.py).

Both return int32 `(n_chunks, G, 3)` accumulator planes of normalized
[sum_lo, sum_hi, count] rows (sum = sum_hi * 65536 + sum_lo, sum_lo <
2^16), one plane per chunk, reassembled on the host by
`ops.finalize_grouped`.

Codes map to group slots by `torch.searchsorted` over the sorted group
keys; codes that are no key, unselected rows and padding count nowhere.

- Dense: sums are exact in int64, then normalized. The reference stages
  its int32 sums so that they are exact too, so the planes are equal for
  any input the kernels take (values < 2^16).
- RLE: a run (v, n) adds n to group v's count and n * v to its sum. The
  reference forms these in int32 (`l * v` and its segment sum), so a
  chunk whose selected runs sum past 2^31 wraps there; this version takes
  the exact sum modulo 2^32 as an int32 and splits it as the reference
  does (`s & 0xFFFF`, `s >> 16`), matching it on purpose. The store
  never reaches the wrap (65536 rows of payloads < 2^15), and the engine
  reads only the count column of this path (ROADMAP, queue 3).
"""
from __future__ import annotations

import torch

SLICE_ELEMS = 1 << 24     # elements per step of the dense plain version


def slots(codes: torch.Tensor, group_keys: torch.Tensor) -> torch.Tensor:
    """int64 group slot of each code in the sorted (G,) keys; codes that
    are no key map to G."""
    g = group_keys.shape[0]
    gk = group_keys.to(codes.dtype)
    idx = torch.searchsorted(gk, codes)
    hit = gk[idx.clamp(max=g - 1)] == codes
    return torch.where(hit, idx, g)


def _normalize(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """int64 sums and counts -> int32 [..., 3] planes [lo, hi, count]."""
    return torch.stack([s & 0xFFFF, s >> 16, c], dim=-1).to(torch.int32)


def _blocks(n_chunks: int, per_chunk: int):
    """(c0, c1, e0, e1) blocks of at most about SLICE_ELEMS elements over
    an (n_chunks, per_chunk) plane, chunk-major."""
    if per_chunk >= SLICE_ELEMS:
        for c in range(n_chunks):
            for e0 in range(0, per_chunk, SLICE_ELEMS):
                yield c, c + 1, e0, min(e0 + SLICE_ELEMS, per_chunk)
    else:
        step = max(1, SLICE_ELEMS // max(per_chunk, 1))
        for c0 in range(0, n_chunks, step):
            yield c0, min(c0 + step, n_chunks), 0, per_chunk


def group_sum_count_batched_ref(keys3, vals3, sel3,
                                group_keys) -> torch.Tensor:
    """(n_chunks, rows, LANES) int32 key/value/select planes + sorted (G,)
    group keys -> int32 (n_chunks, G, 3). A row counts where sel > 0 and
    its key is a group key; sums are exact int64, then normalized."""
    n_chunks = keys3.shape[0]
    k2 = keys3.reshape(n_chunks, -1)
    v2 = vals3.reshape(n_chunks, -1)
    s2 = sel3.reshape(n_chunks, -1)
    gk = torch.as_tensor(group_keys, device=k2.device)
    g = gk.shape[0]
    acc_s = torch.zeros(n_chunks * (g + 1), dtype=torch.int64,
                        device=k2.device)
    acc_c = torch.zeros_like(acc_s)
    for c0, c1, e0, e1 in _blocks(n_chunks, k2.shape[1]):
        slot = torch.where(s2[c0:c1, e0:e1] > 0,
                           slots(k2[c0:c1, e0:e1], gk), g)
        base = torch.arange(c0, c1, device=k2.device)[:, None] * (g + 1)
        idx = (slot + base).reshape(-1)
        acc_s.index_add_(0, idx, v2[c0:c1, e0:e1].reshape(-1)
                         .to(torch.int64))
        acc_c.index_add_(0, idx, torch.ones_like(idx))
    s = acc_s.view(n_chunks, g + 1)[:, :g]
    c = acc_c.view(n_chunks, g + 1)[:, :g]
    return _normalize(s, c)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (in int64)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def run_live(values2, lengths2, pred) -> torch.Tensor:
    """Runs that count: length > 0 and, with a canonical (prim, const,
    invert) triple, the run value passing it (prim in {ge, eq})."""
    live = lengths2 > 0
    if pred is not None:
        prim, const, invert = pred
        cmp = values2 >= const if prim == "ge" else values2 == const
        live = live & (cmp ^ bool(invert))
    return live


def rle_group_accumulate_batched_ref(values2, lengths2, group_keys,
                                     pred=None) -> torch.Tensor:
    """(n_chunks, n_runs) int32 run values/lengths + sorted (G,) group
    keys -> int32 (n_chunks, G, 3): run (v, n) adds n to group v's count
    and n * v to its sum, both modulo 2^32 as the reference's int32
    sums."""
    n_chunks = values2.shape[0]
    gk = torch.as_tensor(group_keys, device=values2.device)
    g = gk.shape[0]
    slot = torch.where(run_live(values2, lengths2, pred),
                       slots(values2, gk), g)
    idx = (slot + torch.arange(n_chunks, device=values2.device)[:, None]
           * (g + 1)).reshape(-1)
    n = lengths2.to(torch.int64).reshape(-1)
    size = n_chunks * (g + 1)
    s = torch.zeros(size, dtype=torch.int64, device=values2.device) \
        .index_add_(0, idx, n * values2.to(torch.int64).reshape(-1))
    c = torch.zeros_like(s).index_add_(0, idx, n)
    s = _wrap32(s.view(n_chunks, g + 1)[:, :g])
    c = _wrap32(c.view(n_chunks, g + 1)[:, :g])
    return _normalize(s, c)
