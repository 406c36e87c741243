"""ctypes wrappers of the CUDA grouped aggregates (csrc/group_aggregate.cu).

Counterparts of repro/kernels/group_aggregate/kernel.py::
group_sum_count_batched_planes (dense GROUP BY over key/value/select
planes) and ::rle_group_accumulate_batched_planes (pre-grouped RLE runs).
The RLE entry runs on one of two routes that `route` picks from the
launch's shape: "warp" (a warp a chunk, eight chunks a block, each warp's
sub-histogram its own) for short chunks, "block" (a 256-thread block a
chunk) for long ones.

At the grouped store's shapes an RLE launch moves kilobytes, so the
wrappers' host work is most of a call: each checks its operands in one
test (and only on a failure runs the full checks that name the fault),
allocates its output with one torch.empty and switches device only when
it must.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0       # real CUDA launches of the dense kernel (not op calls)
RLE_LAUNCHES = 0   # ... of the RLE kernel

MAX_GROUPS = 1024  # group keys the kernels hold in shared memory
ROUTES = ("block", "warp")   # the RLE launch's route code is the index
WAVE_CHUNKS = 1056     # chunks the block route runs at once: 132 SMs x 8
WARP_WAVE_RUNS = 512   # the longest chunk the warp route takes past a wave
WARP_RUNS = 128        # ... within a wave, at G <= WARP_GROUPS
WARP_GROUPS = 8
_PRIMS = ("ge", "eq")
_INT32 = torch.int32


def warp_limit(n_chunks: int, g: int) -> int:
    """The longest chunk the warp route takes in an RLE launch of
    `n_chunks` chunks into G = `g` groups (0: none): 512 runs past one
    wave of the block route (more than 1056 chunks), else 128 runs at G
    <= 8 and none at larger G.

    Device time a launch on the H100 (tools/rle_routes.py; PERF.md §6),
    warp against block: within a wave both routes finish in one, and a
    chunk's latency decides. A warp zeroes 2G words and writes 3G a
    chunk with 32 lanes, so from G = 128 on it is the slower at any run
    count (one chunk of one run: 3.55 against 2.83 µs at G = 128, 9.80
    against 4.44 at G = 1024); at G <= 8 the two tie up to 128 runs at up
    to 132 chunks (within 6%) and the warp wins at 528 and 1056 (2.83
    against 3.39 µs at 1056 chunks of 2 runs). Past a wave the block
    route takes several while the warp route, eight chunks a block,
    takes one: at 4096 chunks the warp wins up to 512 runs at every G
    measured (3.15 against 6.25 µs at 2 runs, G = 8; 7.99 against 10.20
    at 512 runs, G = 128); at 1536 runs it wins by 7% at G = 1, ties at
    G = 8 and loses at G = 128; G = 32 follows G = 128 below 2112 chunks
    (the warp 3-7% slower at up to 132 chunks). Left to the block route
    where the warp is faster: G = 1024 at 1056 chunks (the block 13-30%
    slower up to 512 runs), G = 32 at 1056 chunks (13% at 1-2 runs), and
    past 512 runs at G = 1024 from 2112 chunks on (26-38% at 1536)."""
    if n_chunks > WAVE_CHUNKS:
        return WARP_WAVE_RUNS
    return WARP_RUNS if g <= WARP_GROUPS else 0


def route(n_chunks: int, n_runs: int, g: int) -> str:
    """The route of an RLE launch over `n_chunks` chunks of `n_runs` runs
    each into G = `g` groups: "warp" (a warp a chunk) up to
    warp_limit(n_chunks, g) runs, "block" (a block a chunk) past it."""
    return "warp" if n_runs <= warp_limit(n_chunks, g) else "block"


def _check_operands(planes, names, ndim: int,
                    group_keys: torch.Tensor) -> int:
    """The planes must be contiguous int32 CUDA tensors of `ndim`
    dimensions and one shape, the group keys a contiguous int32 (G,)
    tensor on the same device with 1 <= G <= MAX_GROUPS: one test, and
    only where it fails, the full checks, which name the fault. Returns
    G."""
    first = planes[0]
    index = first.get_device()      # -1 on the CPU
    shape = first.shape
    g = group_keys.shape[0] if group_keys.dim() == 1 else 0
    ok = (index >= 0 and first.dim() == ndim
          and group_keys.get_device() == index
          and group_keys.dtype == _INT32 and group_keys.is_contiguous()
          and 1 <= g <= MAX_GROUPS)
    for p in planes:
        ok = (ok and p.get_device() == index and p.dtype == _INT32
              and p.shape == shape and p.is_contiguous())
    if not ok:
        _build.check_operand(first, names[0], ndim=ndim)
        for p, name in zip(planes[1:], names[1:]):
            _build.check_operand(p, name, like=first, ndim=ndim)
        _build.check_operand(group_keys, "group_keys")
        if group_keys.device != first.device:
            raise ValueError(f"group_keys on {group_keys.device}, planes on "
                             f"{first.device}")
        if not 1 <= g <= MAX_GROUPS:
            raise ValueError(f"{g} group keys; the kernels take 1 to "
                             f"{MAX_GROUPS} (larger domains take the "
                             f"fallback)")
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
    g = _check_operands((keys3, vals3, sel3), ("keys3", "vals3", "sel3"), 3,
                        group_keys)
    n_chunks, rows, lanes = keys3.shape
    per_chunk = rows * lanes
    if per_chunk >= 2**31:
        raise ValueError(f"{per_chunk} rows a chunk; counts are int32")
    out = torch.empty(n_chunks, g, 3, dtype=_INT32, device=keys3.device)
    if n_chunks == 0:
        return out
    if per_chunk == 0:
        return out.zero_()
    scratch = torch.empty(n_chunks, g, 2, dtype=torch.int64,
                          device=keys3.device)
    lib = _build.load("group_aggregate")
    err = _build.call_on(keys3, lib.group_sum_count_launch,
                         keys3.data_ptr(), vals3.data_ptr(), sel3.data_ptr(),
                         group_keys.data_ptr(), scratch.data_ptr(),
                         out.data_ptr(), n_chunks, per_chunk, g,
                         _build.stream_of(keys3))
    _build.check(lib, err, "group_sum_count_batched")
    LAUNCHES += 1
    return out


def rle_group_accumulate_batched_planes(values2: torch.Tensor,
                                        lengths2: torch.Tensor,
                                        group_keys: torch.Tensor, *,
                                        pred=None,
                                        way: str | None = None
                                        ) -> torch.Tensor:
    """(n_chunks, n_runs) int32 run values/lengths + sorted (G,) int32
    group keys on a CUDA device -> int32[n_chunks, G, 3], all chunks in
    one launch. `pred` is None or a canonical (prim in {ge, eq}, const,
    invert) triple on the run value. Sums and counts are taken modulo
    2^32, as the reference's int32 ones. `way` None takes route();
    "warp" or "block" forces that route (for measurement). Launches on
    the current stream and does not synchronise."""
    global RLE_LAUNCHES
    prim, const, invert = ("ge", 0, False) if pred is None else pred
    if prim not in _PRIMS:
        raise ValueError(f"predicate primitive {prim!r}; expected one of "
                         f"{_PRIMS}")
    if not -2**31 <= int(const) < 2**31:
        raise ValueError(f"constant {const} is not an int32")
    if way is not None and way not in ROUTES:
        raise ValueError(f"route {way!r}; expected one of {ROUTES}")
    g = _check_operands((values2, lengths2), ("values2", "lengths2"), 2,
                        group_keys)
    n_chunks, n_runs = values2.shape
    out = torch.empty(n_chunks, g, 3, dtype=_INT32, device=values2.device)
    if n_chunks == 0:
        return out
    if n_runs == 0:
        return out.zero_()
    lib = _build.load("group_aggregate")
    err = _build.call_on(values2, lib.rle_group_accumulate_launch,
                         values2.data_ptr(), lengths2.data_ptr(),
                         group_keys.data_ptr(), out.data_ptr(), n_chunks,
                         n_runs, g, int(pred is not None),
                         _PRIMS.index(prim), int(const), int(bool(invert)),
                         ROUTES.index(way or route(n_chunks, n_runs, g)),
                         _build.stream_of(values2))
    _build.check(lib, err, "rle_group_accumulate_batched")
    RLE_LAUNCHES += 1
    return out
