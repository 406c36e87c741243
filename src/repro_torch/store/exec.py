"""Query execution over an EncodedTable: scan the compressed bytes
(counterpart of repro/store/exec.py: flat queries, and GroupBy/HashJoin
through `execute_grouped_encoded`, described at its section below).

Default path (`batched=True`): every chunk of a column group executes in
one kernel launch per (column group, encoding), not one per chunk.

- RLE chunks of the single-pred/single-agg-same-column query batch through
  `scan_compressed.rle_scan_aggregate_batched`: all run planes stacked,
  one launch, one (n_chunks, 5) row plane;
- everything else is width-unified: the chunks a query touches group by
  W = max payload width of the involved columns, the narrower side
  repacked to W on the device (a delta payload always fits a wider field),
  and then
  - single-pred/single-agg groups take one batched fused launch
    (`scan_aggregate_batched`) whose per-chunk translated constants ride
    in as data (each FOR chunk subtracts its own base);
  - And/Or trees and multi-aggregate queries take one batched mask per
    leaf (`scan_filter_batched`) and one batched masked aggregate per
    aggregate column: launches scale with plan size, not chunk count.

Each (n_chunks, 5) result plane is copied to the host once and finalized,
base-fixed and accumulated in numpy int64, exactly as the per-chunk loop
(`batched=False`, the parity oracle) does in Python ints. Results equal it
and the plain-format engine bit for bit, whatever the encoding mix, and
every path lands on the same empty-selection identity (count=0, sum=0,
min=vmax, max=0 at the logical width). Chunks sharing a frame (the same
bases) translate the plan once per query.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.aggregate import ops as agg_ops
from repro_torch.kernels.group_aggregate import ops as gops
from repro_torch.kernels.scan_aggregate import ops as fused_ops
from repro_torch.kernels.scan_compressed import ops as rle_ops
from repro_torch.kernels.scan_filter import ops as scan_ops
from repro_torch.kernels.scan_filter.ref import (codes_per_word, pack_bits,
                                                 unpack)
from repro_torch.query import physical, relational
from repro_torch.query.physical import ColumnSlice
from repro_torch.query.plan import And, Or, Plan, Pred, columns_of
from repro_torch.store.encode import Encoding, EncodedTable, pack_rows


def identity_ints(code_bits: int) -> dict:
    """The empty-selection aggregate as exact host ints: the one answer
    every path must agree on."""
    return {"sum": 0, "count": 0, "min": (1 << (code_bits - 1)) - 1,
            "max": 0}


def fixup_base(agg: dict, base: int, code_bits: int) -> dict:
    """Translate a finalized delta-domain aggregate back to code space.

    Exact in Python ints; an empty selection collapses to the logical-width
    identity, so the delta-domain min sentinel never leaks."""
    if agg["count"] == 0:
        return identity_ints(code_bits)
    if base == 0:
        return dict(agg)
    return {"sum": agg["sum"] + base * agg["count"],
            "count": agg["count"],
            "min": agg["min"] + base,
            "max": agg["max"] + base}


def translate_pred(op: str, constant: int, base: int,
                   width: int) -> tuple[str, int]:
    """Rewrite `col <op> constant` into the delta domain of a FOR chunk
    (codes = base + delta, deltas in [0, 2^(width-1)-1]).

    Out-of-range constants clamp to tautologies the kernels already
    short-circuit: `ge 0` matches every valid row, `gt dvmax` matches
    none, so the result is always a plain Pred."""
    dvmax = (1 << (width - 1)) - 1
    c = constant - base
    all_, none = ("ge", 0), ("gt", dvmax)
    if op == "ge":
        o = all_ if c <= 0 else none if c > dvmax else (op, c)
    elif op == "gt":
        o = all_ if c < 0 else none if c >= dvmax else (op, c)
    elif op == "lt":
        o = none if c <= 0 else all_ if c > dvmax else (op, c)
    elif op == "le":
        o = none if c < 0 else all_ if c >= dvmax else (op, c)
    elif op == "eq":
        o = (op, c) if 0 <= c <= dvmax else none
    elif op == "ne":
        o = (op, c) if 0 <= c <= dvmax else all_
    else:
        raise ValueError(f"unknown predicate op {op!r}")
    return o


def translate_plan(plan: Plan, frames: dict[str, tuple[int, int]]) -> Plan:
    """Rewrite every leaf of a plan into its column's delta domain.
    `frames` maps column -> (base, payload width)."""
    if isinstance(plan, Pred):
        base, width = frames[plan.column]
        op, c = translate_pred(plan.op, plan.constant, base, width)
        return Pred(plan.column, op, c)
    if isinstance(plan, And):
        return And.of(*(translate_plan(p, frames) for p in plan.children))
    if isinstance(plan, Or):
        return Or.of(*(translate_plan(p, frames) for p in plan.children))
    raise ValueError(f"unknown plan node {type(plan).__name__!r}")


def pack_codes(vals: torch.Tensor, code_bits: int) -> torch.Tensor:
    """Row codes -> packed words on their device (rows padded to a word
    multiple with zeros); the counterpart of the reference's
    jnp_pack_codes."""
    return pack_rows(vals.to(torch.int32).reshape(1, -1), code_bits)[0]


def _rle_rows_batch(chunks, n_rows: int, device=None) -> torch.Tensor:
    """(g, n_rows) row codes of g RLE chunks of n_rows rows each, decoded
    in one pass (zero-length padding runs emit nothing), on `device` (the
    chunks' by default)."""
    vals = torch.cat([c.values for c in chunks]).to(device=device)
    lens = torch.cat([c.lengths for c in chunks]).to(device=device,
                                                      dtype=torch.int64)
    return torch.repeat_interleave(vals, lens,
                                   output_size=len(chunks) * n_rows) \
        .reshape(len(chunks), n_rows)


def rle_rows(chunk) -> torch.Tensor:
    """Decode an RLE chunk to its row codes on the device (the path for
    plan shapes the run kernel does not cover)."""
    return _rle_rows_batch([chunk], chunk.n_rows)[0]


def column_codes(col) -> torch.Tensor:
    """A column's exact logical codes, (num_rows,) int32 on its device:
    every chunk decoded at once (`_decode_rows`) plus its frame base."""
    if not col.chunks:
        return torch.zeros(0, dtype=torch.int32)
    rows = _decode_rows(col, np.arange(len(col.chunks)), col.chunk_rows)
    base = col.chunk_arrays().base
    if base.any():
        rows += torch.from_numpy(base.astype(np.int32)).to(
            rows.device)[:, None]
    return rows.reshape(-1)[:col.num_rows]


@dataclass(frozen=True)
class _Bound:
    """One chunk of one column, bound for execution: a ColumnSlice plus
    the frame that maps its payload back to logical codes."""
    slice: ColumnSlice
    base: int


def _bind_chunk(col, ci: int) -> _Bound:
    ch = col.chunks[ci]
    if ch.encoding is Encoding.RLE:
        words = pack_codes(rle_rows(ch), ch.code_bits)
        return _Bound(ColumnSlice(words, ch.valid, ch.code_bits), 0)
    return _Bound(ColumnSlice(ch.words, ch.valid, ch.width), ch.base)


def _accumulate(total: dict, part: dict) -> None:
    total["sum"] += part["sum"]
    total["count"] += part["count"]
    total["min"] = min(total["min"], part["min"])
    total["max"] = max(total["max"], part["max"])


def _absorb_rows(total: dict, rows: torch.Tensor, bases,
                 code_bits: int) -> None:
    """Finalize, base-fix and accumulate an (n_chunks, 5) row plane: one
    host copy, then numpy int64 (exact: a chunk's sum is below 2^31 and a
    column's below 2^63). Equals the per-chunk `_accumulate(total,
    fixup_base(finalize(row), base, code_bits))` loop: empty chunks
    contribute the identity, which moves neither min nor max."""
    r = rows.cpu().numpy().astype(np.int64)
    cnt = r[:, 2]
    hit = cnt > 0
    b = np.asarray(bases, np.int64)
    s = (r[:, 1] << 16) + r[:, 0] + b * cnt
    total["sum"] += int(s[hit].sum())
    total["count"] += int(cnt.sum())
    if hit.any():
        total["min"] = min(total["min"], int((r[hit, 3] + b[hit]).min()))
        total["max"] = max(total["max"], int((r[hit, 4] + b[hit]).max()))


def _translate_cached(plan: Plan, frames: dict, cache: dict) -> Plan:
    """Memoized translate_plan: chunks sharing an identical
    (base, width) frame map translate once per query."""
    key = tuple(sorted(frames.items()))
    tp = cache.get(key)
    if tp is None:
        tp = cache[key] = translate_plan(plan, frames)
    return tp


@dataclass(frozen=True)
class _BoundGroup:
    """All of one column's chunks in a width group, bound for one batched
    launch: stacked packed planes at the group width W (each chunk's
    frame base is in the column's chunk_arrays())."""
    words: torch.Tensor         # (n_chunks, n_words) int32 at width W
    valid: torch.Tensor         # (n_chunks, n_words) packed validity


def _valid_rows(n_rows, W: int, n_words: int, device) -> torch.Tensor:
    """(k, n_words) packed validity at width W: row r of chunk k is valid
    when r < n_rows[k]."""
    cpw = codes_per_word(W)
    n_t = torch.tensor(n_rows, device=device)
    sel = torch.arange(n_words * cpw, device=device)[None, :] < n_t[:, None]
    return pack_bits(sel.reshape(-1), W).reshape(len(n_rows), n_words)


def _bind_group(col, cids, W: int) -> _BoundGroup:
    """Bind chunks `cids` of a column at the unified width W, on the
    column's device.

    A chunk narrower than W (a smaller FOR delta width, or RLE decoded to
    logical codes) is repacked; exact, since W is the group's widest width
    and payloads only widen. Chunks of one kind and size move together:
    one stack, unpack or run decode per kind, not per chunk. Ragged chunks
    pad to the widest with zero words whose validity bits are 0."""
    chunks = [col.chunks[ci] for ci in cids]
    dev = col.device
    n_rows = [ch.n_rows for ch in chunks]
    n_words = -(-max(n_rows) // codes_per_word(W))
    words3 = torch.zeros((len(chunks), n_words), dtype=torch.int32,
                         device=dev)
    kinds: dict[tuple, list[int]] = {}
    for j, ch in enumerate(chunks):
        if ch.encoding is Encoding.RLE:
            key = ("rle", ch.n_rows)
        elif ch.width == W:
            key = ("same", int(ch.words.numel()))
        else:
            key = ("repack", ch.width, ch.n_rows)
        kinds.setdefault(key, []).append(j)
    for key, js in kinds.items():
        pos = torch.tensor(js, device=dev)
        if key[0] == "same":
            words3[pos, :key[1]] = torch.stack([chunks[j].words for j in js])
            continue
        if key[0] == "rle":
            codes = _rle_rows_batch([chunks[j] for j in js], key[1])
        else:
            src = torch.stack([chunks[j].words for j in js])
            codes = unpack(src.reshape(-1), key[1]).reshape(
                len(js), -1)[:, :key[2]]
        packed = pack_rows(codes, W)
        words3[pos, :packed.shape[1]] = packed
    return _BoundGroup(words3, _valid_rows(n_rows, W, n_words, dev))


def _bind_group_cached(col, cids: np.ndarray, W: int) -> _BoundGroup:
    """Bound planes are query-independent, so they cache on the column
    (EncodedColumn.cached), keyed by (W, cids)."""
    cids = np.asarray(cids, np.int64)
    return col.cached(("bind", W, cids.tobytes()),
                      lambda: _bind_group(col, cids, W))


def _batched_mask(uplans, inverse, bound, W: int, mode):
    """Packed selection masks for a width group, one batched dispatch per
    plan leaf. `uplans` are the group's distinct translated plans (one per
    frame; they share the tree structure, only leaf constants differ) and
    `inverse[k]` is chunk k's. Mirrors physical.eval_mask: leaf mask AND
    validity, And/Or combined wordwise."""
    def rec(nodes):
        n0 = nodes[0]
        if isinstance(n0, Pred):
            g = bound[n0.column]
            ut = [scan_ops.canonical_pred(nd.op, nd.constant, W)
                  for nd in nodes]
            m = scan_ops.scan_filter_batched(
                g.words, [ut[i] for i in inverse], W, mode=mode)
            return m & g.valid
        subs = [rec([nd.children[k] for nd in nodes])
                for k in range(len(n0.children))]
        combine = torch.bitwise_and if isinstance(n0, And) \
            else torch.bitwise_or
        acc = subs[0]
        for s in subs[1:]:
            acc = combine(acc, s)
        return acc
    return rec(uplans)


def _run_planes_cached(col, cids: np.ndarray):
    """The RLE chunks `cids` of a column stacked into (n_chunks, n_runs)
    run planes, cached on the column like the bound planes."""
    return col.cached(("runs", cids.tobytes()), lambda: rle_ops.stack_runs(
        [(col.chunks[ci].values, col.chunks[ci].lengths) for ci in cids]))


def _execute_batched(plan: Plan, aggregates, table: EncodedTable,
                     mode) -> dict:
    names = sorted(columns_of(plan) | set(aggregates))
    out = {a: identity_ints(table.columns[a].code_bits)
           for a in aggregates}
    if table.n_chunks == 0:
        return out
    fused_rle = (isinstance(plan, Pred) and aggregates == (plan.column,))
    fused = isinstance(plan, Pred) and len(aggregates) == 1

    meta = {n: table.columns[n].chunk_arrays() for n in names}
    live = np.logical_and.reduce([meta[n].n_rows > 0 for n in names])
    # a zero-row chunk is the identity: skipped
    rle = live & meta[plan.column].rle if fused_rle \
        else np.zeros_like(live)
    rest = live & ~rle
    widths = np.maximum.reduce([meta[n].width for n in names])

    rle_cids = np.flatnonzero(rle)
    if rle_cids.size:                 # one launch for every RLE chunk
        col = table.columns[plan.column]
        values2, lengths2 = _run_planes_cached(col, rle_cids)
        res = rle_ops.rle_scan_aggregate_stacked(
            values2, lengths2, plan.constant, plan.op, col.code_bits,
            mode=mode)
        dispatch.record_batch("rle_scan_aggregate", col.code_bits,
                              len(rle_cids))
        _absorb_rows(out[plan.column], res, np.zeros(len(rle_cids)),
                     col.code_bits)

    tcache: dict = {}
    for W in sorted(int(w) for w in np.unique(widths[rest])):
        cids = np.flatnonzero(rest & (widths == W))
        bound = {n: _bind_group_cached(table.columns[n], cids, W)
                 for n in names}
        # (n_chunks, n_names) frame bases: 0 for plain and decoded RLE
        bases = np.stack([meta[n].base[cids] for n in names], axis=1)
        ubases, inverse = np.unique(bases, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        uplans = [_translate_cached(
            plan, {n: (int(b), W) for n, b in zip(names, row)}, tcache)
            for row in ubases]
        if fused:
            pcol, acol = plan.column, aggregates[0]
            ut = [scan_ops.canonical_pred(tp.op, tp.constant, W)
                  for tp in uplans]
            res = fused_ops.scan_aggregate_batched(
                bound[pcol].words, bound[acol].words, bound[pcol].valid,
                [ut[i] for i in inverse], W, mode=mode)
            dispatch.record_batch("scan_aggregate", W, len(cids))
            _absorb_rows(out[acol], res, bases[:, names.index(acol)],
                         table.columns[acol].code_bits)
            continue
        mask3 = _batched_mask(uplans, inverse, bound, W, mode)
        dispatch.record_batch("scan_filter", W, len(cids))
        for acol in aggregates:
            g = bound[acol]
            res = agg_ops.aggregate_batched(g.words, mask3, W, mode=mode)
            dispatch.record_batch("aggregate", W, len(cids))
            _absorb_rows(out[acol], res, bases[:, names.index(acol)],
                         table.columns[acol].code_bits)
    return out


def execute_encoded(plan: Plan, aggregates, table: EncodedTable,
                    mode=None, guard=None, batched: bool = True) -> dict:
    """Run a bound plan over the compressed chunks -> exact host-int
    aggregates, bit-identical to the plain-format engine.

    `batched=True` (default) collapses the per-chunk kernel loop into one
    launch per (column group, encoding); `batched=False` keeps the
    chunk-at-a-time loop as the in-tree parity oracle.

    `guard` (a resilience.ChunkGuard) makes every chunk read verify its
    checksum first: a corrupt chunk is quarantined and repaired from the
    oracle before its bytes reach a kernel, or the query dies with a
    typed ChunkCorruptionError — corrupt payloads never aggregate. All
    checks run before the first kernel launch, in (chunk, column) order.
    A repair installs a new chunk (EncodedColumn.replace_chunk), so the
    planes cached on the column are rebuilt."""
    aggregates = tuple(aggregates)
    names = sorted(columns_of(plan) | set(aggregates))
    if guard is not None:
        guard.check([(n, ci) for ci in range(table.n_chunks) for n in names])
    if batched:
        return _execute_batched(plan, aggregates, table, mode)

    out = {a: identity_ints(table.columns[a].code_bits)
           for a in aggregates}
    fused_rle = (isinstance(plan, Pred) and aggregates == (plan.column,))
    tcache: dict = {}
    for ci in range(table.n_chunks):
        chunks = {n: table.columns[n].chunks[ci] for n in names}
        if fused_rle and chunks[plan.column].encoding is Encoding.RLE:
            ch = chunks[plan.column]
            d = rle_ops.rle_scan_aggregate(ch.values, ch.lengths,
                                           plan.constant, plan.op,
                                           ch.code_bits, mode=mode)
            _accumulate(out[plan.column], agg_ops.finalize(d))
            continue
        bound = {n: _bind_chunk(table.columns[n], ci) for n in names}
        frames = {n: (b.base, b.slice.code_bits)
                  for n, b in bound.items()}
        tplan = _translate_cached(plan, frames, tcache)
        raw = physical.execute(tplan, aggregates,
                               {n: b.slice for n, b in bound.items()},
                               mode=mode)
        for a in aggregates:
            part = fixup_base(agg_ops.finalize(raw[a]), bound[a].base,
                              table.columns[a].code_bits)
            _accumulate(out[a], part)
    return out


# --------------------------------------------------------------------------
# grouped execution (GroupBy / HashJoin over compressed chunks)
# --------------------------------------------------------------------------

def _key_range(col):
    """(vmin, vmax) of a column's non-empty chunks from their encoding
    statistics, or None when every chunk is empty (cached on the column,
    which caches no None: an empty column caches ())."""
    def build():
        stats = [ch.stats for ch in col.chunks if ch.n_rows]
        return (min(s.vmin for s in stats),
                max(s.vmax for s in stats)) if stats else ()
    return col.cached(("key_range",), build) or None


def _grouped_strategy(query, table, names, domain_ok: bool):
    """Pick the group_aggregate strategy per chunk from the chunk metadata:
    the RLE run path when the key chunk is RLE and the query is a
    count-only shape whose predicate the run kernel evaluates, dense
    accumulator planes while the group domain stays under
    DENSE_MAX_GROUPS, the fallback otherwise. Zero-row chunks are skipped
    (the grouped identity). Returns three int64 arrays of chunk indices
    and the key-only predicate."""
    kcol = table.columns[query.key]
    kp = relational.key_only_pred(query, kcol.code_bits)
    rle_ok = (not query.aggs) and kp is not False
    live = np.logical_and.reduce(
        [table.columns[n].chunk_arrays().n_rows > 0 for n in names])
    none = np.zeros(0, np.int64)
    if not domain_ok:
        return none, none, np.flatnonzero(live), kp
    rle = live & kcol.chunk_arrays().rle if rle_ok else np.zeros_like(live)
    return np.flatnonzero(rle), np.flatnonzero(live & ~rle), none, kp


def _decode_rows(col, cids: np.ndarray, n_cols: int,
                 device=None) -> torch.Tensor:
    """(len(cids), n_cols) int32 payloads of chunks `cids` of a column on
    `device` (its own by default; the payloads are copied there, stacked,
    and decoded there), zero past each chunk's rows: RLE runs expanded to
    codes, PLAIN and FOR planes unpacked at their width (FOR deltas,
    without the base). Chunks of one kind and size decode together, one
    unpack or run expansion per kind, not per chunk."""
    chunks = [col.chunks[ci] for ci in cids]
    device = col.device if device is None else device
    out = torch.zeros((len(chunks), n_cols), dtype=torch.int32,
                      device=device)
    kinds: dict[tuple, list[int]] = {}
    for j, ch in enumerate(chunks):
        key = ((ch.n_rows,) if ch.encoding is Encoding.RLE
               else (ch.n_rows, ch.width, int(ch.words.numel())))
        kinds.setdefault(key, []).append(j)
    for key, js in kinds.items():
        n_rows = key[0]
        if len(key) == 1:
            codes = _rle_rows_batch([chunks[j] for j in js], n_rows,
                                    device)
        else:
            src = torch.stack([chunks[j].words for j in js]).to(
                device=device)
            codes = unpack(src.reshape(-1), key[1]).reshape(
                len(js), -1)[:, :n_rows]
        out[torch.tensor(js, device=device), :n_rows] = codes
    return out


def _grouped_planes(query, table, names, cids: np.ndarray):
    """Decode chunks `cids` of every referenced column on the device at
    once -> (logical codes, payloads, selection, frame bases): (k, R)
    tensors with R the widest chunk's rows rounded up to a LANES
    multiple; rows past a chunk's end are unselected (key 0 is a real
    group). Payloads are FOR deltas where logical = payload + base."""
    meta = {n: table.columns[n].chunk_arrays() for n in names}
    dev = table.columns[query.key].device
    rows = meta[query.key].n_rows[cids]
    n_cols = -(-int(rows.max()) // gops.LANES) * gops.LANES
    payload, logical, bases = {}, {}, {}
    for n in names:
        payload[n] = _decode_rows(table.columns[n], cids, n_cols)
        bases[n] = meta[n].base[cids]
        b = torch.from_numpy(bases[n].astype(np.int32)).to(dev)
        logical[n] = payload[n] + b[:, None] if bases[n].any() \
            else payload[n]
    valid = torch.arange(n_cols, device=dev)[None, :] \
        < torch.from_numpy(rows).to(dev)[:, None]
    sel = relational.eval_plan_codes(query.plan(), logical) & valid
    return logical, payload, sel, bases


def execute_grouped_encoded(query, table: EncodedTable, mode=None,
                            guard=None) -> dict:
    """GroupBy/HashJoin over the compressed chunks -> the finalized
    grouped result, bit-identical to relational.execute_grouped_oracle
    on the plain table.

    Batched: all RLE-strategy chunks share one run-kernel launch, all
    dense-strategy chunks one accumulator-plane launch per value column
    (one for a count-only query, over a zero value plane), over key, value
    and select planes decoded on the device for all chunks at once; the
    fallback chunks are grouped on the device together. Each (n_chunks,
    G, 3) result is reduced over its chunks in int64 on the device, each
    chunk's FOR base fix-up applied (the planes are additive), and folded
    into the partial once. `guard` semantics match execute_encoded: every
    referenced (column, chunk) verifies before the first launch, in
    (chunk, column) order."""
    relational.bind_check(query, table.columns)
    names = sorted(columns_of(query.plan()) | set(query.aggregates))
    if guard is not None:
        guard.check([(n, ci) for ci in range(table.n_chunks) for n in names])
    kcol = table.columns[query.key]
    krange = _key_range(kcol)
    if krange is None:
        return relational.empty_result()
    domain = relational.group_domain(query, *krange, device=kcol.device)
    domain_ok = relational.dense_ok(domain) and len(domain) > 0
    rle_cids, dense_cids, fb_cids, kp = _grouped_strategy(
        query, table, names, domain_ok)
    part = relational.new_partial()

    if rle_cids.size:
        values2, lengths2 = _run_planes_cached(kcol, rle_cids)
        pred = None if kp == ("ge", 0, False) else kp
        res = gops.rle_group_accumulate_stacked(values2, lengths2, domain,
                                                pred=pred, mode=mode)
        dispatch.record_batch("rle_group_accumulate", kcol.code_bits,
                              len(rle_cids))
        # normalized [lo, hi, count] planes are additive in int64:
        # (sum hi << 16) + sum lo == sum((hi << 16) + lo), so all RLE
        # chunks (base 0, one domain) absorb as one summed plane
        relational.absorb_plane(part, domain,
                                res.to(torch.int64).sum(0), None,
                                count_source=True)

    if dense_cids.size:
        logical, payload, sel, bases = _grouped_planes(query, table, names,
                                                       dense_cids)
        k = sel.shape[0]
        keys3 = logical[query.key].reshape(k, -1, gops.LANES)
        sel3 = sel.to(torch.int32).reshape(k, -1, gops.LANES)
        for i, name in enumerate(query.aggs if query.aggs else (None,)):
            if name is None:
                vals3 = torch.zeros_like(keys3)
                b = torch.zeros(k, dtype=torch.int64, device=sel.device)
            else:
                vals3 = payload[name].reshape(k, -1, gops.LANES)
                b = torch.from_numpy(bases[name]).to(sel.device)
            res = gops.group_sum_count_batched(keys3, vals3, sel3, domain,
                                               mode=mode)
            dispatch.record_batch("group_sum_count", len(domain), k)
            r = res.to(torch.int64)
            s = ((r[..., 1] << 16) + r[..., 0]
                 + b[:, None] * r[..., 2]).sum(0)
            plane = torch.stack([s & 0xFFFF, s >> 16, r[..., 2].sum(0)], 1)
            relational.absorb_plane(part, domain, plane, name,
                                    count_source=(i == 0))

    if fb_cids.size:
        logical, _, sel, _ = _grouped_planes(query, table, names, fb_cids)
        key = logical[query.key]
        if hasattr(query, "build"):
            sel = sel & torch.isin(key, relational.build_keys(query))
        dispatch.count_launch("group_aggregate_fallback", len(fb_cids))
        relational.absorb_fallback(part, key,
                                   {a: logical[a] for a in query.aggs}, sel)
    return relational.finalize(part)
