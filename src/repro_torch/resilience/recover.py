"""Recovery machinery the injected faults exercise (counterpart of
repro/resilience/recover.py).

Three recoveries, one contract — a query's answer is bit-exact vs the
numpy oracle or the query fails with a *typed* error; nothing in between
(no wrapped, partial, or silently-degraded sums):

- `ChunkGuard`: verify-on-read for the store's checksummed chunks.
  A failed checksum quarantines the chunk and either re-encodes it from
  the oracle replica (the durable capacity-tier copy captured at guard
  construction) or raises `ChunkCorruptionError` when repair is off.
- `execute_degraded`: shard failover. A lost shard's row range is
  re-executed from the capacity-tier copy (the logical table's words,
  on its device) through the same kernel-dispatch operators and merged
  with the surviving shards' partials in exact host ints — aggregates
  decompose exactly over row ranges, so the merged answer equals the
  all-shards combine bit for bit.
  All shards lost raises `DegradedResultError`; a zero-row table
  degrades to the canonical aggregate identity. Over a mesh of ranks
  every rank calls it alike and returns the same answer and recovered
  bytes: the surviving partials are all-gathered; each rank re-executes
  every lost range of a flat query from the capacity-tier copy on the
  host (its dispatch counts stay the reference's), and the lost ranges
  of a grouped query are dealt out over the ranks, whose groups merge
  over the axis.
- `CircuitBreaker`: a repeatedly-faulting fast tier is demoted to
  capacity-tier *service* (PlacementEngine.demoted) — placement state
  (LRU clocks, MEMCACHE frequency counters, ghost bits) keeps evolving
  so the tier rejoins warm when the breaker closes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.query import physical
from repro_torch.store.encode import encode_chunk, verify_chunks
from repro_torch.store.exec import (column_codes, fixup_base, identity_ints,
                                    translate_plan)


class DegradedResultError(RuntimeError):
    """A query could not produce its full, exact answer (shards lost
    beyond recovery, corruption without repair). Raised instead of ever
    returning a partial or wrapped aggregate."""


class ChunkCorruptionError(DegradedResultError):
    """A stored chunk failed its checksum and repair is disabled."""


# --------------------------------------------------------------------------
# circuit breaker: demote a faulting fast tier
# --------------------------------------------------------------------------
class CircuitBreaker:
    """CLOSED -> OPEN after `fail_threshold` consecutive fast-tier faults.

    OPEN serves every read from the capacity tier for `cooldown_s` of
    modeled time, then HALF-OPEN lets one access probe the fast tier —
    a clean read closes the breaker, a fault re-opens it. All times come
    from the engine's clock (VirtualClock under chaos), so breaker
    behavior is deterministic and replayable.
    """

    def __init__(self, fail_threshold: int = 4, cooldown_s: float = 0.05):
        if fail_threshold < 1:
            raise ValueError(f"fail_threshold={fail_threshold} must be "
                             f">= 1")
        if not math.isfinite(cooldown_s) or cooldown_s <= 0:
            raise ValueError(f"cooldown_s={cooldown_s} must be a finite "
                             f"positive duration")
        self.fail_threshold = int(fail_threshold)
        self.cooldown_s = float(cooldown_s)
        self.state = "closed"
        self.consecutive_faults = 0
        self.opened_at: float | None = None
        self.opens = 0

    def allow_fast(self, now: float) -> bool:
        """May the next access be served from the fast tier?"""
        if self.state == "open":
            if now - self.opened_at >= self.cooldown_s:
                self.state = "half-open"
                return True
            return False
        return True

    def record_fault(self, now: float) -> None:
        self.consecutive_faults += 1
        if (self.state == "half-open"
                or self.consecutive_faults >= self.fail_threshold):
            if self.state != "open":
                self.opens += 1
            self.state = "open"
            self.opened_at = now
            self.consecutive_faults = 0

    def record_ok(self, now: float) -> None:
        self.consecutive_faults = 0
        if self.state == "half-open":
            self.state = "closed"

    def summary(self) -> dict:
        return {"state": self.state, "opens": self.opens,
                "fail_threshold": self.fail_threshold,
                "cooldown_s": self.cooldown_s}


# --------------------------------------------------------------------------
# chunk integrity: verify-on-read, quarantine, re-encode from oracle
# --------------------------------------------------------------------------
class ChunkGuard:
    """Checksum verification + repair for a store.EncodedTable.

    The oracle is the exact logical codes of every column, captured at
    construction — i.e. *before* any fault is injected — standing in for
    the durable capacity-tier replica a production system re-reads when
    a fast-tier copy rots. Repair re-encodes the chunk's row range from
    the oracle (selector re-applied, checksum re-sealed) and installs it
    with EncodedColumn.replace_chunk; the caller charges the re-read
    bytes as capacity-tier recovery traffic.

    Verification is the reference's crc32 over host bytes, so on the card
    each check copies the chunks it verifies to the host (one transfer a
    call, `verify_chunks`).
    """

    def __init__(self, table, repair: bool = True):
        if not getattr(table, "columns", None) or \
                not hasattr(table, "chunk_rows"):
            raise ValueError(
                "ChunkGuard needs a repro.store.EncodedTable with at "
                "least one encoded column (checksums live on "
                "EncodedChunk payloads)")
        self.table = table
        self.repair = bool(repair)
        self.oracle = {name: column_codes(col).cpu().numpy().astype(
                           np.uint32)
                       for name, col in table.columns.items()}
        self.quarantined: list[tuple[str, int]] = []
        self.repaired: list[tuple[str, int]] = []
        self.repair_logical_bytes_total = 0

    def chunk_ids(self) -> list[tuple[str, int]]:
        return [(name, ci) for name, col in self.table.columns.items()
                for ci in range(len(col.chunks))]

    def check(self, ids, repair: bool | None = None) -> list:
        """Verify the given (column, chunk-index) ids. Corrupt chunks are
        quarantined and — with repair on — re-encoded from the oracle;
        returns [((column, ci), capacity_bytes_reread)]. With repair off
        the first corrupt chunk raises ChunkCorruptionError: detection
        always happens, silent aggregation never does."""
        do_repair = self.repair if repair is None else bool(repair)
        ids = list(ids)
        ok = verify_chunks([self.table.columns[name].chunks[ci]
                            for name, ci in ids])
        out = []
        for (name, ci), good in zip(ids, ok):
            col = self.table.columns[name]
            ch = col.chunks[ci]
            if good:
                continue
            self.quarantined.append((name, ci))
            if not do_repair:
                raise ChunkCorruptionError(
                    f"chunk ({name!r}, {ci}) failed its checksum "
                    f"(stored {ch.checksum:#010x}, payload "
                    f"{ch.payload_checksum():#010x}) and repair is "
                    f"disabled; refusing to aggregate corrupt bytes")
            lo = ci * col.chunk_rows
            hi = min(lo + col.chunk_rows, col.num_rows)
            col.replace_chunk(ci, encode_chunk(self.oracle[name][lo:hi],
                                               col.code_bits,
                                               device=ch.device))
            nb = col.chunks[ci].logical_nbytes
            self.repaired.append((name, ci))
            self.repair_logical_bytes_total += nb
            out.append(((name, ci), nb))
        return out

    def scrub(self, repair: bool | None = None) -> list:
        """Whole-table integrity pass (background scrubber / tests)."""
        return self.check(self.chunk_ids(), repair=repair)

    def summary(self) -> dict:
        return {"chunks": len(self.chunk_ids()),
                "quarantined": len(self.quarantined),
                "repaired": len(self.repaired),
                "repair_bytes": self.repair_logical_bytes_total}


# --------------------------------------------------------------------------
# degraded-mode sharded execution
# --------------------------------------------------------------------------
def _merge(total: dict, part: dict) -> None:
    total["sum"] += part["sum"]
    total["count"] += part["count"]
    total["min"] = min(total["min"], part["min"])
    total["max"] = max(total["max"], part["max"])


def _lost_ids(n: int, lost) -> list[int]:
    lost = sorted(set(int(i) for i in lost))
    if any(i < 0 or i >= n for i in lost):
        raise ValueError(f"lost shard ids {lost} outside [0, {n})")
    if len(lost) >= n:
        raise DegradedResultError(
            f"all {n} shards lost; no surviving device can re-execute "
            f"the lost row ranges — the query has no exact answer")
    return lost


def _shard_bytes(inner, referenced) -> int:
    """Device-resident bytes one shard holds of the referenced columns:
    what re-executing a lost shard re-streams from the capacity tier."""
    return sum(int(inner.layout[c].words.numel()) * 4 // inner.n_shards
               for c in referenced)


def execute_degraded(table, plan, aggregates, lost, mode=None
                     ) -> tuple[dict, int]:
    """Execute a query with `lost` shard indices unavailable.

    Surviving shards contribute their per-shard partials (the same
    batched kernel launch as the combine, finalized per shard); each lost
    shard's row range is re-executed from the capacity-tier copy (the
    logical table's words, on the card) through the same dispatch
    (kernels 1-3). Returns (aggregates, recovered_bytes) where
    recovered_bytes is the device-resident bytes the re-execution
    re-streamed from the capacity tier. Bit-exact vs the fault-free
    execution by construction: aggregates decompose exactly over row
    ranges.

    Raises DegradedResultError when every shard is lost (there is no
    surviving device to re-execute on); a zero-row table returns the
    canonical aggregate identity on every path.
    """
    aggregates = tuple(aggregates)
    lost = _lost_ids(table.n_shards, lost)
    frames = getattr(table, "frames", None)
    inner = table.inner if frames is not None else table
    # raw-domain plan: the delta view translates predicates into each
    # column's frame; a plain ShardedTable executes the plan as-is
    raw_plan = translate_plan(plan, frames) if frames is not None else plan
    parts = inner.execute_partials(raw_plan, aggregates, mode=mode)
    referenced = inner._referenced(raw_plan, aggregates)
    for i in lost:
        lo, hi = inner.shard_row_range(i)
        if hi <= lo:
            parts[i] = {a: identity_ints(inner.slices[a].code_bits)
                        for a in aggregates}
        else:
            slices = inner.host_shard_slices(i, names=referenced)
            parts[i] = physical.finalize_aggs(physical.execute(
                raw_plan, aggregates, slices, mode=mode))
    recovered_bytes = len(lost) * _shard_bytes(inner, referenced)
    out = {a: identity_ints(inner.slices[a].code_bits)
           for a in aggregates}
    for part in parts:
        for a in aggregates:
            _merge(out[a], part[a])
    if frames is not None:
        out = {a: fixup_base(out[a], frames[a][0],
                             table.store.columns[a].code_bits)
               for a in aggregates}
    return out, recovered_bytes


def execute_grouped_degraded(table, query, lost, mode=None
                             ) -> tuple[dict, int]:
    """GroupBy/HashJoin failover: surviving shards contribute their
    per-shard accumulator planes (execute_grouped_planes, the same kernel
    launch the combine uses), each lost shard's row range is
    re-aggregated from the capacity-tier copy on the card (the fallback's
    int64 histogram over the shard's unpacked codes), and everything
    merges through the associative partial algebra — bit-exact vs the
    fault-free grouped execution by construction. All shards lost raises
    DegradedResultError; domains past the dense cutoff recover via the
    oracle (counted as group_aggregate_fallback launches)."""
    from repro_torch.kernels import dispatch
    from repro_torch.query import relational
    from repro_torch.query.sharded import absorb_shard_planes
    n = table.n_shards
    lost = _lost_ids(n, lost)
    frames = getattr(table, "frames", None)
    inner = table.inner if frames is not None else table
    key = query.key
    kbase = frames[key][0] if frames is not None else 0
    raw_plan = (translate_plan(query.plan(), frames) if frames is not None
                else query.plan())
    referenced = inner._referenced(raw_plan, tuple(query.aggs) + (key,))
    recovered_bytes = len(lost) * _shard_bytes(inner, referenced)
    dmin, dmax = inner.key_code_range(key)
    if dmax < dmin:
        return relational.empty_result(), recovered_bytes
    domain = relational.group_domain(query, kbase + dmin, kbase + dmax,
                                     device=inner.device)
    if len(domain) == 0:
        return relational.empty_result(), recovered_bytes
    bases = ({a: frames[a][0] for a in query.aggs} if frames is not None
             else None)
    if not relational.dense_ok(domain):
        dispatch.count_launch("group_aggregate_fallback", n)
        if inner.ranked:
            return (inner.ranked_oracle(query, raw_plan, key_base=kbase,
                                        bases=bases, lost=lost),
                    recovered_bytes)
        host = table.store.decode_table() if frames is not None \
            else table.table
        return (relational.execute_grouped_oracle(query, host),
                recovered_bytes)
    raw_domain = domain - kbase
    planes = inner.execute_grouped_planes(raw_plan, key, tuple(query.aggs),
                                          raw_domain, mode=mode)
    keep = torch.ones(n, dtype=torch.bool, device=inner.device)
    keep[lost] = False
    kw = {"key_base": kbase, "bases": bases, "keep_keys": domain}
    if inner.ranked:
        me = inner.mesh.coords[inner.axis]
        groups = inner.merge_groups(
            [inner.shard_groups(query, raw_plan, i, **kw)
             for j, i in enumerate(lost) if j % n == me],
            tuple(query.aggs))
        part = relational.absorb_groups(relational.new_partial(), *groups)
    else:
        part = relational.new_partial()
        for i in lost:
            relational.absorb_groups(
                part, *inner.shard_groups(query, raw_plan, i, **kw))
    return (absorb_shard_planes(query, planes, raw_domain, keep=keep,
                                bases=bases, key_base=kbase, part=part),
            recovered_bytes)
