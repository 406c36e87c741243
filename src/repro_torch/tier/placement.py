"""Chunk-granular tier placement: memory, cache, or memcache
(counterpart of repro/tier/placement.py).

Bakhshalipour et al. (arXiv 1809.08828) show die-stacked DRAM can serve as
plain *memory* (OS-placed, static), a hardware *cache* (demand promotion,
LRU eviction), or a software *memcache* (frequency-aware admission) — and
that which wins depends on the workload's locality. This module makes the
three designs executable against the query engine's tables:

- a table's packed columns are split into row-aligned *chunks* (the unit
  of placement, see query.physical.referenced_chunk_bytes);
- `PlacementEngine` assigns each chunk to the fast (die-stacked) or
  capacity (DDR) tier under a `TieredBudget`, updating placement on every
  access according to the chosen `Policy`;
- all policy state is host-side numpy (tier assignment, LRU clocks,
  frequency counters, ghost bits): placement decisions never reach the
  kernels, so query *answers* are bit-exact regardless of policy; only
  the latency/energy accounting changes. The loops over chunks and the
  eviction order are the reference's, so the ledgers match it exactly.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any

import numpy as np

from repro_torch.energy.meter import EnergyMeter
from repro_torch.tier.tiers import TieredBudget, TierPair


class Policy(str, enum.Enum):
    STATIC = "static"        # memory-style: pinned once, never moves
    CACHE = "cache"          # hardware-cache-style: LRU promotion/eviction
    MEMCACHE = "memcache"    # software-cache-style: frequency-aware
    #                          admission with a ghost list


@dataclass
class Access:
    """One query's byte split across tiers (the placement engine's answer
    to "how fast was that scan")."""

    fast_bytes: int = 0
    capacity_bytes: int = 0
    n_hit: int = 0           # chunks served from the fast tier
    n_miss: int = 0
    charge: Any = None       # the EnergyMeter line this access opened

    @property
    def total_bytes(self) -> int:
        return self.fast_bytes + self.capacity_bytes

    @property
    def hit_fraction(self) -> float:
        """Byte-weighted fast-tier fraction of this access."""
        t = self.total_bytes
        return self.fast_bytes / t if t else 0.0


class PlacementEngine:
    """Placement of (column, chunk) ids across a fast/capacity TierPair.

    Charging rule (all three policies): a chunk is charged at the tier it
    resided in *when the access arrived* — a promotion triggered by a miss
    does not retroactively discount that miss.
    """

    def __init__(self, chunk_ids: list[tuple[str, int]],
                 chunk_nbytes: list[int], tiers: TierPair, policy: Policy,
                 *, chunk_rows: int, pin_order: list[int] | None = None,
                 age_every: int = 1024, meter: EnergyMeter | None = None):
        if not chunk_ids:
            raise ValueError("placement needs at least one chunk")
        self.ids = list(chunk_ids)
        self.index = {cid: i for i, cid in enumerate(self.ids)}
        self.nbytes = np.asarray(chunk_nbytes, np.int64)
        self.tiers = tiers
        self.policy = Policy(policy)
        self.chunk_rows = int(chunk_rows)
        self.budget = TieredBudget(tiers.fast.capacity)
        n = len(self.ids)
        self.in_fast = np.zeros(n, bool)
        self.last_access = np.zeros(n, np.int64)      # LRU clock per chunk
        self.freq = np.zeros(n, np.int64)             # MEMCACHE counters
        self.ghost = np.zeros(n, bool)                # recently evicted
        self._clock = 0
        self._touches = 0
        self.age_every = int(age_every)
        # cumulative accounting; joules live in the EnergyMeter ledger
        # (per-query/per-tenant lines), not a scalar — a default meter
        # charges memory only (compute_w=0), which keeps energy_j_total
        # exactly what the old scalar accumulated
        self.meter = meter if meter is not None else EnergyMeter(tiers)
        self.fast_bytes_total = 0
        self.capacity_bytes_total = 0
        self.recovery_bytes_total = 0
        self.hits_total = 0
        self.misses_total = 0
        # async prefetch (repro_torch.tier.prefetch): chunks currently
        # streaming capacity -> fast staging buffer, so admission
        # projections count them as fast instead of double-counting a
        # second capacity read;
        # byte counters stay OUT of fast/capacity_bytes_total — hit_rate
        # measures demand traffic, the prefetch ledger measures overlap
        self.inflight: dict[tuple[str, int], int] = {}
        self.prefetch_reserved_bytes = 0
        self.prefetch_streamed_bytes_total = 0
        self.prefetch_wasted_bytes_total = 0
        # circuit-breaker demotion (resilience.CircuitBreaker): while
        # True, every access is *charged* at the capacity tier — the fast
        # copy is not trusted for service — but placement state
        # (residency, LRU clocks, frequency counters, ghost bits) keeps
        # evolving, so the fast tier rejoins warm when the breaker closes
        self.demoted = False
        if self.policy is Policy.STATIC:
            for i in (pin_order if pin_order is not None else range(n)):
                if self.budget.fits(int(self.nbytes[i])):
                    self.budget.alloc(int(self.nbytes[i]))
                    self.in_fast[i] = True

    # --- construction from tables -----------------------------------------
    @classmethod
    def for_table(cls, table, tiers: TierPair, policy: Policy,
                  chunk_rows: int = 4096,
                  hot_columns: tuple[str, ...] = (), **kw
                  ) -> "PlacementEngine":
        """Chunk a Table, a store EncodedTable (its physical bytes) or a
        ShardedTable / ShardedEncodedTable into the placement universe.

        Sharded tables are chunked over their padded (device-resident)
        word arrays, padding included: the same byte totals
        ShardedTable.chunk_bytes reports. `hot_columns` orders STATIC
        pinning (an operator hint: pin these first); other policies
        ignore it.
        """
        from repro_torch.query import physical

        source = (table.slices if hasattr(table, "slices")
                  else table.columns)
        # align on the *source* widths: a sharded (or compressed delta)
        # view may store columns at narrower payload widths than the
        # logical table, and chunk boundaries must be word boundaries in
        # the layout actually placed
        chunk_rows = physical.align_chunk_rows(source, chunk_rows)
        universe = physical.chunk_universe(source, chunk_rows)
        ids = list(universe)
        nbytes = list(universe.values())
        order = None
        if hot_columns:
            rank = {c: r for r, c in enumerate(hot_columns)}
            order = sorted(range(len(ids)),
                           key=lambda i: (rank.get(ids[i][0], len(rank)),
                                          i))
        return cls(ids, nbytes, tiers, policy, chunk_rows=chunk_rows,
                   pin_order=order, **kw)

    # --- inspection -------------------------------------------------------
    @property
    def total_bytes(self) -> int:
        return int(self.nbytes.sum())

    @property
    def resident_fast_fraction(self) -> float:
        """Fraction of the table's bytes currently in the fast tier."""
        return float(self.nbytes[self.in_fast].sum()) / self.total_bytes

    @property
    def hit_rate(self) -> float:
        """Cumulative byte-weighted fast-tier hit rate."""
        t = self.fast_bytes_total + self.capacity_bytes_total
        return self.fast_bytes_total / t if t else 0.0

    @property
    def energy_j_total(self) -> float:
        """Memory joules streamed so far — the pre-meter scalar, now the
        exact sum of the ledger's per-tier memory lines."""
        return self.meter.memory_j

    def resident(self, cid: tuple[str, int]) -> bool:
        """Is this chunk's authoritative copy in the fast tier right now?
        (True residency, independent of circuit-breaker demotion.)"""
        i = self.index.get(cid)
        if i is None:
            raise ValueError(
                f"unknown chunk {cid!r}; placement was built with "
                f"chunk_rows={self.chunk_rows} over "
                f"{sorted({c for c, _ in self.ids})}")
        return bool(self.in_fast[i])

    def blended_measured_bps(self, chips: int = 1) -> float:
        """The admission-control rate: harmonic blend of the tier rates at
        the *measured* hit fraction (before any access: at the resident
        fast fraction — exact for STATIC, conservative for cold caches)."""
        t = self.fast_bytes_total + self.capacity_bytes_total
        frac = self.hit_rate if t else self.resident_fast_fraction
        return self.tiers.blended(frac, chips)

    def service_s(self, access: Access, chips: int = 1) -> float:
        """The tiered latency model: each tier's bytes at that tier's
        rate, `chips` shards streaming in parallel."""
        return self.tiers.service_s(access.fast_bytes,
                                    access.capacity_bytes, chips)

    def stats(self, chips: int = 1) -> dict:
        """Cumulative placement accounting; pass the shard count so
        blended_gbps is on the same aggregate scale as the engine's
        measured_gbps."""
        return {
            "policy": self.policy.value,
            "chunks": len(self.ids),
            "chunk_rows": self.chunk_rows,
            "table_bytes": self.total_bytes,
            "fast_capacity_bytes": int(self.budget.fast_capacity),
            "fast_resident_fraction": self.resident_fast_fraction,
            "hit_rate": self.hit_rate,
            "fast_bytes": int(self.fast_bytes_total),
            "capacity_bytes": int(self.capacity_bytes_total),
            "chunk_hits": self.hits_total,
            "chunk_misses": self.misses_total,
            "recovery_bytes": int(self.recovery_bytes_total),
            "demoted": self.demoted,
            "energy_j": self.energy_j_total,
            "blended_gbps": self.blended_measured_bps(chips) / 1e9,
            "prefetch_reserved_bytes": int(self.prefetch_reserved_bytes),
            "prefetch_streamed_bytes":
                int(self.prefetch_streamed_bytes_total),
            "prefetch_wasted_bytes": int(self.prefetch_wasted_bytes_total),
        }

    # --- admission-time projection ----------------------------------------
    def project(self, chunk_bytes: dict[tuple[str, int], int]) -> Access:
        """The byte split this access would see if it arrived now, WITHOUT
        touching placement state — admission estimates must not advance
        LRU clocks, frequency counters, or the energy ledger."""
        acc = Access()
        for cid, b in chunk_bytes.items():
            i = self.index.get(cid)
            if i is None:
                raise ValueError(
                    f"unknown chunk {cid!r}; placement was built with "
                    f"chunk_rows={self.chunk_rows} over "
                    f"{sorted({c for c, _ in self.ids})}")
            if (self.in_fast[i] and not self.demoted) \
                    or cid in self.inflight:
                # a chunk already streaming up through the prefetch buffer
                # is charged as fast at admission: its capacity read is in
                # flight and must not be projected (= charged) twice
                acc.fast_bytes += b
                acc.n_hit += 1
            else:
                acc.capacity_bytes += b
                acc.n_miss += 1
        return acc

    # --- the access path --------------------------------------------------
    def on_access(self, chunk_bytes: dict[tuple[str, int], int], *,
                  qid: int | None = None,
                  tenant: int | None = None, trace=None) -> Access:
        """Charge one query's per-chunk byte counts and update placement.

        `chunk_bytes` comes from query.physical.referenced_chunk_bytes
        with this engine's chunk_rows. Returns the query's byte split;
        cumulative totals feed hit_rate and the blended admission rate,
        and the byte split opens a line on the energy meter (tagged
        qid/tenant for the per-tenant bill).

        `trace` (an obs.trace.QueryTrace) gets one "read" span per chunk,
        emitted from the same hit/miss decision being charged — the traced
        split cannot drift from the billed one. Span times are laid out
        afterwards by the caller (obs.trace.layout_sync/layout_pipeline).
        """
        acc = Access()
        for cid, b in chunk_bytes.items():
            i = self.index.get(cid)
            if i is None:
                raise ValueError(
                    f"unknown chunk {cid!r}; placement was built with "
                    f"chunk_rows={self.chunk_rows} over "
                    f"{sorted({c for c, _ in self.ids})}")
            self._clock += 1
            # charging vs residency split: under circuit-breaker demotion
            # a fast-resident chunk is *charged* at the capacity tier, but
            # policy bookkeeping still sees true residency — ghost bits
            # and frequency counters must not drift while the tier heals
            resident = bool(self.in_fast[i])
            hit = resident and not self.demoted
            if resident:
                self.last_access[i] = self._clock
            if hit:
                acc.fast_bytes += b
                acc.n_hit += 1
            else:
                acc.capacity_bytes += b
                acc.n_miss += 1
            if trace is not None:
                tier = self.tiers.fast if hit else self.tiers.capacity
                trace.read(cid, b, tier="fast" if hit else "capacity",
                           hit=hit, inflight=cid in self.inflight,
                           joules=b * tier.energy_per_byte)
            if self.policy is Policy.CACHE:
                self._cache_touch(i, resident)
            elif self.policy is Policy.MEMCACHE:
                self._memcache_touch(i, resident)
        self.fast_bytes_total += acc.fast_bytes
        self.capacity_bytes_total += acc.capacity_bytes
        self.hits_total += acc.n_hit
        self.misses_total += acc.n_miss
        acc.charge = self.meter.charge(acc.fast_bytes, acc.capacity_bytes,
                                       qid=qid, tenant=tenant)
        return acc

    def charge_recovery(self, fast_bytes: int, capacity_bytes: int, *,
                        qid: int | None = None, tenant: int | None = None):
        """Charge retry / failover / repair traffic: the extra bytes the
        recovery machinery streamed beyond the nominal access. They join
        the cumulative ledger (so the blended admission rate reflects
        fault overhead) and open a kind="recovery" line on the energy
        meter — charged exactly once, the no-double-charge invariant the
        property tests pin down. Returns the meter line."""
        fast_bytes, capacity_bytes = int(fast_bytes), int(capacity_bytes)
        if fast_bytes < 0 or capacity_bytes < 0:
            raise ValueError(f"recovery bytes must be >= 0, got "
                             f"({fast_bytes}, {capacity_bytes})")
        self.fast_bytes_total += fast_bytes
        self.capacity_bytes_total += capacity_bytes
        self.recovery_bytes_total += fast_bytes + capacity_bytes
        return self.meter.charge(fast_bytes, capacity_bytes, qid=qid,
                                 tenant=tenant, kind="recovery")

    # --- async prefetch accounting (repro_torch.tier.prefetch) ------------
    def reserve_prefetch(self, nbytes: int) -> int:
        """Carve a staging buffer for the prefetch pipeline out of the
        fast-tier budget (evicting LRU residents if the tier is full —
        the buffer is real fast-tier capacity, not free space). Returns
        the bytes reserved; raises if the request exceeds the tier."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            raise ValueError(f"prefetch reservation must be > 0, "
                             f"got {nbytes}")
        if nbytes > int(self.budget.fast_capacity):
            raise ValueError(
                f"prefetch reservation {nbytes} exceeds fast tier "
                f"capacity {int(self.budget.fast_capacity)}")
        need = nbytes - int(self.budget.remaining)
        if need > 0:
            self._evict_lru(need)
        self.budget.alloc(nbytes)
        self.prefetch_reserved_bytes += nbytes
        return nbytes

    def release_prefetch(self, nbytes: int) -> None:
        """Return a prefetch reservation to the budget."""
        nbytes = min(int(nbytes), self.prefetch_reserved_bytes)
        self.budget.free(nbytes)
        self.prefetch_reserved_bytes -= nbytes

    def charge_prefetch(self, fast_bytes: int, capacity_bytes: int, *,
                        qid: int | None = None, tenant: int | None = None):
        """Charge prefetch overlap traffic on its own ledger line:
        `fast_bytes` = staged chunks re-read from the fast buffer by the
        scan (the nominal access already charged their capacity stream),
        `capacity_bytes` = streamed-then-cancelled waste. Distinguishable
        from demand traffic (kind="prefetch") and excluded from hit-rate
        totals; returns the meter line, or None for a zero charge."""
        fast_bytes, capacity_bytes = int(fast_bytes), int(capacity_bytes)
        if fast_bytes < 0 or capacity_bytes < 0:
            raise ValueError(f"prefetch bytes must be >= 0, got "
                             f"({fast_bytes}, {capacity_bytes})")
        if fast_bytes == 0 and capacity_bytes == 0:
            return None
        self.prefetch_streamed_bytes_total += fast_bytes
        self.prefetch_wasted_bytes_total += capacity_bytes
        return self.meter.charge(fast_bytes, capacity_bytes, qid=qid,
                                 tenant=tenant, kind="prefetch")

    # --- CACHE: LRU promotion/eviction ------------------------------------
    def _evict_lru(self, need: int, floor_freq: int | None = None) -> bool:
        """Evict coldest fast chunks until `need` bytes are free. With
        `floor_freq`, refuse (and evict nothing) unless every victim is
        strictly colder than that frequency — MEMCACHE's admission test."""
        fast = np.flatnonzero(self.in_fast)
        # victim order: coldest-by-frequency (MEMCACHE) or least-recently
        # used (CACHE), LRU/index tie-breaks keep it deterministic
        order = fast[np.lexsort((fast, self.last_access[fast],
                                 self.freq[fast]))] \
            if floor_freq is not None else fast[np.argsort(
                self.last_access[fast], kind="stable")]
        victims, freed = [], 0
        for v in order:
            if freed >= need:
                break
            if floor_freq is not None and self.freq[v] >= floor_freq:
                return False
            victims.append(v)
            freed += int(self.nbytes[v])
        if freed < need:
            return False
        for v in victims:
            self.in_fast[v] = False
            self.ghost[v] = True
            self.budget.free(int(self.nbytes[v]))
        return True

    def _cache_touch(self, i: int, hit: bool) -> None:
        if hit:
            return
        b = int(self.nbytes[i])
        need = b - int(self.budget.remaining)
        if need > 0 and not self._evict_lru(need):
            return                    # chunk larger than the whole tier
        self.budget.alloc(b)
        self.in_fast[i] = True
        self.last_access[i] = self._clock

    # --- MEMCACHE: frequency-aware admission with a ghost list ------------
    def _memcache_touch(self, i: int, hit: bool) -> None:
        self.freq[i] += 2 if self.ghost[i] else 1   # ghost re-touch bonus
        self.ghost[i] = False
        self._touches += 1
        if self._touches % self.age_every == 0:
            self.freq >>= 1            # periodic aging keeps counters adaptive
        if hit:
            return
        b = int(self.nbytes[i])
        need = b - int(self.budget.remaining)
        if need > 0 and not self._evict_lru(need,
                                            floor_freq=int(self.freq[i])):
            return                     # incumbents are hotter: not admitted
        self.budget.alloc(b)
        self.in_fast[i] = True
        self.last_access[i] = self._clock
