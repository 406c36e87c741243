"""Async tier prefetch: overlap as the free bandwidth multiplier
(counterpart of repro/tier/prefetch.py; a model on the VirtualClock, no
device work).

Lee et al.'s Simultaneous Multi-Layer Access (PAPERS.md) gets 3D-stacked
bandwidth from *overlapping* layer accesses, not faster pins; this module
is the software analogue for the tier model. Without it every tiered read
is charged synchronously: `service = fast/fast_bw + capacity/cap_bw`,
the plain sum. `PrefetchPipeline` models a double-buffered read pipeline
on the VirtualClock — while chunk *i* scans, chunk *i+1* streams up from
the capacity tier into a staging buffer carved out of the fast tier's
`TieredBudget` — so each stage costs `max(scan_i, stream_i+1)`, not the
sum, and a miss-heavy query's blended bandwidth climbs toward the fast
tier's rate.

The pipeline is a *latency/energy model*, never a correctness layer:
placement state evolves through the same `on_access` path with or
without it, query answers are computed by the kernels either way, and a
stalled or cancelled stream degrades that chunk to the synchronous
capacity read — never a wrong answer. Accounting contract:

- the nominal `on_access` line is untouched (a staged miss still charges
  its capacity stream there, exactly once);
- staged chunks add their fast-buffer scan re-read, and cancelled
  streams add their wasted capacity bytes, on a distinguishable
  `kind="prefetch"` ledger line (`PlacementEngine.charge_prefetch`);
- a *stalled* stream's wasted bytes are returned to the caller
  (`PrefetchPlan.stalled_bytes`) so the chaos harness can fold them into
  its single per-query `kind="recovery"` line — charged once, never
  twice;
- while a chunk streams, it sits in `PlacementEngine.inflight`, so
  `project()` admission estimates count it as fast instead of projecting
  a second capacity read.

Scheduling: hits scan first (their fast-tier scans are the shadow the
first streams hide under), then misses; the first miss always reads
synchronously (pipeline fill), and each further miss is staged only when
the overlap pays under the adjacent-stage model — `b/fast_bw <=
prev_scan` — which guarantees `service_s <= sync_service_s` fault-free.
MEMCACHE admission applies its own bar: a first-touch chunk (no
frequency evidence) is not staged, it requeues on the synchronous path.
A circuit-breaker-demoted fast tier stages nothing, and a stall cancels
the one stream the double buffer had in flight behind it.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.tier.placement import PlacementEngine, Policy


@dataclass(frozen=True)
class PrefetchPlan:
    """One query's modeled read pipeline (pure — placement untouched)."""

    service_s: float             # pipelined read time (max per stage)
    sync_service_s: float        # the no-overlap sum (what it replaces)
    staged_bytes: int            # capacity bytes streamed through buffer
    stalled_bytes: int           # streams that stalled (-> recovery line)
    cancelled_bytes: int         # streams cancelled in flight (wasted)
    staged_cids: tuple = ()      # chunks that streamed (incl. stalled)
    n_staged: int = 0
    n_stalled: int = 0
    n_cancelled: int = 0
    stages: tuple = ()           # the per-chunk _Stage timeline, in scan
    #                              order — obs.trace.layout_pipeline
    #                              replays the same window model onto the
    #                              trace's read spans

    @property
    def used(self) -> bool:
        return self.n_staged > 0

    @property
    def overlap_saved_s(self) -> float:
        return max(0.0, self.sync_service_s - self.service_s)


@dataclass
class _Stage:
    cid: tuple
    nbytes: int
    scan_s: float
    stream_s: float = 0.0
    staged: bool = False
    stalled: bool = False
    cancelled: bool = False


class PrefetchPipeline:
    """Double-buffered capacity->fast streaming for a PlacementEngine.

    `inflight_bytes` bounds the staging buffer; it is charged against the
    fast tier's TieredBudget up front (evicting LRU residents if needed —
    buffer space is real capacity), and a chunk larger than the buffer is
    never staged. `close()` returns the reservation.
    """

    def __init__(self, placement: PlacementEngine, inflight_bytes: int):
        self.pe = placement
        self.inflight_bytes = int(inflight_bytes)
        self.reserved_bytes = placement.reserve_prefetch(
            self.inflight_bytes)
        # cumulative observability
        self.plans_total = 0
        self.staged_total = 0
        self.stalled_total = 0
        self.cancelled_total = 0
        self.saved_s_total = 0.0
        # the pipeline's own byte ledger — maintained independently of the
        # PlacementEngine's prefetch_*_bytes_total so obs.unified_snapshot
        # can cross-check the two sources instead of echoing one of them
        self.streamed_bytes_total = 0
        self.wasted_bytes_total = 0

    def close(self) -> None:
        self.pe.release_prefetch(self.reserved_bytes)
        self.reserved_bytes = 0

    # --- planning ---------------------------------------------------------
    def plan(self, chunk_bytes: dict, *, chips: int = 1,
             stalled=None) -> PrefetchPlan:
        """Model one query's reads. Pure: placement state is untouched, so
        admission estimates may call this freely. `stalled(cid) -> bool`
        injects stream stalls (the chaos harness's seeded draws); a
        stalled stream degrades its chunk to the synchronous capacity
        read and cancels the one stream in flight behind it."""
        pe = self.pe
        fast_bw = pe.tiers.fast.bandwidth * chips
        cap_bw = pe.tiers.capacity.bandwidth * chips
        hits, misses = [], []
        for cid, b in sorted(chunk_bytes.items()):
            i = pe.index.get(cid)
            if i is None:
                raise ValueError(
                    f"unknown chunk {cid!r}; placement was built with "
                    f"chunk_rows={pe.chunk_rows}")
            b = int(b)
            if pe.in_fast[i] and not pe.demoted:
                hits.append(_Stage(cid, b, b / fast_bw))
            else:
                misses.append((cid, i, b))
        sync = (sum(s.nbytes for s in hits) / fast_bw
                + sum(b for _, _, b in misses) / cap_bw)

        stages = list(hits)
        prev_scan = stages[-1].scan_s if stages else 0.0
        first_miss = True
        for cid, i, b in misses:
            stageable = (not pe.demoted
                         and not first_miss
                         and b <= self.inflight_bytes
                         and not (pe.policy is Policy.MEMCACHE
                                  and pe.freq[i] == 0)
                         and b / fast_bw <= prev_scan)
            first_miss = False
            if stageable:
                st = _Stage(cid, b, b / fast_bw, stream_s=b / cap_bw,
                            staged=True)
            else:
                st = _Stage(cid, b, b / cap_bw)
            stages.append(st)
            prev_scan = st.scan_s

        # injected stream stalls: the stalled chunk re-reads synchronously
        # and the one stream the double buffer had in flight behind it is
        # cancelled (requeued on the synchronous path)
        if stalled is not None:
            cancel_next = False
            for st in stages:
                if not st.staged:
                    continue
                if cancel_next:
                    st.cancelled = True
                    cancel_next = False
                elif stalled(st.cid):
                    st.stalled = True
                    cancel_next = True
            for st in stages:
                if st.stalled or st.cancelled:
                    st.scan_s = st.nbytes / cap_bw
                    st.stream_s = 0.0

        service = stages[0].stream_s if stages else 0.0
        for k, st in enumerate(stages):
            nxt = stages[k + 1].stream_s if k + 1 < len(stages) else 0.0
            service += max(st.scan_s, nxt)

        ok = [st for st in stages if st.staged
              and not (st.stalled or st.cancelled)]
        stalled_b = sum(st.nbytes for st in stages if st.stalled)
        cancelled_b = sum(st.nbytes for st in stages if st.cancelled)
        if not ok and not stalled_b and not cancelled_b:
            service = sync               # nothing streamed: plain sync
        return PrefetchPlan(
            service_s=service, sync_service_s=sync,
            staged_bytes=sum(st.nbytes for st in ok),
            stalled_bytes=stalled_b, cancelled_bytes=cancelled_b,
            staged_cids=tuple(st.cid for st in stages if st.staged),
            n_staged=len(ok),
            n_stalled=sum(1 for st in stages if st.stalled),
            n_cancelled=sum(1 for st in stages if st.cancelled),
            stages=tuple(stages))

    # --- execution-window bookkeeping -------------------------------------
    def begin(self, plan: PrefetchPlan, chunk_bytes: dict) -> None:
        """Mark the plan's streams in flight: from here until `finish`,
        admission projections count these chunks as fast (never a second
        capacity read at admission)."""
        for cid in plan.staged_cids:
            self.pe.inflight[cid] = int(chunk_bytes[cid])

    def finish(self, plan: PrefetchPlan, *, qid=None, tenant=None):
        """Close the flight window and charge the overlap's own traffic on
        the kind="prefetch" line: staged chunks' fast-buffer scan re-reads
        plus cancelled-stream waste. Stalled-stream waste is NOT charged
        here — the caller owns it (chaos folds it into its single
        kind="recovery" line). Returns the meter line or None."""
        for cid in plan.staged_cids:
            self.pe.inflight.pop(cid, None)
        self.plans_total += 1
        self.staged_total += plan.n_staged
        self.stalled_total += plan.n_stalled
        self.cancelled_total += plan.n_cancelled
        self.saved_s_total += plan.overlap_saved_s
        self.streamed_bytes_total += int(plan.staged_bytes)
        self.wasted_bytes_total += int(plan.cancelled_bytes)
        return self.pe.charge_prefetch(plan.staged_bytes,
                                       plan.cancelled_bytes,
                                       qid=qid, tenant=tenant)

    def stats(self) -> dict:
        return {
            "inflight_bytes": self.inflight_bytes,
            "reserved_bytes": self.reserved_bytes,
            "plans": self.plans_total,
            "staged_chunks": self.staged_total,
            "stalled_chunks": self.stalled_total,
            "cancelled_chunks": self.cancelled_total,
            "overlap_saved_s": self.saved_s_total,
            "streamed_bytes": int(self.streamed_bytes_total),
            "wasted_bytes": int(self.wasted_bytes_total),
        }
