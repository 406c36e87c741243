"""Per-query span trees on the VirtualClock: deterministic query tracing.

Every span is stamped in *modeled* time — the engine's VirtualClock,
never the wall clock — so a traced run is a pure function of (workload,
seed): replaying the same chaos trace twice exports byte-identical JSON
(tests/test_obs.py pins this down).

Span taxonomy (`Span.kind`):

- ``admission``       queue wait, submit -> dispatch
- ``read``            one chunk's nominal tier read (attrs: cid, hit,
                      inflight, staged); bytes on the kind="query" ledger
- ``prefetch_read``   a staged chunk's scan re-read from the fast staging
                      buffer (kind="prefetch" ledger, fast tier)
- ``prefetch_cancel`` a stream cancelled in flight: wasted capacity bytes
                      on the kind="prefetch" ledger
- ``prefetch_stall``  a stalled stream's wasted bytes — folded into the
                      query's single kind="recovery" line by the chaos
                      harness, so the span says ledger="recovery"
- ``stall``           a stalled fast read riding to completion (pure
                      extra seconds, no extra bytes)
- ``retry``           a re-issued fast read after timeout (recovery/fast)
- ``failover``        retry budget exhausted, capacity-tier re-read
                      (recovery/capacity)
- ``repair``          verify-on-read oracle re-read (recovery/capacity)
- ``shard_failover``  lost-shard degraded re-execution (recovery/capacity)
- ``launch``          kernel dispatches this query drove (attrs: family,
                      n), from the engine's scoped metrics delta
- ``launch_batch``    one batched launch group (attrs: family, width,
                      n, n_chunks) — the store executor's width groups
- ``compute``         the busy-time compute term (attrs: chips; joules =
                      compute_w * chips * busy_s, the charge_compute term)
- ``throttle``        power-cap stretch beyond busy time (race-to-idle:
                      no bytes, no joules)

Attribution contract: each span carries the `nbytes` and `joules` it
accounts for and the ledger `kind` those bytes were charged on
("query" | "recovery" | "prefetch"); `obs.audit` proves the span sums
equal the EnergyMeter's ledger lines exactly. Per-span joules are the
per-chunk share `nbytes * energy_per_byte`; the audit recomputes from
byte *sums* through the same `TierPair.energy_components`, so equality
with the ledger is bitwise, not approximate.

The disabled path allocates nothing: `NullTracer.begin_query` returns
the shared `NULL_TRACE` singleton whose methods are no-ops, and the
wire points skip span construction entirely when `trace is None`.
"""
from __future__ import annotations

import math


class Span:
    """One attributed interval (or instant, dur_s=0) of modeled time."""

    __slots__ = ("kind", "t0", "dur_s", "nbytes", "tier", "ledger",
                 "joules", "attrs")

    def __init__(self, kind: str, *, t0: float = 0.0, dur_s: float = 0.0,
                 nbytes: int = 0, tier: str | None = None,
                 ledger: str | None = None, joules: float = 0.0,
                 **attrs):
        self.kind = kind
        self.t0 = float(t0)
        self.dur_s = float(dur_s)
        self.nbytes = int(nbytes)
        self.tier = tier
        self.ledger = ledger
        self.joules = float(joules)
        self.attrs = attrs

    @property
    def t1(self) -> float:
        return self.t0 + self.dur_s

    def as_dict(self) -> dict:
        d = {"kind": self.kind, "t0": self.t0, "dur_s": self.dur_s,
             "nbytes": self.nbytes, "tier": self.tier,
             "ledger": self.ledger, "joules": self.joules}
        d.update(self.attrs)
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.kind!r}, t0={self.t0:.6g}, "
                f"dur={self.dur_s:.6g}, bytes={self.nbytes}, "
                f"ledger={self.ledger})")


class QueryTrace:
    """The span tree of one query (flat list + the root interval)."""

    enabled = True

    def __init__(self, qid: int, *, tenant: int = 0,
                 submitted_at: float = 0.0, deadline: float = math.inf,
                 bytes_expected: int = 0, shape: str = "scan"):
        self.qid = qid
        self.tenant = tenant
        self.submitted_at = submitted_at
        self.deadline = deadline
        self.bytes_expected = int(bytes_expected)
        self.shape = shape        # "scan" | "grouped" | "join" — the query
        #                           shape key trace-diff attribution uses
        self.spans: list[Span] = []
        self.reads: list[Span] = []   # the per-chunk "read" spans, in
        #                               on_access emission order
        self.t_start: float | None = None
        self.t_end: float | None = None
        self.busy_s = 0.0
        self.chips = 1
        self.met: bool | None = None
        self.degraded = False
        self.error: str | None = None

    # --- emission ---------------------------------------------------------
    def begin_run(self, t: float) -> None:
        self.t_start = float(t)
        self.add("admission", t0=self.submitted_at,
                 dur_s=max(t - self.submitted_at, 0.0))

    def add(self, kind: str, **kw) -> Span:
        sp = Span(kind, **kw)
        self.spans.append(sp)
        return sp

    def read(self, cid, nbytes: int, *, tier: str, hit: bool,
             inflight: bool = False, joules: float = 0.0) -> Span:
        """One chunk's nominal tier read. Emitted inside
        PlacementEngine.on_access — the traced hit/miss split is the
        charged one by construction, not a parallel re-derivation. The
        span's time window is filled in afterwards by layout_sync /
        layout_pipeline (on_access knows bytes and tiers, not the
        pipeline's stage windows)."""
        sp = self.add("read", nbytes=nbytes,
                      tier=tier, ledger="query", joules=joules,
                      cid=cid, hit=hit, inflight=inflight)
        self.reads.append(sp)
        return sp

    def compute(self, t0: float, busy_s: float, chips: int,
                joules: float) -> Span:
        self.busy_s = float(busy_s)
        self.chips = int(chips)
        return self.add("compute", t0=t0, dur_s=busy_s, joules=joules,
                        chips=chips)

    def close(self, t: float, *, met: bool, degraded: bool = False,
              error: str | None = None) -> None:
        self.t_end = float(t)
        self.met = bool(met)
        self.degraded = bool(degraded)
        self.error = error

    # --- attribution rollups (the audit's inputs) -------------------------
    def bytes_by_ledger(self) -> dict:
        """(ledger, tier) -> exact int byte sum over this query's spans."""
        out: dict = {}
        for sp in self.spans:
            if sp.ledger is None or sp.nbytes == 0:
                continue
            key = (sp.ledger, sp.tier)
            out[key] = out.get(key, 0) + sp.nbytes
        return out

    def joules_total(self) -> float:
        return sum(sp.joules for sp in self.spans)

    def span_kinds(self) -> dict:
        out: dict = {}
        for sp in self.spans:
            out[sp.kind] = out.get(sp.kind, 0) + 1
        return out


class _NullQueryTrace:
    """The disabled trace: every emission is a no-op, nothing allocates."""

    enabled = False
    spans: tuple = ()
    reads: tuple = ()

    def begin_run(self, t):
        pass

    def add(self, kind, **kw):
        return None

    def read(self, cid, nbytes, *, tier, hit, inflight=False, joules=0.0):
        return None

    def compute(self, t0, busy_s, chips, joules):
        return None

    def close(self, t, *, met, degraded=False, error=None):
        pass


NULL_TRACE = _NullQueryTrace()


class Tracer:
    """Collects one QueryTrace per served query, in service order."""

    enabled = True

    def __init__(self):
        self.queries: list[QueryTrace] = []

    def begin_query(self, qid: int, **kw) -> QueryTrace:
        qt = QueryTrace(qid, **kw)
        self.queries.append(qt)
        return qt

    def clear(self) -> None:
        self.queries.clear()

    def __len__(self) -> int:
        return len(self.queries)

    def summary(self) -> dict:
        kinds: dict = {}
        for qt in self.queries:
            for k, n in qt.span_kinds().items():
                kinds[k] = kinds.get(k, 0) + n
        return {"queries": len(self.queries),
                "spans": sum(len(qt.spans) for qt in self.queries),
                "span_kinds": kinds}


class NullTracer:
    """The allocation-free disabled tracer (the engine's default)."""

    enabled = False
    queries: tuple = ()

    def begin_query(self, qid: int, **kw):
        return NULL_TRACE

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0


# --------------------------------------------------------------------------
# timeline layout: place the read spans the access path emitted
# --------------------------------------------------------------------------

def layout_sync(qt: QueryTrace, t0: float, tiers, chips: int) -> float:
    """Sequential tiered reads: each chunk at its tier's rate, in
    on_access emission order (the synchronous service model). Returns
    the cursor after the last read."""
    t = t0
    fast_bw = tiers.fast.bandwidth * chips
    cap_bw = tiers.capacity.bandwidth * chips
    for sp in qt.reads:
        sp.t0 = t
        sp.dur_s = sp.nbytes / (fast_bw if sp.tier == "fast" else cap_bw)
        t += sp.dur_s
    return t


def layout_pipeline(qt: QueryTrace, t0: float, plan, tiers,
                    chips: int) -> float:
    """Double-buffered reads: mirror PrefetchPipeline.plan's stage model
    (window k = max(scan_k, stream_{k+1})) onto the read spans, and emit
    the pipeline's own spans:

    - a live staged chunk's *read* span is its capacity stream, placed in
      the window it streamed under; its fast-buffer scan re-read becomes
      a ``prefetch_read`` span (kind="prefetch" ledger);
    - a cancelled stream adds ``prefetch_cancel`` (prefetch ledger);
    - a stalled stream adds ``prefetch_stall`` with ledger="recovery" —
      the chaos harness folds exactly those bytes into its single
      recovery line.

    Returns the cursor after the last stage window.
    """
    reads = {sp.attrs["cid"]: sp for sp in qt.reads}
    fast_e = tiers.fast.energy_per_byte
    cap_e = tiers.capacity.energy_per_byte
    stages = plan.stages
    if not stages:
        return layout_sync(qt, t0, tiers, chips)
    t = t0 + stages[0].stream_s          # pipeline fill (0 by scheduling:
    #                                      the first stage never streams)
    for k, st in enumerate(stages):
        nxt = stages[k + 1].stream_s if k + 1 < len(stages) else 0.0
        window = max(st.scan_s, nxt)
        sp = reads.get(st.cid)
        live = st.staged and not (st.stalled or st.cancelled)
        if live:
            if sp is not None:
                # the nominal capacity stream ran under the previous
                # window's scan, ending where this window begins
                sp.t0 = t - st.stream_s
                sp.dur_s = st.stream_s
                sp.attrs["staged"] = True
            qt.add("prefetch_read", t0=t, dur_s=st.scan_s,
                   nbytes=st.nbytes, tier="fast", ledger="prefetch",
                   joules=st.nbytes * fast_e, cid=st.cid)
        else:
            if sp is not None:
                sp.t0 = t
                sp.dur_s = st.scan_s
            if st.stalled:
                qt.add("prefetch_stall", t0=t, nbytes=st.nbytes,
                       tier="capacity", ledger="recovery",
                       joules=st.nbytes * cap_e, cid=st.cid)
            elif st.cancelled:
                qt.add("prefetch_cancel", t0=t, nbytes=st.nbytes,
                       tier="capacity", ledger="prefetch",
                       joules=st.nbytes * cap_e, cid=st.cid)
        t += window
    return t
