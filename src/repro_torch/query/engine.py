"""SLA-aware query engine on a torch device: EDF admission, dispatch
execution, measured throughput (counterpart of repro/query/engine.py,
flat-table and compressed-store paths).

- queries carry deadlines and are admitted/ordered by the shared EDF
  machinery (repro_torch.serve.sla) with service-time estimates of
  bytes_scanned / measured scan rate;
- execution routes every operator through repro_torch.kernels.dispatch
  (fused scan+aggregate where the shape allows): on a CUDA table the
  Hopper kernels, on a CPU table their plain PyTorch versions;
- a repro_torch.store EncodedTable executes compressed
  (store.exec.execute_encoded): bytes_scanned is the physical
  (compressed) traffic, logical_bytes the plain-format coverage beside
  it, so summary()'s effective_gbps exceeds measured_gbps by what
  compression buys;
- GroupBy/HashJoin run through query.relational on a flat table and
  store.exec.execute_grouped_encoded on a store table (the
  group_aggregate kernels); the result is the grouped dict
  {"groups": ..., "count": total};
- every query's bytes_scanned and attained wall-clock latency are
  recorded, so measured_bps feeds admission;
- with `tiered=` a repro_torch.tier.PlacementEngine, the table is treated
  as split across a fast (die-stacked) and a capacity (DDR) tier: every
  query's per-chunk bytes are reported to the placement engine, latency
  is charged per chunk at its tier's rate on a VirtualClock (the tiered
  latency model), the energy meter bills each query, and admission
  feasibility uses the blended rate. `prefetch=` prices the pipelined
  read, `power_cap=` throttles modeled service under a watt budget, and
  an enabled `tracer=` records each query's spans in modeled time.
  Placement never changes answers — execution is identical, the kernels
  run as in flat mode; only the time/energy accounting moves.

The reference engine's chaos, monitoring, sharded and model-feedback
paths belong to later slices of the port; asking for one raises
NotImplementedError naming its step in ROADMAP.md ("Modules to port").
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import KernelMode
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import NullTracer, layout_pipeline, layout_sync
from repro_torch.query import physical
from repro_torch.query.plan import HashJoin, Query, is_grouped
from repro_torch.serve.sla import DeadlineQueue, SLAReport, summarize


def _later(what: str, step: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md, 'Modules to port', {step}")


@dataclass
class _Pending:
    qid: int
    query: Query
    bytes_scanned: int              # physical (compressed) bytes
    submitted_at: float
    chunks: dict | None = None      # tiered mode: per-chunk byte counts
    tenant: int = 0                 # energy-ledger attribution
    logical_bytes: int = 0          # plain-format bytes the query covers


@dataclass
class QueryResult:
    qid: int
    query: Query
    aggregates: dict[str, dict]     # column -> {sum, count, min, max} ints
    count: int
    selectivity: float
    bytes_scanned: int
    latency_s: float
    deadline: float
    met: bool
    tier: dict | None = None        # tiered mode: byte split + modeled s
    logical_bytes: int = 0          # == bytes_scanned unless compressed
    degraded: bool = False          # chaos (ROADMAP.md step 6b): False
    error: str | None = None        # the typed degradation, when degraded


class QueryEngine:
    """Deadline-batched scan/aggregate execution over a flat table or a
    compressed store table (repro_torch.store.EncodedTable).

    est_gbps seeds the admission controller's service-time estimate; it is
    replaced by the measured cumulative scan rate as soon as one query has
    executed.

    device: where the engine executes — the CUDA device unless the caller
    passes one (device='cpu' runs the plain PyTorch versions). The table
    must already live there; the engine moves no data.

    tiered: a repro_torch.tier.PlacementEngine built over this table.
    Queries still execute (and answer) exactly as in flat mode, but
    service time is *modeled* — each referenced chunk charged at the rate
    of the tier it resides in — and seconds_total accumulates modeled
    service, so measured_bps (and with it admission feasibility) becomes
    the blended tier rate. Tiered mode requires an advanceable clock
    (serve.sla.VirtualClock) so deadlines live on the same modeled time
    axis the service charges advance.
    """

    def __init__(self, table, *, mode=KernelMode.AUTO,
                 clock=time.perf_counter, est_gbps: float = 1.0,
                 tiered=None, power_cap=None, chaos=None, prefetch=None,
                 tracer=None, metrics=None, monitor=None, device=None):
        if chaos is not None:
            raise _later("chaos=", "step 6b (resilience)")
        if monitor is not None:
            raise _later("monitor=", "step 6c (obs: slo)")
        if hasattr(table, "n_shards"):
            raise _later("a sharded table", "step 5 (sharding)")
        if tracer is not None and getattr(tracer, "enabled", True) \
                and tiered is None:
            # spans are stamped in *modeled* time; a flat engine only has
            # the wall clock, which would make traces nondeterministic
            raise ValueError(
                "tracer= records the modeled tiered timeline; pass "
                "tiered=repro.tier.PlacementEngine(...) as well")
        if prefetch is not None:
            if tiered is None:
                # the pipeline overlaps *modeled* tier reads; without the
                # tier model there is nothing to overlap
                raise ValueError(
                    "prefetch needs the tiered service model; pass "
                    "tiered=repro.tier.PlacementEngine(...) as well")
            if prefetch.pe is not tiered:
                raise ValueError(
                    "prefetch pipeline was built over a different "
                    "PlacementEngine than this engine's tiered=")
        if tiered is not None and not hasattr(clock, "advance"):
            # modeled service needs a modeled time axis: pricing admission
            # at tier rates while deadlines tick on the wall clock would
            # compare incommensurate quantities
            raise ValueError(
                "tiered mode models service time, so deadlines must live "
                "on an advanceable clock; pass "
                "clock=repro.serve.sla.VirtualClock()")
        if power_cap is not None and tiered is None:
            # the governor throttles *modeled* service and prices queries
            # from the placement engine's energy meter; without tiering
            # there is neither a joules ledger nor a rate to derate
            raise ValueError(
                "power_cap needs the tiered energy model; pass "
                "tiered=repro.tier.PlacementEngine(...) as well")
        self.device = resolve_device(device)
        self.mode = KernelMode(mode)
        if self.mode is KernelMode.CUDA and self.device.type != "cuda":
            raise ValueError(
                f"mode='cuda' launches the Hopper kernels, but the engine "
                f"runs on {self.device}")
        if table.device is not None \
                and table.device.type != self.device.type:
            raise ValueError(
                f"table {table.name!r} lives on {table.device} but the "
                f"engine runs on {self.device}; build the table there "
                f"(device=...)")
        self.table = table
        self.tiered = tiered
        self.power_cap = power_cap
        self.prefetch = prefetch
        # per-engine metrics scope: execution runs inside scoped(metrics),
        # so launch counts here are this engine's alone while the default
        # (process-global) scope keeps accumulating for the legacy shims
        self.metrics = (metrics if metrics is not None
                        else obs_metrics.MetricsRegistry("engine"))
        self.tracer = tracer if tracer is not None else NullTracer()
        self.clock = clock
        self.queue = DeadlineQueue(clock, self._est_service_s)
        self.reports: list[SLAReport] = []
        self.results: list[QueryResult] = []
        self._qid = 0
        self._est_gbps = float(est_gbps)
        self.bytes_total = 0.0          # physical (compressed) bytes
        self.logical_bytes_total = 0.0  # plain-format coverage
        self.seconds_total = 0.0

    # --- structure --------------------------------------------------------
    @property
    def n_shards(self) -> int:
        """One card: the chip count the tier model scales its rates and
        compute power by (sharded tables are step 5)."""
        return 1

    @property
    def num_rows(self) -> int:
        return self.table.num_rows

    def bytes_scanned(self, query: Query) -> int:
        """Physical bytes the query streams from device memory (compressed
        for a store table)."""
        return physical.referenced_bytes(query.plan(), query.aggregates,
                                         self.table.columns)

    def logical_bytes(self, query: Query) -> int:
        """Plain-format bytes the query covers; the physical/logical gap
        is the effective-bandwidth multiplier compression buys."""
        return physical.referenced_logical_bytes(
            query.plan(), query.aggregates, self.table.columns)

    def chunk_accesses(self, query: Query) -> dict:
        """Per-(column, chunk) bytes this query streams, in the tiered
        placement engine's chunking."""
        if self.tiered is None:
            raise ValueError("chunk accounting needs tiered=PlacementEngine")
        return physical.referenced_chunk_bytes(
            query.plan(), query.aggregates, self.table.columns,
            self.tiered.chunk_rows)

    # --- admission --------------------------------------------------------
    @property
    def measured_bps(self) -> float:
        if self.tiered is not None:
            # blended tier rate at the measured (or resident) hit fraction
            return self.tiered.blended_measured_bps(self.n_shards)
        if self.seconds_total > 0:
            return self.bytes_total / self.seconds_total
        return self._est_gbps * 1e9

    def _projected_energy_j(self, p: _Pending, busy_s: float) -> float:
        """Admission-time joules estimate: memory term from the *current*
        residency (PlacementEngine.project — no state touched), compute
        term at the meter's chip power over the modeled busy time."""
        split = self.tiered.project(p.chunks)
        meter = self.tiered.meter
        return (meter.tiers.energy_j(split.fast_bytes, split.capacity_bytes)
                + meter.compute_w * self.n_shards * busy_s)

    def _est_service_s(self, p: _Pending) -> float:
        if self.prefetch is not None and p.chunks is not None:
            # admission prices the pipelined read, not the sync sum —
            # plan() is pure, so estimating cannot move placement state
            est = self.prefetch.plan(p.chunks,
                                     chips=self.n_shards).service_s
        else:
            est = p.bytes_scanned / max(self.measured_bps, 1e-9)
        if self.power_cap is not None:
            # feasibility must be priced at the power-derated rate: a
            # query the governor would stretch past its deadline is
            # rejected here instead of silently running over budget
            est = self.power_cap.throttled_service_s(
                self.clock(), self._projected_energy_j(p, est), est)
        return est

    @property
    def rejected(self) -> list[int]:
        return [p.qid for p in self.queue.rejected]

    def submit(self, query: Query, deadline: float = math.inf,
               tenant: int = 0) -> int | None:
        """Admit a query under a deadline (absolute clock time). Returns
        the query id, or None if the deadline is already infeasible.
        Malformed queries raise ValueError.

        In tiered mode the admission estimate, bytes_total, and the
        service charge all use the placement engine's chunk accounting —
        one byte basis, so an admitted estimate and the charged service
        can't diverge. `tenant` tags the query's line on the energy
        meter."""
        if is_grouped(query):
            # the relational bind adds the join-key width and device
            # checks on top of the column checks
            from repro_torch.query import relational
            relational.bind_check(query, self.table.columns)
        else:
            physical.bind_check(query.plan(), query.aggregates,
                                self.table.columns)
        self._qid += 1
        chunks = (self.chunk_accesses(query) if self.tiered is not None
                  else None)
        nbytes = (sum(chunks.values()) if chunks is not None
                  else self.bytes_scanned(query))
        pend = _Pending(self._qid, query, nbytes, self.clock(),
                        chunks=chunks, tenant=tenant,
                        logical_bytes=self.logical_bytes(query))
        if self.queue.push(pend, deadline):
            return pend.qid
        return None

    # --- execution --------------------------------------------------------
    def _execute(self, query: Query) -> dict:
        """Exact host-int aggregates (or the grouped result dict for
        GroupBy/HashJoin); every path copies its result to the host, which
        waits for the device."""
        if is_grouped(query):
            if hasattr(self.table, "chunk_rows"):    # a store table
                from repro_torch.store.exec import execute_grouped_encoded
                return execute_grouped_encoded(query, self.table,
                                               mode=self.mode)
            from repro_torch.query import relational
            return relational.execute_grouped(query, self.table,
                                              mode=self.mode)
        if hasattr(self.table, "chunk_rows"):        # a store table
            # imported here: repro_torch.store imports this package
            from repro_torch.store.exec import execute_encoded
            return execute_encoded(query.plan(), query.aggregates,
                                   self.table, mode=self.mode)
        return physical.finalize_aggs(physical.execute(
            query.plan(), query.aggregates,
            physical.table_slices(self.table), mode=self.mode))

    def run(self) -> list[QueryResult]:
        """Drain the queue in deadline order; returns this batch's results.

        Each query executes inside this engine's metrics scope, so kernel
        launch counts attribute to the engine (and, via the trace's launch
        spans, to the query) without touching the process-global shims."""
        batch: list[QueryResult] = []
        while True:
            got = self.queue.pop()        # sheds now-hopeless queries
            if got is None:
                break
            pend, deadline = got
            with obs_metrics.scoped(self.metrics):
                batch.append(self._serve_one(pend, deadline))
        return batch

    def _emit_launches(self, qt, before: dict, ts: float) -> None:
        """Turn this query's per-engine counter deltas into launch spans:
        one per kernel family (attrs: family, n) and one per batched
        width group (attrs: family, width, n, n_chunks)."""
        for key in sorted(self.metrics.counters):
            d = self.metrics.counters[key].value - before.get(key, 0)
            if d <= 0:
                continue
            if key.startswith("launches/"):
                qt.add("launch", t0=ts, family=key[len("launches/"):],
                       n=d)
            elif key.startswith("batch/"):
                _, family, w = key.split("/", 2)
                covered = (self.metrics.counters[
                    f"batch_chunks/{family}/{w}"].value
                    - before.get(f"batch_chunks/{family}/{w}", 0))
                qt.add("launch_batch", t0=ts, family=family,
                       width=int(w[1:]), n=d, n_chunks=covered)

    def _serve_tiered(self, pend: _Pending, t0: float, trace):
        """Execute, then charge the modeled tiered service: each chunk at
        the rate of the tier it lived in, the pipelined read when
        prefetching, the power cap's stretch. Returns (aggregates, t1,
        the QueryResult.tier dict)."""
        # prefetch plans against residency *before* on_access mutates
        # it — the same residency the charge uses
        pplan = None
        if self.prefetch is not None:
            pplan = self.prefetch.plan(pend.chunks, chips=self.n_shards)
            self.prefetch.begin(pplan, pend.chunks)
        aggs = self._execute(pend.query)
        acc = self.tiered.on_access(pend.chunks, qid=pend.qid,
                                    tenant=pend.tenant, trace=trace)
        busy = (pplan.service_s if pplan is not None
                else self.tiered.service_s(acc, self.n_shards))
        self.tiered.meter.charge_compute(acc.charge, busy, self.n_shards)
        query_j = acc.charge.total_j
        if trace is not None:
            if pplan is not None:
                layout_pipeline(trace, t0, pplan, self.tiered.tiers,
                                self.n_shards)
            else:
                layout_sync(trace, t0, self.tiered.tiers, self.n_shards)
            trace.compute(t0, busy, self.n_shards,
                          self.tiered.meter.compute_w * self.n_shards
                          * busy)
        if pplan is not None:
            line = self.prefetch.finish(pplan, qid=pend.qid,
                                        tenant=pend.tenant)
            if line is not None:
                query_j += line.total_j
        service = busy
        if self.power_cap is not None:
            # race-to-idle throttling: the governor stretches wall time
            # until no watt window exceeds budget; joules are fixed at the
            # busy-time charge, the chip idles the rest
            service = self.power_cap.throttled_service_s(t0, query_j, busy)
            self.power_cap.record(t0, t0 + service, query_j,
                                  natural_s=busy)
            if trace is not None and service > busy:
                trace.add("throttle", t0=t0 + busy, dur_s=service - busy)
        t1 = self.clock.advance(service)
        self.seconds_total += service
        tier_info = {"fast_bytes": acc.fast_bytes,
                     "capacity_bytes": acc.capacity_bytes,
                     "hit_fraction": acc.hit_fraction,
                     "service_s": service,
                     "energy_j": query_j}
        if self.power_cap is not None:
            tier_info["throttle_s"] = service - busy
        return aggs, t1, tier_info

    def _serve_one(self, pend: _Pending, deadline: float) -> QueryResult:
        t0 = self.clock()
        shape = ("join" if isinstance(pend.query, HashJoin)
                 else "grouped" if is_grouped(pend.query) else "scan")
        qt = self.tracer.begin_query(
            pend.qid, tenant=pend.tenant, submitted_at=pend.submitted_at,
            deadline=deadline, bytes_expected=pend.bytes_scanned,
            shape=shape)
        trace = qt if getattr(qt, "enabled", False) else None
        if trace is not None:
            qt.begin_run(t0)
        launches0 = ({k: c.value
                      for k, c in self.metrics.counters.items()}
                     if trace is not None else None)
        tier_info = None
        if self.tiered is not None:
            aggs, t1, tier_info = self._serve_tiered(pend, t0, trace)
        else:
            aggs = self._execute(pend.query)
            # the host copies inside _execute waited for the device, so
            # t1 - t0 covers the full scan
            t1 = self.clock()
            self.seconds_total += max(t1 - t0, 1e-12)
        if trace is not None:
            self._emit_launches(qt, launches0, t0)
            qt.close(t1, met=t1 <= deadline)
        self.bytes_total += pend.bytes_scanned
        self.logical_bytes_total += pend.logical_bytes
        if "groups" in aggs:
            count = aggs["count"]           # grouped: total selected rows
        else:
            count = next(iter(aggs.values()))["count"] if aggs else 0
        res = QueryResult(
            qid=pend.qid, query=pend.query, aggregates=aggs, count=count,
            selectivity=count / max(self.num_rows, 1),
            bytes_scanned=pend.bytes_scanned,
            latency_s=t1 - pend.submitted_at, deadline=deadline,
            met=t1 <= deadline, tier=tier_info,
            logical_bytes=pend.logical_bytes)
        self.reports.append(SLAReport(
            rid=pend.qid, deadline=deadline,
            submitted_at=pend.submitted_at, finished_at=t1,
            work=pend.bytes_scanned))
        self.results.append(res)
        return res

    # --- reporting --------------------------------------------------------
    def summary(self) -> dict:
        out = summarize(self.reports, rejected=len(self.queue.rejected))
        out["bytes_scanned"] = self.bytes_total
        out["measured_gbps"] = (self.bytes_total / self.seconds_total / 1e9
                                if self.seconds_total > 0 else 0.0)
        out["logical_bytes"] = self.logical_bytes_total
        # logical coverage per second: > measured_gbps exactly when the
        # store is compressed
        out["effective_gbps"] = (self.logical_bytes_total
                                 / self.seconds_total / 1e9
                                 if self.seconds_total > 0 else 0.0)
        if self.tiered is not None:
            out["tier"] = self.tiered.stats(self.n_shards)
            out["energy"] = self.tiered.meter.summary()
        if self.prefetch is not None:
            out["prefetch"] = self.prefetch.stats()
        if self.power_cap is not None:
            out["power"] = self.power_cap.report(now=self.clock())
        if getattr(self.tracer, "enabled", False):
            out["trace"] = self.tracer.summary()
        return out

    def model_check(self, system=None) -> dict:
        raise _later("model_check (the paper model in core/)",
                     "step 7 (paper model)")

    def provision(self, sla_s: float, system=None):
        raise _later("provision (the paper model in core/)",
                     "step 7 (paper model)")
