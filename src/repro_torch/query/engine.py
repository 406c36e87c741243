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
  recorded, so measured_bps feeds admission.

The reference engine's tiered, energy, chaos, prefetch, monitoring,
tracing, sharded and model-feedback paths belong to later slices of the
port; asking for one raises NotImplementedError naming its step in
ROADMAP.md ("Modules to port").
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import KernelMode
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import NullTracer
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
    tenant: int = 0
    logical_bytes: int = 0


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
    tier: dict | None = None        # tiered mode (a later slice): None
    logical_bytes: int = 0          # == bytes_scanned unless compressed
    degraded: bool = False          # chaos (a later slice): always False
    error: str | None = None


class QueryEngine:
    """Deadline-batched scan/aggregate execution over a flat table or a
    compressed store table (repro_torch.store.EncodedTable).

    est_gbps seeds the admission controller's service-time estimate; it is
    replaced by the measured cumulative scan rate as soon as one query has
    executed.

    device: where the engine executes — the CUDA device unless the caller
    passes one (device='cpu' runs the plain PyTorch versions). The table
    must already live there; the engine moves no data.
    """

    def __init__(self, table, *, mode=KernelMode.AUTO,
                 clock=time.perf_counter, est_gbps: float = 1.0,
                 tiered=None, power_cap=None, chaos=None, prefetch=None,
                 tracer=None, metrics=None, monitor=None, device=None):
        for arg, val in (("tiered=", tiered), ("power_cap=", power_cap),
                         ("chaos=", chaos), ("prefetch=", prefetch),
                         ("monitor=", monitor)):
            if val is not None:
                raise _later(arg, "step 6 (tier, energy, resilience, obs)")
        if tracer is not None and getattr(tracer, "enabled", True):
            raise _later("an enabled tracer=", "step 6 (obs tracing)")
        if hasattr(table, "n_shards"):
            raise _later("a sharded table", "step 5 (sharding)")
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
        # read by obs.metrics.unified_snapshot; their paths are not ported
        self.tiered = None
        self.prefetch = None
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
        self.bytes_total = 0.0
        self.logical_bytes_total = 0.0
        self.seconds_total = 0.0

    # --- structure --------------------------------------------------------
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

    # --- admission --------------------------------------------------------
    @property
    def measured_bps(self) -> float:
        if self.seconds_total > 0:
            return self.bytes_total / self.seconds_total
        return self._est_gbps * 1e9

    def _est_service_s(self, p: _Pending) -> float:
        return p.bytes_scanned / max(self.measured_bps, 1e-9)

    @property
    def rejected(self) -> list[int]:
        return [p.qid for p in self.queue.rejected]

    def submit(self, query: Query, deadline: float = math.inf,
               tenant: int = 0) -> int | None:
        """Admit a query under a deadline (absolute clock time). Returns
        the query id, or None if the deadline is already infeasible.
        Malformed queries raise ValueError."""
        if is_grouped(query):
            # the relational bind adds the join-key width and device
            # checks on top of the column checks
            from repro_torch.query import relational
            relational.bind_check(query, self.table.columns)
        else:
            physical.bind_check(query.plan(), query.aggregates,
                                self.table.columns)
        self._qid += 1
        pend = _Pending(self._qid, query, self.bytes_scanned(query),
                        self.clock(), tenant=tenant,
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
        launch counts attribute to the engine without touching the
        process-global shims."""
        batch: list[QueryResult] = []
        while True:
            got = self.queue.pop()        # sheds now-hopeless queries
            if got is None:
                break
            pend, deadline = got
            with obs_metrics.scoped(self.metrics):
                batch.append(self._serve_one(pend, deadline))
        return batch

    def _serve_one(self, pend: _Pending, deadline: float) -> QueryResult:
        t0 = self.clock()
        shape = ("join" if isinstance(pend.query, HashJoin)
                 else "grouped" if is_grouped(pend.query) else "scan")
        self.tracer.begin_query(
            pend.qid, tenant=pend.tenant, submitted_at=pend.submitted_at,
            deadline=deadline, bytes_expected=pend.bytes_scanned,
            shape=shape)
        aggs = self._execute(pend.query)
        # the host copies inside _execute waited for the device, so t1 - t0
        # covers the full scan
        t1 = self.clock()
        self.seconds_total += max(t1 - t0, 1e-12)
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
            met=t1 <= deadline, logical_bytes=pend.logical_bytes)
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
        return out

    def model_check(self, system=None) -> dict:
        raise _later("model_check (the paper model in core/)",
                     "step 7 (paper model)")

    def provision(self, sla_s: float, system=None):
        raise _later("provision (the paper model in core/)",
                     "step 7 (paper model)")
