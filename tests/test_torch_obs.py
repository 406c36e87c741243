"""Parity of the port's observability layer (repro_torch.obs: trace,
metrics, audit, export) with repro.obs on the CPU.

Every scenario of tests/test_obs.py runs through both packages from the
same seeds: the reference engine in mode="xla_ref", the port's in
"torch_ref" on the CPU (its plain PyTorch versions). Both tables come
from Table.synthetic's numpy path, so their words are the same bits. The
conservation audit's reports are compared with == field for field, the
Chrome trace JSON and the waterfall byte for byte, and the port raises
the reference's error where the reference does: a double-charged ledger,
an untraced ledger line, a tracer without the tier model. The reference
test's own claims are asserted on the port's side as well.

tests/test_obs.py's `test_check_regress_gate` drives benchmarks/, which
the port does not carry; it has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import json
from types import SimpleNamespace

import pytest

N_ROWS, CHUNK_ROWS = 4096, 512


def _ref():
    import repro.obs as obs
    import repro.obs.metrics as metrics
    import repro.obs.trace as trace
    from repro.core.advisor import whatif_fast_fraction
    from repro.db import Table
    from repro.energy.meter import EnergyMeter
    from repro.kernels import dispatch
    from repro.launch.mesh import make_mesh
    from repro.query import Query, QueryEngine, ShardedTable, physical
    from repro.query.plan import GroupBy, Pred
    from repro.resilience import (ChaosHarness, ChunkGuard, FaultSpec,
                                  RetryPolicy)
    from repro.serve.sla import VirtualClock, latency_percentile
    from repro.store import EncodedTable
    from repro.tier import (PlacementEngine, Policy, TraceSpec, make_trace,
                            paper_tiers, replay_trace, zipf_hit_curve)
    from repro.tier.prefetch import PrefetchPipeline
    return SimpleNamespace(
        obs=obs, metrics=metrics, trace=trace, whatif=whatif_fast_fraction,
        synthetic=Table.synthetic, EnergyMeter=EnergyMeter,
        dispatch=dispatch, mesh=lambda: make_mesh((1,), ("data",)),
        Query=Query, QueryEngine=QueryEngine, ShardedTable=ShardedTable,
        physical=physical, GroupBy=GroupBy, Pred=Pred,
        ChaosHarness=ChaosHarness, ChunkGuard=ChunkGuard,
        FaultSpec=FaultSpec, RetryPolicy=RetryPolicy, Clock=VirtualClock,
        latency_percentile=latency_percentile, EncodedTable=EncodedTable,
        PlacementEngine=PlacementEngine, Policy=Policy, TraceSpec=TraceSpec,
        make_trace=make_trace, paper_tiers=paper_tiers,
        replay_trace=replay_trace, zipf_hit_curve=zipf_hit_curve,
        Prefetch=PrefetchPipeline, table_kw={}, eng_kw={"mode": "xla_ref"},
        replay_kw={"mode": "xla_ref"})


def _port():
    import repro_torch.obs as obs
    import repro_torch.obs.metrics as metrics
    import repro_torch.obs.trace as trace
    from repro_torch.core.advisor import whatif_fast_fraction
    from repro_torch.db import Table
    from repro_torch.energy.meter import EnergyMeter
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.query import Query, QueryEngine, ShardedTable, physical
    from repro_torch.query.plan import GroupBy, Pred
    from repro_torch.resilience import (ChaosHarness, ChunkGuard, FaultSpec,
                                        RetryPolicy)
    from repro_torch.serve.sla import VirtualClock, latency_percentile
    from repro_torch.store import EncodedTable
    from repro_torch.tier import (PlacementEngine, Policy, TraceSpec,
                                  make_trace, paper_tiers, replay_trace,
                                  zipf_hit_curve)
    from repro_torch.tier.prefetch import PrefetchPipeline
    return SimpleNamespace(
        obs=obs, metrics=metrics, trace=trace, whatif=whatif_fast_fraction,
        synthetic=Table.synthetic, EnergyMeter=EnergyMeter,
        dispatch=dispatch,
        mesh=lambda: make_mesh((1,), ("data",), device="cpu"),
        Query=Query, QueryEngine=QueryEngine, ShardedTable=ShardedTable,
        physical=physical, GroupBy=GroupBy, Pred=Pred,
        ChaosHarness=ChaosHarness, ChunkGuard=ChunkGuard,
        FaultSpec=FaultSpec, RetryPolicy=RetryPolicy, Clock=VirtualClock,
        latency_percentile=latency_percentile, EncodedTable=EncodedTable,
        PlacementEngine=PlacementEngine, Policy=Policy, TraceSpec=TraceSpec,
        make_trace=make_trace, paper_tiers=paper_tiers,
        replay_trace=replay_trace, zipf_hit_curve=zipf_hit_curve,
        Prefetch=PrefetchPipeline, table_kw={"device": "cpu"},
        eng_kw={"mode": "torch_ref", "device": "cpu"},
        replay_kw={"mode": "torch_ref"})


@pytest.fixture(scope="module")
def sides():
    """(reference, port) namespaces of the same names."""
    return _ref(), _port()


# --------------------------------------------------------------------------
# the scenarios of tests/test_obs.py, written once over a package
# --------------------------------------------------------------------------

def make_table(S, seed=1, n_cols=8):
    return S.synthetic("obs", N_ROWS, {f"c{i:02d}": 8 for i in range(n_cols)},
                       seed=seed, **S.table_kw)


def tiered_engine(S, table, *, policy=None, fast_frac=0.5, compute_w=0.0,
                  **kw):
    tiers = S.paper_tiers(table.nbytes * fast_frac, fast_gbps=10.0)
    pe = S.PlacementEngine.for_table(table, tiers, policy or S.Policy.CACHE,
                                     chunk_rows=CHUNK_ROWS,
                                     meter=S.EnergyMeter(tiers, compute_w))
    tracer = S.obs.Tracer()
    eng = S.QueryEngine(table, tiered=pe, clock=S.Clock(), tracer=tracer,
                        **S.eng_kw, **kw)
    return eng, pe, tracer


def run_queries(S, eng, n=4):
    for _ in range(n):
        q = S.Query(S.Pred("c00", "ge", 10), aggregates=("c01",))
        assert eng.submit(q, deadline=eng.clock() + 100.0) is not None
        eng.run()


def prefetch_engine(S, *, monitor=None):
    """The prefetch scenario's engine: a quarter of the table fast, an
    eighth of it in flight."""
    table = make_table(S)
    tiers = S.paper_tiers(table.nbytes * 0.25, fast_gbps=10.0)
    pe = S.PlacementEngine.for_table(table, tiers, S.Policy.CACHE,
                                     chunk_rows=CHUNK_ROWS,
                                     meter=S.EnergyMeter(tiers))
    pf = S.Prefetch(pe, table.nbytes // 8)
    tracer = S.obs.Tracer()
    eng = S.QueryEngine(table, tiered=pe, clock=S.Clock(), prefetch=pf,
                        tracer=tracer, monitor=monitor, **S.eng_kw)
    return eng, pe, pf, tracer


def chaos_traced_run(S, n_queries=60, prefetch=True):
    """tests/test_obs.py's seeded fault-injected replay with tracing."""
    table = S.synthetic("events", 8192, {f"c{i:02d}": 8 for i in range(8)},
                        seed=0, **S.table_kw)
    enc = S.EncodedTable.from_table(table, chunk_rows=CHUNK_ROWS)
    tiers = S.paper_tiers(table.nbytes * 0.25, fast_gbps=0.016)
    qtrace = S.make_trace(table, S.TraceSpec(n_queries=n_queries, skew=1.2,
                                             seed=11))
    clean_s = (enc.nbytes
               / sum(len(c.chunks) for c in enc.columns.values())
               / tiers.fast.bandwidth)
    chaos = S.ChaosHarness(
        S.FaultSpec(seed=42, stall_rate=0.1, corrupt_rate=0.05),
        guard=S.ChunkGuard(enc),
        retry=S.RetryPolicy(timeout_s=2.0 * clean_s,
                            backoff_s=0.5 * clean_s, max_retries=2))
    chaos.inject_corruption()
    tracer = S.obs.Tracer()
    pe, eng, att = S.replay_trace(
        enc, qtrace, tiers, S.Policy.CACHE, sla_s=5e-2,
        chunk_rows=CHUNK_ROWS, chaos=chaos,
        prefetch_bytes=(table.nbytes // 16 if prefetch else 0),
        tracer=tracer, **S.replay_kw)
    return tracer, pe, eng


def spans(tracer) -> list:
    """Every traced query and its spans as plain data."""
    return [(qt.qid, qt.tenant, qt.shape, qt.submitted_at, qt.deadline,
             qt.bytes_expected, qt.t_start, qt.t_end, qt.busy_s, qt.chips,
             qt.met, qt.degraded, qt.error,
             [sp.as_dict() for sp in qt.spans]) for qt in tracer.queries]


def report(rep) -> dict:
    """An AuditReport as plain data, its verdicts included."""
    return {**dataclasses.asdict(rep), "ok": rep.ok,
            "query_ok": [q.ok for q in rep.queries],
            "render": rep.render()}


def kinds_of(tracer) -> dict:
    kinds: dict = {}
    for qt in tracer.queries:
        for k, n in qt.span_kinds().items():
            kinds[k] = kinds.get(k, 0) + n
    return kinds


def both(sides, fn):
    """fn over the reference and the port: (reference's, port's)."""
    ref, port = sides
    return fn(ref), fn(port)


def assert_json_safe(obj) -> None:
    """Every leaf of an export is what json.dumps writes as itself: a str,
    int or float (or a subclass, which it writes the same). A tensor or a
    numpy integer would raise there, or print as its repr through
    default=str."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            assert k is None or isinstance(k, (str, int, float)), type(k)
            assert_json_safe(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            assert_json_safe(v)
    else:
        assert obj is None or isinstance(obj, (str, int, float)), \
            (type(obj), obj)


# --------------------------------------------------------------------------
# conservation audit across execution paths
# --------------------------------------------------------------------------

def _audit_plain(S):
    eng, pe, tracer = tiered_engine(S, make_table(S))
    run_queries(S, eng)
    rep = S.obs.check(tracer, pe.meter)
    return rep, eng, tracer


def test_audit_plain_tiered(sides):
    (jrep, _, jtr), (rep, eng, tracer) = both(sides, _audit_plain)
    assert report(rep) == report(jrep)
    assert spans(tracer) == spans(jtr)
    assert rep.ok and len(rep.queries) == 4
    for qa, res in zip(rep.queries, eng.results):
        assert sum(qa.span_bytes["query"]) == res.bytes_scanned


def test_audit_with_compute_term(sides):
    def run(S):
        eng, pe, tracer = tiered_engine(S, make_table(S), compute_w=7.5)
        run_queries(S, eng)
        assert pe.meter.compute_j > 0
        return report(S.obs.check(tracer, pe.meter)), pe.meter.compute_j
    want, got = both(sides, run)
    assert got == want


@pytest.mark.parametrize("path", ("encoded", "sharded"))
def test_audit_encoded_and_sharded(sides, path):
    def run(S):
        table = make_table(S)
        if path == "encoded":
            table = S.EncodedTable.from_table(table, chunk_rows=CHUNK_ROWS)
        else:
            table = S.ShardedTable.shard(table, S.mesh())
        eng, pe, tracer = tiered_engine(S, table)
        run_queries(S, eng)
        return report(S.obs.check(tracer, pe.meter)), spans(tracer)
    want, got = both(sides, run)
    assert got == want
    assert got[0]["ok"]


def test_audit_grouped(sides):
    def run(S):
        enc = S.EncodedTable.from_table(make_table(S), chunk_rows=CHUNK_ROWS)
        eng, pe, tracer = tiered_engine(S, enc)
        q = S.GroupBy(keys=("c00",), aggs=("c01",),
                      where=S.Pred("c02", "ge", 4))
        assert eng.submit(q, deadline=eng.clock() + 100.0) is not None
        eng.run()
        return (report(S.obs.check(tracer, pe.meter)), spans(tracer),
                tracer.queries[0].span_kinds())
    want, got = both(sides, run)
    assert got == want
    assert got[2].get("launch", 0) >= 1


def test_audit_prefetch(sides):
    def run(S):
        eng, pe, pf, tracer = prefetch_engine(S)
        run_queries(S, eng, n=6)
        rep = report(S.obs.check(tracer, pe.meter))
        staged = sum(sp.nbytes for qt in tracer.queries for sp in qt.spans
                     if sp.kind == "prefetch_read")
        return rep, kinds_of(tracer), pe.prefetch_streamed_bytes_total, \
            staged
    want, got = both(sides, run)
    assert got == want
    assert got[1].get("prefetch_read", 0) > 0, \
        "pipeline never staged a chunk in the trace"
    assert got[2] == got[3]


def test_audit_chaos(sides):
    def run(S):
        tracer, pe, eng = chaos_traced_run(S)
        rec = sum(sp.nbytes for qt in tracer.queries for sp in qt.spans
                  if sp.ledger == "recovery")
        return (report(S.obs.check(tracer, pe.meter)), kinds_of(tracer),
                rec, pe.recovery_bytes_total, spans(tracer))
    want, got = both(sides, run)
    assert got == want
    rep, kinds, rec, total, _ = got
    assert rep["ok"]
    assert kinds.get("retry", 0) > 0 and kinds.get("repair", 0) > 0
    assert kinds.get("prefetch_stall", 0) > 0
    assert rec == total


def test_audit_fails_on_double_charge(sides):
    def run(S):
        eng, pe, tracer = tiered_engine(S, make_table(S))
        run_queries(S, eng, n=2)
        S.obs.check(tracer, pe.meter)
        pe.meter.charge(0, 4096, qid=tracer.queries[0].qid, kind="recovery")
        rep = S.obs.audit(tracer, pe.meter)
        with pytest.raises(S.obs.ConservationError, match="recovery") as e:
            S.obs.check(tracer, pe.meter)
        return report(rep), str(e.value)
    (jrep, jmsg), (rep, msg) = both(sides, run)
    assert (rep, msg) == (jrep, jmsg)
    assert not rep["ok"]
    # the port's error is the reference's kind of error
    from repro.obs import ConservationError as JConservationError
    from repro_torch.obs import ConservationError
    assert issubclass(ConservationError, ValueError)
    assert ConservationError.__mro__[1:] == JConservationError.__mro__[1:]


def test_audit_flags_untraced_ledger_lines(sides):
    def run(S):
        eng, pe, tracer = tiered_engine(S, make_table(S))
        run_queries(S, eng, n=1)
        pe.meter.charge(0, 512, qid=999, kind="query")
        return report(S.obs.audit(tracer, pe.meter))
    want, got = both(sides, run)
    assert got == want
    assert not got["ok"] and any("untraced" in p for p in got["problems"])


# --------------------------------------------------------------------------
# determinism + export
# --------------------------------------------------------------------------

def test_chaos_trace_byte_identical(sides):
    ref, port = sides
    j1 = port.obs.chrome_trace_json(chaos_traced_run(port, n_queries=40)[0])
    j2 = port.obs.chrome_trace_json(chaos_traced_run(port, n_queries=40)[0])
    assert j1 == j2
    assert len(j1) > 1000
    assert j1 == ref.obs.chrome_trace_json(
        chaos_traced_run(ref, n_queries=40)[0])


def test_chrome_trace_loadable(sides):
    ref, port = sides
    tracer = chaos_traced_run(port, n_queries=20)[0]
    doc = json.loads(port.obs.chrome_trace_json(tracer))
    events = doc["traceEvents"]
    assert events, "empty trace"
    assert {e["ph"] for e in events} <= {"X", "M"}
    xs = [e for e in events if e["ph"] == "X"]
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in xs)
    roots = [e for e in xs if e["tid"] == 0]
    assert len(roots) == len(tracer.queries)
    obj = port.obs.chrome_trace(tracer)
    assert doc == obj
    assert_json_safe(obj)
    assert obj == ref.obs.chrome_trace(chaos_traced_run(ref, n_queries=20)[0])


def test_waterfall_renders(sides):
    def run(S):
        tracer = chaos_traced_run(S, n_queries=10)[0]
        return (S.obs.waterfall(tracer, max_queries=3),
                S.obs.waterfall(tracer))
    (jtext, jall), (text, full) = both(sides, run)
    assert (text, full) == (jtext, jall)
    assert "read" in text and "q" in text
    assert len(text.splitlines()) > 3


# --------------------------------------------------------------------------
# tracer surface + disabled path
# --------------------------------------------------------------------------

def test_null_tracer_is_allocation_free(sides):
    _, port = sides
    nt = port.obs.NullTracer()
    qt = nt.begin_query(1)
    assert qt is port.trace.NULL_TRACE and not qt.enabled
    qt.begin_run(0.0)
    assert qt.read((0, 0), 1, tier="fast", hit=True) is None
    qt.close(1.0, met=True)
    assert len(nt) == 0


def test_engine_default_has_no_tracing_overhead(sides):
    def run(S):
        table = make_table(S)
        eng = S.QueryEngine(table, tiered=S.PlacementEngine.for_table(
            table, S.paper_tiers(table.nbytes * 0.5, fast_gbps=10.0),
            S.Policy.CACHE, chunk_rows=CHUNK_ROWS), clock=S.Clock(),
            **S.eng_kw)
        assert isinstance(eng.tracer, S.obs.NullTracer)
        run_queries(S, eng, n=1)
        return eng.summary()
    want, got = both(sides, run)
    assert got == want and "trace" not in got


def test_tracer_requires_tiered(sides):
    def run(S):
        with pytest.raises(ValueError, match="tiered") as e:
            S.QueryEngine(make_table(S), tracer=S.obs.Tracer(), **S.eng_kw)
        return str(e.value)
    want, got = both(sides, run)
    assert got == want


# --------------------------------------------------------------------------
# scoped metrics + dispatch shims
# --------------------------------------------------------------------------

def test_dispatch_shims_default_scope(sides):
    def run(S):
        d = S.dispatch
        d.reset_launch_counts()
        d.count_launch("fam_a", 2)
        d.count_launch("fam_b")
        out = (d.launch_counts(), d.total_launches())
        d.reset_launch_counts()
        return out + (d.launch_counts(),)
    want, got = both(sides, run)
    assert got == want == ({"fam_a": 2, "fam_b": 1}, 3, {})


def test_scoped_isolation_between_engines(sides):
    def run(S):
        d = S.dispatch
        d.reset_launch_counts()
        r1, r2 = S.obs.MetricsRegistry("e1"), S.obs.MetricsRegistry("e2")
        with S.obs.scoped(r1):
            d.count_launch("fam", 3)
        with S.obs.scoped(r2):
            d.count_launch("fam", 5)
        out = [r1.launch_counts(), r2.launch_counts(), d.launch_counts()]
        d.reset_launch_counts()
        return out + [r1.launch_counts()]
    want, got = both(sides, run)
    assert got == want == [{"fam": 3}, {"fam": 5}, {"fam": 8}, {"fam": 3}]


def test_engine_scope_attributes_launches(sides):
    def run(S):
        eng, pe, tracer = tiered_engine(S, make_table(S))
        run_queries(S, eng, n=2)
        return (eng.metrics.launch_counts(),
                [[sp.attrs["family"] for sp in qt.spans
                  if sp.kind == "launch"] for qt in tracer.queries])
    want, got = both(sides, run)
    assert got == want
    assert got[0].get("scan_aggregate") == 2
    assert got[1] == [["scan_aggregate"]] * 2


def test_registry_histogram_and_gauge(sides):
    def run(S):
        r = S.obs.MetricsRegistry("x")
        r.gauge("depth").set(3.5)
        h = r.histogram("lat")
        for v in (1.0, 2.0, 3.0):
            h.observe(v)
        with pytest.raises(ValueError):
            r.counter("c").inc(-1)
        return r.snapshot()
    want, got = both(sides, run)
    assert got == want
    assert got["gauges"]["depth"] == 3.5
    assert got["histograms"]["lat"]["count"] == 3
    assert got["histograms"]["lat"]["mean"] == 2.0


# --------------------------------------------------------------------------
# unified snapshot: the overlapping-key normalization
# --------------------------------------------------------------------------

def test_snapshot_normalizes_prefetch_keys(sides):
    def run(S):
        eng, pe, pf, _ = prefetch_engine(S)
        run_queries(S, eng, n=6)
        snap = S.obs.unified_snapshot(eng)
        assert snap["prefetch.streamed_bytes"] \
            == pe.prefetch_streamed_bytes_total \
            == pf.stats()["streamed_bytes"]
        assert snap["prefetch.wasted_bytes"] \
            == pe.prefetch_wasted_bytes_total == pf.stats()["wasted_bytes"]
        assert snap["tier.recovery_bytes"] == pe.recovery_bytes_total \
            == pe.stats()["recovery_bytes"]
        assert snap["tier.fast_bytes"] == pe.stats()["fast_bytes"]
        assert snap["energy.prefetch_j"] == pe.meter.prefetch_j
        return snap
    want, got = both(sides, run)
    assert got == want
    assert got["sla.served"] == 6


def test_snapshot_detects_key_drift(sides):
    def run(S):
        eng, pe, pf, _ = prefetch_engine(S)
        run_queries(S, eng, n=6)
        assert pf.streamed_bytes_total > 0
        pe.prefetch_streamed_bytes_total += 1
        with pytest.raises(ValueError, match="streamed_bytes") as e:
            S.obs.unified_snapshot(eng)
        return str(e.value)
    want, got = both(sides, run)
    assert got == want


def test_all_equals_the_reference(sides):
    ref, port = sides
    assert port.obs.__all__ == ref.obs.__all__
    for name in port.obs.__all__:
        assert hasattr(port.obs, name), name
