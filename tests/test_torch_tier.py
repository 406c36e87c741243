"""Parity of the port's tier layer (repro_torch.tier, kernels.tune, the
tiered QueryEngine) with repro.tier on the CPU.

The reference tests' table (tests/test_tier.py: 16 columns of 8-bit codes,
4096 rows, placement chunks of 256 rows) is taken across bit for bit
(table_from_arrays), and the same traces replay through both packages:
the reference engine in mode="xla_ref", the port's on the CPU (its plain
PyTorch versions). Everything is compared with ==, no tolerance: answers,
every QueryResult.tier dict, placement stats, energy ledger lines,
prefetch stats, the power cap's report, rejected qids, attainment, the
summary, unified_snapshot and the tracer's spans — for all three policies,
the flat table and its compressed store, with and without prefetch and a
power cap.
"""
import math

import numpy as np
import pytest
import torch

import repro.db as rdb
import repro.query as rq
import repro.tier as rt
import repro_torch.db as tdb
import repro_torch.query as tq
import repro_torch.tier as tt
from repro.core.systems import BIG_MEMORY as J_BIG_MEMORY
from repro.core.systems import DIE_STACKED as J_DIE_STACKED
from repro.core.systems import TRADITIONAL as J_TRADITIONAL
from repro.energy import PowerCap as JPowerCap
from repro.energy import chip_compute_watts as j_chip_compute_watts
from repro.kernels import tune as jtune
from repro.obs import Tracer as JTracer
from repro.obs.metrics import unified_snapshot as j_unified_snapshot
from repro.query import physical as jphysical
from repro.serve.sla import VirtualClock as JClock
from repro.store import EncodedTable as JEncodedTable
from repro_torch.core import systems as tsystems
from repro_torch.energy import PowerCap, chip_compute_watts
from repro_torch.kernels import tune
from repro_torch.obs import Tracer, unified_snapshot
from repro_torch.serve.sla import VirtualClock
from repro_torch.store import EncodedTable

N_COLS, N_ROWS = 16, 4096
FAST_FRACTION = 0.25
CHUNK_ROWS = 256
POLICIES = ("static", "cache", "memcache")


def store_mix(n_rows):
    """tests/test_store.py's column mix: r sorted over 8 values (RLE), f
    and w frame-of-reference, u plain, x at 4 bits."""
    rng = np.random.default_rng(3)
    t = rdb.Table("store")
    for name, vals, bits in (
            ("r", np.sort(rng.integers(0, 8, n_rows)), 8),
            ("f", 40 + rng.integers(0, 8, n_rows), 8),
            ("w", 9000 + rng.integers(0, 100, n_rows), 16),
            ("u", rng.integers(0, 128, n_rows), 8),
            ("x", rng.integers(0, 8, n_rows), 4)):
        t.add(rdb.BitPackedColumn.from_values(name, vals, bits))
    return t


def across(ref_t, name):
    """The reference table's words, bit for bit, on the CPU."""
    return tdb.table_from_arrays(
        {n: (np.asarray(c.words), c.code_bits, c.num_rows, c.dictionary)
         for n, c in ref_t.columns.items()}, name=name, device="cpu")


@pytest.fixture(scope="module")
def ref_table():
    return rdb.Table.synthetic("tier", N_ROWS,
                               {f"c{i:02d}": 8 for i in range(N_COLS)},
                               seed=1)


@pytest.fixture(scope="module")
def table(ref_table):
    return across(ref_table, "tier")


@pytest.fixture(scope="module")
def stores():
    """(reference plain, port plain, reference store, port store) of the
    store mix, encoded in CHUNK_ROWS chunks."""
    ref_plain = store_mix(N_ROWS)
    plain = across(ref_plain, "store")
    return (ref_plain, plain,
            JEncodedTable.from_table(ref_plain, chunk_rows=CHUNK_ROWS),
            EncodedTable.from_table(plain, chunk_rows=CHUNK_ROWS))


def tier_pairs(nbytes, fast_gbps=10.0):
    return (rt.paper_tiers(nbytes * FAST_FRACTION, fast_gbps=fast_gbps),
            tt.paper_tiers(nbytes * FAST_FRACTION, fast_gbps=fast_gbps))


def canon(q):
    """A query as plain data, comparable across the two packages."""
    name = type(q).__name__
    if name == "Query":
        return name, repr(q.where), q.aggregates
    if name == "GroupBy":
        return name, q.keys, q.aggs, repr(q.where)
    col = q.build.columns[q.on]
    return (name, q.probe, q.on, q.aggs, repr(q.where), q.build.name,
            col.code_bits, col.num_rows, [int(v) for v in col.decode()])


def traces(ref_table, table, **spec):
    return (rt.make_trace(ref_table, rt.TraceSpec(**spec)),
            tt.make_trace(table, tt.TraceSpec(**spec)))


def sla_for(table, trace, tiers):
    """tier_bench's deadline: 2x the mean all-fast service time."""
    mean = sum(jphysical.referenced_bytes(tq_.query.plan(),
                                          tq_.query.aggregates,
                                          table.columns)
               for tq_ in trace) / len(trace)
    return 2.0 * mean / tiers.fast.bandwidth


def spans(tracer):
    return [(qt.qid, qt.tenant, qt.shape, qt.submitted_at, qt.deadline,
             qt.bytes_expected, qt.t_start, qt.t_end, qt.busy_s, qt.chips,
             qt.met, qt.degraded, qt.error,
             [sp.as_dict() for sp in qt.spans]) for qt in tracer.queries]


def assert_replays_equal(ref_out, out, jtracer=None, tracer=None):
    (jpe, jeng, jatt), (pe, eng, att) = ref_out, out
    assert att == jatt
    assert eng.rejected == jeng.rejected
    assert len(eng.results) == len(jeng.results)
    for r, jr in zip(eng.results, jeng.results):
        assert canon(r.query) == canon(jr.query)
        assert r.aggregates == jr.aggregates, r.qid
        for f in ("qid", "count", "selectivity", "bytes_scanned",
                  "logical_bytes", "latency_s", "deadline", "met", "tier",
                  "degraded", "error"):
            assert getattr(r, f) == getattr(jr, f), (r.qid, f)
    assert pe.stats() == jpe.stats()
    assert pe.meter.summary() == jpe.meter.summary()
    assert pe.meter.by_tenant() == jpe.meter.by_tenant()
    assert [c.as_dict() for c in pe.meter.charges] == \
        [c.as_dict() for c in jpe.meter.charges]
    assert pe.budget.used == jpe.budget.used
    assert pe.in_fast.tolist() == jpe.in_fast.tolist()
    assert eng.seconds_total == jeng.seconds_total
    assert eng.summary() == jeng.summary()
    assert unified_snapshot(eng) == j_unified_snapshot(jeng)
    if eng.prefetch is not None:
        assert eng.prefetch.stats() == jeng.prefetch.stats()
    if eng.power_cap is not None:
        assert eng.power_cap.report(now=eng.clock()) == \
            jeng.power_cap.report(now=jeng.clock())
    if tracer is not None:
        assert spans(tracer) == spans(jtracer)
        assert tracer.summary() == jtracer.summary()


# --------------------------------------------------------------------------
# tiers: datasheet derivation, budget, the measured fast rate
# --------------------------------------------------------------------------
class TestTiers:
    def test_table1_systems_equal_the_reference(self):
        for mine, ref in zip(tsystems.PAPER_SYSTEMS,
                             (J_TRADITIONAL, J_BIG_MEMORY, J_DIE_STACKED),
                             strict=True):
            assert repr(mine) == repr(ref)
            for prop in ("chip_capacity", "chip_bandwidth",
                         "chip_peak_perf", "saturating_cores",
                         "bandwidth_capacity_ratio"):
                assert getattr(mine, prop) == getattr(ref, prop), prop
        assert chip_compute_watts(tsystems.DIE_STACKED) == \
            j_chip_compute_watts(J_DIE_STACKED) == 96.0

    def test_table1_bandwidth_ratio(self):
        assert tt.table1_bandwidth_ratio() == rt.table1_bandwidth_ratio() \
            == pytest.approx(2.5)

    def test_tier_from_system(self):
        for sys_t, sys_j in ((tsystems.DIE_STACKED, J_DIE_STACKED),
                             (tsystems.TRADITIONAL, J_TRADITIONAL)):
            mine, ref = tt.tier_from_system(sys_t), rt.tier_from_system(
                sys_j)
            assert repr(mine) == repr(ref)
            assert repr(mine.as_system()) == repr(ref.as_system())
            assert mine.as_system().chip_peak_perf == pytest.approx(
                mine.bandwidth)
            assert repr(tt.tier_from_system(sys_t, capacity=123,
                                            bandwidth=4e9)) == \
                repr(rt.tier_from_system(sys_j, capacity=123,
                                         bandwidth=4e9))

    @pytest.mark.parametrize("fast_gbps", (None, 10.0, 2540.25))
    def test_paper_tiers_fields(self, fast_gbps):
        mine = tt.paper_tiers(1 << 20, fast_gbps=fast_gbps)
        ref = rt.paper_tiers(1 << 20, fast_gbps=fast_gbps)
        assert repr(mine) == repr(ref)
        for frac in (0.0, 0.3, 1.0):
            assert mine.blended(frac, chips=2) == ref.blended(frac, chips=2)
        assert mine.service_s(10e9, 4e9) == ref.service_s(10e9, 4e9)
        assert mine.energy_components(1000, 500) == \
            ref.energy_components(1000, 500)

    def test_budget_guards(self):
        for mod in (tt, rt):
            b = mod.TieredBudget(100)
            b.alloc(60)
            assert not b.fits(50)
            with pytest.raises(ValueError, match="overflow"):
                b.alloc(50)
            b.free(30)
            b.alloc(50)
            assert b.remaining == pytest.approx(20)
            with pytest.raises(ValueError, match="positive"):
                mod.TieredBudget(0)
            with pytest.raises(ValueError, match="positive"):
                mod.paper_tiers(0)
        with pytest.raises(ValueError) as e:
            tt.TierSpec("x", 0.0, 1.0, 1.0)
        with pytest.raises(ValueError) as je:
            rt.TierSpec("x", 0.0, 1.0, 1.0)
        assert str(e.value) == str(je.value)

    def test_measured_fast_gbps_over_the_same_cache(self, tmp_path,
                                                    monkeypatch):
        """The same cache entries give the reference's rate: rows of 128
        int32 words, one plane for scan_filter, three for the fused op."""
        monkeypatch.setattr(tune, "backend", lambda: "cpu")
        try:
            cache = tune.set_cache_path(tmp_path / "torch.json")
            jcache = jtune.set_cache_path(tmp_path / "ref.json")
            assert tt.measured_fast_gbps(default=7.5) == \
                rt.measured_fast_gbps(default=7.5) == 7.5
            entries = [("scan_filter", "bits=8,rows=1024", {"us": 100.0}),
                       ("scan_aggregate", "bits=8,rows=1024", {"us": 100.0}),
                       ("scan_aggregate", "bits=8,rows=2097152",
                        {"us": 1269.2}),
                       ("aggregate", "bits=8,rows=4096", {"us": 1.0}),
                       ("scan_filter", "bits=8", {"us": 1.0})]
            for op, skey, entry in entries:
                cache.store(op, skey, entry)
                jcache.store(op, skey, entry)
                assert tt.measured_fast_gbps() == rt.measured_fast_gbps(), \
                    (op, skey)
            want = 3 * 2097152 * 128 * 4 / 1269.2e-6 / 1e9
            assert tt.measured_fast_gbps() == pytest.approx(want)
            # another backend's entries never price this one
            cache._load()["scan_aggregate|cuda|bits=8,rows=1"] = {"us": 1e-9}
            assert tt.measured_fast_gbps() == pytest.approx(want)
        finally:
            tune.set_cache_path(None)
            jtune.set_cache_path(None)


# --------------------------------------------------------------------------
# kernels.tune: the port's own cache and its sweep
# --------------------------------------------------------------------------
class TestTune:
    def test_keys_and_default_path(self, monkeypatch, tmp_path):
        assert tune.backend() == ("cuda" if torch.cuda.is_available()
                                  else "cpu")
        monkeypatch.setattr(tune, "backend", lambda: "cuda")
        assert tune.TuneCache.key("scan_aggregate", "bits=8,rows=4") == \
            "scan_aggregate|cuda|bits=8,rows=4"
        assert tune.shape_key(rows=4, bits=8) == \
            jtune.shape_key(rows=4, bits=8) == "bits=8,rows=4"
        assert [tune.fit(n, b) for n, b in ((12, 5), (7, 100), (9, 0))] == \
            [jtune.fit(n, b) for n, b in ((12, 5), (7, 100), (9, 0))]
        assert tune.cache_path().name == "torch_tune_cache.json"
        assert tune.cache_path() != jtune.cache_path()
        monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "x"))
        assert tune.cache_path() == tmp_path / "x"

    def test_autotune_sweeps_then_hits_the_cache(self, tmp_path):
        calls = []

        def bench(params):
            calls.append(params["block"])
            if params["block"] == 3:
                raise ValueError("block 3 does not divide this shape")

        try:
            tune.set_cache_path(tmp_path / "t.json")
            entry = tune.autotune("op", "rows=4", {"block": [1, 2, 3]},
                                  bench)
            assert {r["params"]["block"] for r in entry["sweep"]} == {1, 2}
            assert entry["params"]["block"] in (1, 2)
            n = len(calls)
            assert tune.autotune("op", "rows=4", {"block": [1, 2, 3]},
                                 bench) == entry
            assert len(calls) == n          # a hit times nothing
            # persisted: a fresh cache object reads the winner back
            tune.set_cache_path(tmp_path / "t.json")
            assert tune.best_params("op", "rows=4",
                                    {"block": 9, "x": 1}) == \
                {"block": entry["params"]["block"], "x": 1}
            assert tune.best_params("op", "rows=5", {"block": 9}) == \
                {"block": 9}
            with pytest.raises(ValueError, match="no viable"):
                tune.autotune("op", "rows=6", {"block": [3]}, bench)
        finally:
            tune.set_cache_path(None)

    @pytest.mark.parametrize("exc", (RuntimeError("nvcc failed"),
                                     torch.cuda.OutOfMemoryError("oom"),
                                     KeyError("x")))
    def test_autotune_lets_other_errors_through(self, tmp_path, exc):
        """Only the op's refusal of a shape (ValueError) is skipped: a
        build or CUDA error propagates and nothing is cached."""
        def bench(params):
            raise exc

        try:
            cache = tune.set_cache_path(tmp_path / "t.json")
            with pytest.raises(type(exc)):
                tune.autotune("op", "rows=4", {"block": [1, 2]}, bench)
            assert cache.lookup("op", "rows=4") is None
        finally:
            tune.set_cache_path(None)


# --------------------------------------------------------------------------
# trace: seeded zipfian streams, query for query
# --------------------------------------------------------------------------
class TestTrace:
    def test_zipf_helpers_equal(self):
        for n, skew in ((16, 1.1), (5, 0.0), (1, 1.5)):
            assert tt.zipf_weights(n, skew).tolist() == \
                rt.zipf_weights(n, skew).tolist()
            h, jh = tt.zipf_hit_curve(n, skew), rt.zipf_hit_curve(n, skew)
            for f in (-1.0, 0.0, 0.1, 0.25, 0.5, 0.99, 1.0, 2.0):
                assert h(f) == jh(f)
        with pytest.raises(ValueError, match="at least one"):
            tt.zipf_weights(0, 1.0)

    @pytest.mark.parametrize("spec", [
        dict(n_queries=120, skew=1.1, seed=3),
        dict(n_queries=80, skew=0.6, seed=9, p_compound=0.6),
        dict(n_queries=150, skew=1.5, seed=7, p_grouped=0.1, p_join=0.05),
        dict(n_queries=100, skew=1.1, seed=0, p_grouped=0.3, p_join=0.3,
             tenants=3),
    ])
    def test_make_trace_query_for_query(self, ref_table, table, spec):
        ref, mine = traces(ref_table, table, **spec)
        assert [(q.tenant, canon(q.query)) for q in mine] == \
            [(q.tenant, canon(q.query)) for q in ref]
        again = tt.make_trace(table, tt.TraceSpec(**spec))
        assert [(q.tenant, canon(q.query)) for q in again] == \
            [(q.tenant, canon(q.query)) for q in mine]

    def test_dimension_tables_live_on_the_probe_device(self, table,
                                                       stores):
        spec = tt.TraceSpec(n_queries=60, seed=0, p_join=0.5)
        for t in (table, stores[3]):
            joins = [q.query for q in tt.make_trace(t, spec)
                     if isinstance(q.query, tq.HashJoin)]
            assert joins
            assert all(j.build.device == t.device for j in joins)

    def test_trace_on_two_column_table(self):
        t = tdb.Table.synthetic("two", 256, {"a": 8, "b": 8}, seed=0,
                                device="cpu")
        trace = tt.make_trace(t, tt.TraceSpec(n_queries=20, seed=0))
        assert len(trace) == 20
        assert all(len(q.query.aggregates) == 1 for q in trace)
        with pytest.raises(ValueError, match=">= 2 columns"):
            tt.make_trace(tdb.Table.synthetic("one", 8, {"a": 8},
                                              device="cpu"))


# --------------------------------------------------------------------------
# placement: the universe and the three policies
# --------------------------------------------------------------------------
class TestPlacement:
    def test_universe_covers_table_and_store(self, ref_table, table,
                                             stores):
        tiers, ttiers = tier_pairs(table.nbytes)
        _, plain, ref_encoded, encoded = stores
        for ref_t, t in ((ref_table, table), (ref_encoded, encoded)):
            jpe = rt.PlacementEngine.for_table(ref_t, tiers, "static",
                                               chunk_rows=CHUNK_ROWS)
            pe = tt.PlacementEngine.for_table(t, ttiers, "static",
                                              chunk_rows=CHUNK_ROWS)
            assert pe.total_bytes == jpe.total_bytes == t.nbytes
            assert pe.ids == jpe.ids
            assert pe.nbytes.tolist() == jpe.nbytes.tolist()
            assert pe.in_fast.tolist() == jpe.in_fast.tolist()
        assert encoded.nbytes < plain.nbytes

    def test_hot_columns_and_unknown_chunks(self, ref_table, table):
        tiers, ttiers = tier_pairs(table.nbytes)
        pe = tt.PlacementEngine.for_table(table, ttiers, "static",
                                          chunk_rows=CHUNK_ROWS,
                                          hot_columns=("c07", "c03"))
        jpe = rt.PlacementEngine.for_table(ref_table, tiers, "static",
                                           chunk_rows=CHUNK_ROWS,
                                           hot_columns=("c07", "c03"))
        assert pe.in_fast.tolist() == jpe.in_fast.tolist()
        assert {"c07", "c03"} <= {c for (c, _), i in pe.index.items()
                                  if pe.in_fast[i]}
        for call in (lambda p: p.on_access({("nope", 0): 4}),
                     lambda p: p.project({("nope", 0): 4}),
                     lambda p: p.resident(("nope", 0))):
            with pytest.raises(ValueError) as e:
                call(pe)
            with pytest.raises(ValueError) as je:
                call(jpe)
            assert str(e.value) == str(je.value)
            assert "unknown chunk" in str(e.value)
        with pytest.raises(ValueError, match="at least one chunk"):
            tt.PlacementEngine([], [], ttiers, "cache", chunk_rows=1)

    def test_static_is_pinned_once(self, table):
        _, ttiers = tier_pairs(table.nbytes)
        pe = tt.PlacementEngine.for_table(table, ttiers, "static",
                                          chunk_rows=CHUNK_ROWS)
        before = pe.in_fast.copy()
        pe.on_access({cid: int(pe.nbytes[i])
                      for cid, i in list(pe.index.items())[:40]})
        np.testing.assert_array_equal(before, pe.in_fast)

    def test_adaptive_beats_static_hit_rate(self, table):
        """tests/test_tier.py's acceptance bar, on the port: zipf(1.1),
        fast tier at 25% — CACHE and MEMCACHE beat STATIC's hit rate."""
        _, ttiers = tier_pairs(table.nbytes)
        trace = tt.make_trace(table, tt.TraceSpec(n_queries=120, skew=1.1,
                                                  seed=3))
        hit = {p: tt.replay_trace(table, trace, ttiers, p,
                                  chunk_rows=CHUNK_ROWS)[0].hit_rate
               for p in POLICIES}
        assert hit["cache"] > hit["static"]
        assert hit["memcache"] > hit["static"]


# --------------------------------------------------------------------------
# replays: the port's tiered engine against the reference's
# --------------------------------------------------------------------------
TRACE = dict(n_queries=60, skew=1.1, seed=7, p_grouped=0.1, p_join=0.05)


def reference_until_fault(ref_t, trace, tiers, policy, *, sla_s,
                          compute_w, power_cap):
    """rt.replay_trace's loop over the reference, stopped where its power
    governor refuses every service time (ROADMAP.md, queue 3: a ledger
    left at the limit reads one rounding over it in a later sum). Returns
    the engine and the RuntimeError, or None when the replay ran
    through."""
    from repro.energy import EnergyMeter as JEnergyMeter
    pe = rt.PlacementEngine.for_table(ref_t, tiers, policy,
                                      chunk_rows=CHUNK_ROWS,
                                      meter=JEnergyMeter(tiers, compute_w))
    clk = JClock()
    eng = rq.QueryEngine(ref_t, mode="xla_ref", tiered=pe, clock=clk,
                         power_cap=power_cap)
    warmup = int(len(trace) / 3)
    try:
        for i, q in enumerate(trace):
            deadline = clk() + sla_s if i >= warmup else float("inf")
            if eng.submit(q.query, deadline=deadline,
                          tenant=q.tenant) is not None:
                eng.run()
    except RuntimeError as e:
        assert "cannot be met" in str(e)
        return eng, e
    return eng, None


def replay_pair(ref_t, t, tiers_pair, trace_pair, policy, **kw):
    jkw, tkw = dict(kw), dict(kw)
    if "power_cap" in kw:
        budget, window = kw["power_cap"]
        jkw["power_cap"] = JPowerCap(budget, window)
        tkw["power_cap"] = PowerCap(budget, window)
    if kw.pop("traced", False):
        jkw.pop("traced")
        tkw.pop("traced")
        jkw["tracer"], tkw["tracer"] = JTracer(), Tracer()
    ref = rt.replay_trace(ref_t, trace_pair[0], tiers_pair[0], policy,
                          chunk_rows=CHUNK_ROWS, mode="xla_ref", **jkw)
    mine = tt.replay_trace(t, trace_pair[1], tiers_pair[1], policy,
                           chunk_rows=CHUNK_ROWS, **tkw)
    return ref, mine, jkw.get("tracer"), tkw.get("tracer")


@pytest.fixture(scope="module")
def replay_inputs(ref_table, table, stores):
    """Per table kind: the tables replayed, the plain tables the trace is
    drawn over, the tiers (25% of the plain bytes), the trace pair,
    tier_bench's deadline and, per policy, the uncapped replay's demand
    watts with the die-stacked chip's compute power."""
    compute_w = chip_compute_watts(tsystems.DIE_STACKED)
    ref_plain, plain, ref_encoded, encoded = stores
    out = {}
    for kind, tables, plains in (
            ("flat", (ref_table, table), (ref_table, table)),
            ("store", (ref_encoded, encoded), (ref_plain, plain))):
        tiers = tier_pairs(plains[1].nbytes)
        trace = traces(*plains, **TRACE)
        sla_s = sla_for(plains[0], trace[0], tiers[0])
        demand = {}
        for policy in POLICIES:
            _, jeng, _ = rt.replay_trace(tables[0], trace[0], tiers[0],
                                         policy, sla_s=sla_s,
                                         chunk_rows=CHUNK_ROWS,
                                         mode="xla_ref",
                                         compute_w=compute_w)
            demand[policy] = (jeng.summary()["energy"]["total_j"]
                              / jeng.seconds_total)
        out[kind] = {"tables": tables, "plain": plains, "tiers": tiers,
                     "trace": trace, "sla_s": sla_s, "demand": demand,
                     "compute_w": compute_w}
    return out


@pytest.mark.parametrize("variant", ("sync", "prefetch", "capped",
                                     "traced"))
@pytest.mark.parametrize("kind", ("flat", "store"))
@pytest.mark.parametrize("policy", POLICIES)
def test_replay_equals_reference(replay_inputs, policy, kind, variant):
    inp = replay_inputs[kind]
    ref_t, t = inp["tables"]
    kw = {"sla_s": inp["sla_s"]}
    if variant == "prefetch":
        kw["prefetch_bytes"] = int(inp["tiers"][1].fast.capacity // 8)
    elif variant == "capped":
        kw["compute_w"] = inp["compute_w"]
        kw["power_cap"] = (0.5 * inp["demand"][policy], 20 * inp["sla_s"])
    elif variant == "traced":
        kw["traced"] = True
        kw["prefetch_bytes"] = int(inp["tiers"][1].fast.capacity // 8)
    if variant == "capped":
        jeng, fault = reference_until_fault(
            ref_t, inp["trace"][0], inp["tiers"][0], policy,
            sla_s=inp["sla_s"], compute_w=inp["compute_w"],
            power_cap=JPowerCap(*kw["power_cap"]))
    if variant == "capped" and fault is not None:
        # the reference stopped; the port runs through, equal to it on
        # every query the reference served
        pe, eng, att = tt.replay_trace(
            t, inp["trace"][1], inp["tiers"][1], policy,
            chunk_rows=CHUNK_ROWS, sla_s=inp["sla_s"],
            compute_w=inp["compute_w"],
            power_cap=PowerCap(*kw["power_cap"]))
        n = len(jeng.results)
        assert n < len(eng.results)
        for r, jr in zip(eng.results, jeng.results):
            assert (r.qid, r.aggregates, r.tier, r.met) == \
                (jr.qid, jr.aggregates, jr.tier, jr.met)
        assert [c.as_dict() for c in pe.meter.charges[:n]] == \
            [c.as_dict() for c in jeng.tiered.meter.charges[:n]]
        assert eng.power_cap._j[:n] == jeng.power_cap._j[:n]
    else:
        ref, mine, jtracer, tracer = replay_pair(ref_t, t, inp["tiers"],
                                                 inp["trace"], policy, **kw)
        assert_replays_equal(ref, mine, jtracer, tracer)
        pe, eng, att = mine
    assert att is not None and 0.0 <= att <= 1.0
    assert len(eng.results) > 0
    if variant != "capped":     # the cap may shed every grouped query
        assert any("groups" in r.aggregates for r in eng.results)
    if variant == "capped":
        rep = eng.power_cap.report()
        assert rep["max_window_w"] <= eng.power_cap.budget_w * (1 + 1e-9)
        assert rep["segments"] == eng.summary()["served"]
    if variant in ("prefetch", "traced"):
        assert eng.prefetch.stats()["plans"] == len(eng.results)
    if variant == "traced":
        assert tracer.summary()["queries"] == len(eng.results)
        kinds = tracer.summary()["span_kinds"]
        assert kinds["read"] > 0 and kinds["compute"] == len(eng.results)


@pytest.mark.parametrize("kind", ("flat", "store"))
def test_answers_do_not_depend_on_the_policy(replay_inputs, kind):
    """Placement never changes answers: every policy gives the untiered
    engine's aggregates over the plain table, query for query."""
    inp = replay_inputs[kind]
    _, trace = inp["trace"]
    flat = tq.QueryEngine(inp["plain"][1], device="cpu")
    want = []
    for q in trace:
        flat.submit(q.query)
        want.append(flat.run()[0].aggregates)
    for policy in POLICIES:
        _, eng, _ = tt.replay_trace(inp["tables"][1], trace,
                                    inp["tiers"][1], policy,
                                    chunk_rows=CHUNK_ROWS)
        assert [r.aggregates for r in eng.results] == want, policy


def test_store_hit_rate_improves_at_fixed_capacity(replay_inputs):
    """tests/test_store.py's bar on the port: the same fast-tier bytes
    hold more of the compressed store, so its replay hits more and
    streams fewer bytes; the meter bills the physical bytes."""
    inp = replay_inputs["store"]
    _, trace = inp["trace"]
    pe_p, _, _ = tt.replay_trace(inp["plain"][1], trace, inp["tiers"][1],
                                 "cache", chunk_rows=CHUNK_ROWS)
    pe_e, eng_e, _ = tt.replay_trace(inp["tables"][1], trace,
                                     inp["tiers"][1], "cache",
                                     chunk_rows=CHUNK_ROWS)
    assert pe_e.hit_rate > pe_p.hit_rate
    assert eng_e.summary()["energy"]["memory_j"] > 0
    assert (pe_e.fast_bytes_total + pe_e.capacity_bytes_total
            < pe_p.fast_bytes_total + pe_p.capacity_bytes_total)


def test_prefetch_property_case_matches_the_reference():
    """The reference's known prefetch fault (ROADMAP.md queue 3:
    tests/test_property.py at seed=0, STATIC, buf_frac=0.375, stall=0):
    reserving the staging buffer evicts a STATIC pin that never returns,
    so the pipelined replay is modeled slower than the sync one. The port
    reproduces the reference's numbers exactly (expected, not asserted
    against); answers and demand totals stay equal, as the property
    requires."""
    ref_t = rdb.Table.synthetic("t", 2048, {f"c{i:02d}": 8
                                            for i in range(8)}, seed=0)
    t = tdb.table_from_arrays(
        {n: (np.asarray(c.words), c.code_bits, c.num_rows, c.dictionary)
         for n, c in ref_t.columns.items()}, name="t", device="cpu")
    tiers = (rt.paper_tiers(ref_t.nbytes * 0.3, fast_gbps=10.0),
             tt.paper_tiers(t.nbytes * 0.3, fast_gbps=10.0))
    trace = traces(ref_t, t, n_queries=30, seed=0)
    buf = max(1, int(tiers[1].fast.capacity * 0.375))
    out = {}
    for pf in (0, buf):
        ref, mine, _, _ = replay_pair(ref_t, t, tiers, trace, "static",
                                      prefetch_bytes=pf)
        assert_replays_equal(ref, mine)
        out[pf] = mine
    (pe0, eng0, _), (pe1, eng1, _) = out[0], out[buf]
    assert [r.aggregates for r in eng1.results] == \
        [r.aggregates for r in eng0.results]
    assert (pe1.fast_bytes_total + pe1.capacity_bytes_total
            == pe0.fast_bytes_total + pe0.capacity_bytes_total)
    assert pe1.prefetch_reserved_bytes <= tiers[1].fast.capacity
    # the reference's fault, reproduced: slower with the pipeline
    assert eng1.seconds_total > eng0.seconds_total


# --------------------------------------------------------------------------
# the engine: modeled latency, blended admission, constructor checks
# --------------------------------------------------------------------------
class TestTieredEngine:
    def engines(self, ref_table, table, policy, **kw):
        tiers, ttiers = tier_pairs(table.nbytes)
        jpe = rt.PlacementEngine.for_table(ref_table, tiers, policy,
                                           chunk_rows=CHUNK_ROWS)
        pe = tt.PlacementEngine.for_table(table, ttiers, policy,
                                          chunk_rows=CHUNK_ROWS)
        jeng = rq.QueryEngine(ref_table, mode="xla_ref", tiered=jpe,
                              clock=JClock(), **kw)
        eng = tq.QueryEngine(table, device="cpu", tiered=pe,
                             clock=VirtualClock(), **kw)
        return jeng, eng

    def test_latency_is_modeled_service(self, ref_table, table):
        jeng, eng = self.engines(ref_table, table, "cache")
        eng.submit(tq.Query(tq.Pred("c00", "lt", 64), aggregates=("c01",)))
        jeng.submit(rq.Query(rq.Pred("c00", "lt", 64),
                             aggregates=("c01",)))
        res, jres = eng.run()[0], jeng.run()[0]
        want = res.bytes_scanned / eng.tiered.tiers.capacity.bandwidth
        assert res.tier == jres.tier
        assert res.tier["service_s"] == pytest.approx(want)
        assert res.latency_s == jres.latency_s == eng.clock()
        assert eng.summary()["tier"]["policy"] == "cache"
        assert eng.summary() == jeng.summary()

    def test_admission_uses_blended_rate(self, ref_table, table):
        jeng, eng = self.engines(ref_table, table, "static")
        assert eng.measured_bps == jeng.measured_bps == \
            eng.tiered.tiers.blended(eng.tiered.resident_fast_fraction)
        q = tq.Query(tq.Pred("c00", "lt", 64), aggregates=("c01",))
        jq = rq.Query(rq.Pred("c00", "lt", 64), aggregates=("c01",))
        est = eng.bytes_scanned(q) / eng.measured_bps
        assert eng.submit(q, deadline=est * 0.5) is None
        assert jeng.submit(jq, deadline=est * 0.5) is None
        assert eng.submit(q, deadline=est * 2.0) == \
            jeng.submit(jq, deadline=est * 2.0) == 2
        assert eng.rejected == jeng.rejected == [1]
        assert eng.chunk_accesses(q) == jeng.chunk_accesses(jq)

    def test_constructor_errors_match_the_reference(self, ref_table,
                                                    table):
        tiers, ttiers = tier_pairs(table.nbytes)
        jpe = rt.PlacementEngine.for_table(ref_table, tiers, "cache",
                                           chunk_rows=CHUNK_ROWS)
        pe = tt.PlacementEngine.for_table(table, ttiers, "cache",
                                          chunk_rows=CHUNK_ROWS)
        jother = rt.PlacementEngine.for_table(ref_table, tiers, "cache",
                                              chunk_rows=CHUNK_ROWS)
        other = tt.PlacementEngine.for_table(table, ttiers, "cache",
                                             chunk_rows=CHUNK_ROWS)
        cases = [
            (dict(tracer=Tracer()), dict(tracer=JTracer())),
            (dict(prefetch=tt.PrefetchPipeline(pe, 256)),
             dict(prefetch=rt.PrefetchPipeline(jpe, 256))),
            (dict(tiered=pe, clock=VirtualClock(),
                  prefetch=tt.PrefetchPipeline(other, 256)),
             dict(tiered=jpe, clock=JClock(),
                  prefetch=rt.PrefetchPipeline(jother, 256))),
            (dict(tiered=pe), dict(tiered=jpe)),
            (dict(power_cap=PowerCap(1.0, 1.0), clock=VirtualClock()),
             dict(power_cap=JPowerCap(1.0, 1.0), clock=JClock())),
        ]
        for kw, jkw in cases:
            with pytest.raises(ValueError) as e:
                tq.QueryEngine(table, device="cpu", **kw)
            with pytest.raises(ValueError) as je:
                rq.QueryEngine(ref_table, mode="xla_ref", **jkw)
            assert str(e.value) == str(je.value)
        eng = tq.QueryEngine(table, device="cpu")
        with pytest.raises(ValueError, match="tiered"):
            eng.chunk_accesses(tq.Query(tq.Pred("c00", "lt", 4),
                                        aggregates=("c00",)))

    def test_later_steps_still_raise(self, table):
        _, ttiers = tier_pairs(table.nbytes)
        pe = tt.PlacementEngine.for_table(table, ttiers, "cache",
                                          chunk_rows=CHUNK_ROWS)
        for kw, step in ((dict(chaos=object()), "step 6b"),
                         (dict(monitor=object()), "step 6c")):
            with pytest.raises(NotImplementedError, match=step):
                tq.QueryEngine(table, device="cpu", tiered=pe,
                               clock=VirtualClock(), **kw)
            with pytest.raises(NotImplementedError, match=step):
                tt.replay_trace(table, [], ttiers, "cache",
                                chunk_rows=CHUNK_ROWS, **kw)
        eng = tq.QueryEngine(table, device="cpu", tiered=pe,
                             clock=VirtualClock())
        for fn in (eng.model_check, lambda: eng.provision(0.1)):
            with pytest.raises(NotImplementedError, match="step 7"):
                fn()

    def test_tiered_engine_checks_the_device(self, table):
        _, ttiers = tier_pairs(table.nbytes)
        pe = tt.PlacementEngine.for_table(table, ttiers, "cache",
                                          chunk_rows=CHUNK_ROWS)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tq.QueryEngine(table, tiered=pe, clock=VirtualClock())
        with pytest.raises(ValueError, match="mode='cuda'"):
            tt.replay_trace(table, [], ttiers, "cache",
                            chunk_rows=CHUNK_ROWS, mode="cuda")


# --------------------------------------------------------------------------
# the prefetch pipeline (tests/test_tier.py::TestPrefetch, both packages)
# --------------------------------------------------------------------------
class TestPrefetch:
    B = 1000
    CHUNKS = {("c", 0): 1000, ("c", 1): 1000, ("c", 2): 1000}

    def pes(self, policy="static", fast_capacity=2000, pin=(0,)):
        ids = [("c", 0), ("c", 1), ("c", 2)]
        return tuple(mod.PlacementEngine(
            ids, [self.B] * 3, mod.paper_tiers(fast_capacity,
                                               fast_gbps=10.0),
            policy, chunk_rows=256, pin_order=list(pin)) for mod in (rt, tt))

    @staticmethod
    def plan_fields(plan):
        return (plan.service_s, plan.sync_service_s, plan.staged_bytes,
                plan.stalled_bytes, plan.cancelled_bytes, plan.staged_cids,
                plan.n_staged, plan.n_stalled, plan.n_cancelled,
                [vars(s) for s in plan.stages], plan.used,
                plan.overlap_saved_s)

    @pytest.mark.parametrize("case", ("max_per_stage", "small_buffer",
                                      "memcache_first_touch", "demoted",
                                      "stall", "reservation_evicts"))
    def test_plans_and_ledgers_equal(self, case):
        policy = {"memcache_first_touch": "memcache",
                  "reservation_evicts": "cache"}.get(case, "static")
        pin = () if policy != "static" else (0,)
        jpe, pe = self.pes(policy, pin=pin)
        if case == "reservation_evicts":
            for p in (jpe, pe):
                p.on_access({("c", 0): self.B, ("c", 1): self.B})
        buf = self.B // 2 if case == "small_buffer" else self.B
        jpf, pf = rt.PrefetchPipeline(jpe, buf), tt.PrefetchPipeline(pe,
                                                                     buf)
        assert pe.in_fast.tolist() == jpe.in_fast.tolist()
        assert pe.budget.remaining == jpe.budget.remaining
        if case == "demoted":
            jpe.demoted = pe.demoted = True
        stalled = ((lambda cid: cid == ("c", 2)) if case == "stall"
                   else None)
        for step in range(2):
            jplan = jpf.plan(self.CHUNKS, stalled=stalled)
            plan = pf.plan(self.CHUNKS, stalled=stalled)
            assert self.plan_fields(plan) == self.plan_fields(jplan)
            assert plan.service_s <= plan.sync_service_s
            jpf.begin(jplan, self.CHUNKS)
            pf.begin(plan, self.CHUNKS)
            assert pe.project(self.CHUNKS).fast_bytes == \
                jpe.project(self.CHUNKS).fast_bytes
            acc = pe.on_access(self.CHUNKS, qid=step, tenant=0)
            jacc = jpe.on_access(self.CHUNKS, qid=step, tenant=0)
            assert (acc.fast_bytes, acc.capacity_bytes, acc.n_hit,
                    acc.n_miss) == (jacc.fast_bytes, jacc.capacity_bytes,
                                    jacc.n_hit, jacc.n_miss)
            line, jline = (pf.finish(plan, qid=step, tenant=0),
                           jpf.finish(jplan, qid=step, tenant=0))
            assert (line is None) == (jline is None)
            if line is not None:
                assert line.as_dict() == jline.as_dict()
        assert pf.stats() == jpf.stats()
        assert pe.stats() == jpe.stats()
        assert [c.as_dict() for c in pe.meter.charges] == \
            [c.as_dict() for c in jpe.meter.charges]
        pf.close()
        jpf.close()
        assert pe.prefetch_reserved_bytes == jpe.prefetch_reserved_bytes \
            == 0

    def test_reservation_bounded(self):
        jpe, pe = self.pes()
        for mod, p in ((rt, jpe), (tt, pe)):
            with pytest.raises(ValueError, match="exceeds fast tier"):
                mod.PrefetchPipeline(p, 10_000)
            with pytest.raises(ValueError, match="must be > 0"):
                p.reserve_prefetch(0)
        with pytest.raises(ValueError, match="prefetch bytes"):
            pe.charge_prefetch(-1, 0)
        with pytest.raises(ValueError, match="recovery bytes"):
            pe.charge_recovery(0, -1)
        assert pe.charge_prefetch(0, 0) is None
        line = pe.charge_recovery(10, 20, qid=3, tenant=1)
        jline = jpe.charge_recovery(10, 20, qid=3, tenant=1)
        assert line.as_dict() == jline.as_dict()
        assert pe.stats() == jpe.stats()


def test_tier_results_are_finite(replay_inputs):
    """Every modeled number of a capped replay is finite and in range."""
    inp = replay_inputs["flat"]
    _, eng, _ = tt.replay_trace(
        inp["tables"][1], inp["trace"][1], inp["tiers"][1], "memcache",
        sla_s=inp["sla_s"], chunk_rows=CHUNK_ROWS,
        compute_w=inp["compute_w"],
        power_cap=PowerCap(0.5 * inp["demand"]["memcache"],
                           20 * inp["sla_s"]))
    for r in eng.results:
        assert all(math.isfinite(v) for v in r.tier.values())
        assert 0.0 <= r.tier["hit_fraction"] <= 1.0
        assert r.tier["throttle_s"] >= 0.0
