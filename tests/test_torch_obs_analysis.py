"""Parity of the port's observability analysis (repro_torch.obs:
critical_path, slo, timeseries, export's waterfall, diff) and of
core.advisor.whatif_fast_fraction over the port's Attribution, with the
reference on the CPU.

Every scenario of tests/test_obs_analysis.py runs through both packages
from the same seeds (reference mode="xla_ref", the port's "torch_ref" on
the CPU), and what each returns is compared with ==: every CriticalPath
and Attribution field, the SLO monitor's alerts (alerts_json byte for
byte), summary()["slo"], error budgets and sampled series, digests,
diff reports, the what-if table. The port's waterfall must also equal
tests/golden/waterfall_plain.txt, which this file only reads. Invalid
rules and tampered traces raise the reference's errors with its
messages. A monitored replay under a power cap is held against the
reference where the reference's governor runs through (the flat table
below; ROADMAP.md queue 3 names where it does not).

tests/test_obs_analysis.py's two `check_regress` tests drive
benchmarks/, which the port does not carry; they have no counterpart
here.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, os.path.dirname(__file__))

# `sides` is test_torch_obs's (reference, port) module fixture, shared
from test_torch_obs import (CHUNK_ROWS, assert_json_safe,  # noqa: E402,F401
                            both, make_table, prefetch_engine, run_queries,
                            sides, spans, tiered_engine)

GOLDEN = Path(__file__).parent / "golden"


def module(S, name: str):
    """`name` under the side's package root (repro or repro_torch)."""
    return importlib.import_module(f"{S.obs.__name__.split('.')[0]}.{name}")


def monitored_chaos_run(S, n_queries=40):
    """tests/test_obs_analysis.py's seeded fault replay with a monitor and
    a tracer; fresh state per call."""
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
    bytes_typ = sum(
        S.physical.referenced_bytes(tq.query.plan(), tq.query.aggregates,
                                    enc.columns)
        for tq in qtrace) / len(qtrace)
    sla_s = 2.5 * bytes_typ / tiers.fast.bandwidth
    tracer = S.obs.Tracer()
    monitor = S.obs.SLOMonitor(target=0.9, cadence_s=sla_s / 2)
    pe, eng, att = S.replay_trace(
        enc, qtrace, tiers, S.Policy.CACHE, sla_s=sla_s,
        chunk_rows=CHUNK_ROWS, chaos=chaos,
        prefetch_bytes=table.nbytes // 16, tracer=tracer, monitor=monitor,
        **S.replay_kw)
    monitor.tick(eng.clock() + monitor.max_window_s)
    return monitor, tracer, pe, eng, att


def attribution(attr) -> dict:
    """An Attribution as plain data: every field, every path's segments
    and verdicts, the fractions and the rendering."""
    return {**dataclasses.asdict(attr), "ok": attr.ok,
            "total_s": attr.total_s, "miss_total_s": attr.miss_total_s,
            "fractions": attr.fractions(),
            "miss_fractions": attr.fractions(missed_only=True),
            "render": attr.render(),
            "paths_ok": [(cp.ok, cp.total_s, cp.seconds_by_category())
                         for cp in attr.paths]}


def monitor_state(mon) -> dict:
    """Everything an SLOMonitor exposes, as plain data."""
    return {"alerts_json": mon.alerts_json(),
            "alerts": [a.as_dict() for a in mon.alerts],
            "summary": mon.summary(),
            "budgets": {t: mon.error_budget(t) for t in mon.tenants},
            "series": {k: s.as_dict() for k, s in sorted(mon.series.items())},
            "tenants": {t: (led.events, led.errors,
                            led.events_series.as_dict(),
                            led.errors_series.as_dict())
                        for t, led in sorted(mon.tenants.items())}}


# --------------------------------------------------------------------------
# critical-path reconciliation across execution paths
# --------------------------------------------------------------------------

def _assert_paths_close(S, attr, tracer):
    """tests/test_obs_analysis.py's closure claims, on one side."""
    assert attr.ok, attr.problems
    for cp, qt in zip(attr.paths, tracer.queries):
        assert cp.ok, cp.problems
        assert set(cp.seconds_by_category()) <= \
            set(module(S, "obs.critical_path").CATEGORIES)
        path_s = sum(seg.dur_s for seg in cp.segments)
        assert path_s == pytest.approx(qt.t_end - qt.submitted_at,
                                       rel=1e-9, abs=1e-12)
        got = dict(cp.on_path_bytes)
        for key, n in cp.off_path_bytes.items():
            got[key] = got.get(key, 0) + n
        assert got == qt.bytes_by_ledger()


@pytest.mark.parametrize("path", ("plain", "encoded", "sharded", "grouped",
                                  "prefetch"))
def test_critical_path_equals_the_reference(sides, path):
    def run(S):
        if path == "prefetch":
            eng, pe, _, tracer = prefetch_engine(S)
            run_queries(S, eng, n=6)
        else:
            table = make_table(S)
            if path in ("encoded", "grouped"):
                table = S.EncodedTable.from_table(table,
                                                  chunk_rows=CHUNK_ROWS)
            elif path == "sharded":
                table = S.ShardedTable.shard(table, S.mesh())
            eng, pe, tracer = tiered_engine(S, table)
            if path == "grouped":
                q = S.GroupBy(keys=("c00",), aggs=("c01",),
                              where=S.Pred("c02", "ge", 4))
                assert eng.submit(q, deadline=eng.clock() + 100.0)
                eng.run()
            else:
                run_queries(S, eng)
        attr = S.obs.verify(tracer, pe.meter)
        _assert_paths_close(S, attr, tracer)
        return attribution(attr), spans(tracer), tracer
    (want, jspans, _), (got, tspans, tracer) = both(sides, run)
    assert tspans == jspans
    assert got == want
    if path == "plain":
        assert got["queries"] == 4 and got["missed"] == 0
        assert all(any(seg["category"] == "queue" for seg in cp["segments"])
                   for cp in got["paths"])
        assert set(got["seconds"]) <= {"queue", "fast_read",
                                       "capacity_read"}
    if path == "grouped":
        assert tracer.queries[0].shape == "grouped"
        assert all(shape == "grouped" for shape, _ in got["shape_seconds"])
    if path == "prefetch":
        for cp, qt in zip(got["paths"], tracer.queries):
            span_sum = sum(sp.dur_s for sp in qt.spans
                           if sp.kind in ("read", "prefetch_read"))
            assert sum(s["dur_s"] for s in cp["segments"]) <= \
                span_sum + 1e-12


def test_critical_path_chaos(sides):
    def run(S):
        monitor, tracer, pe, eng, att = monitored_chaos_run(S)
        attr = S.obs.verify(tracer, pe.meter)
        _assert_paths_close(S, attr, tracer)
        return (attribution(attr), monitor_state(monitor), att,
                list(eng.rejected), eng.summary())
    want, got = both(sides, run)
    assert got == want
    attr, mon, att, rejected, summary = got
    assert attr["seconds"].get("recovery", 0.0) > 0.0
    assert rejected and att < 1.0
    assert any(errors for _, errors, _, _ in mon["tenants"].values())
    assert abs(sum(attr["fractions"].values()) - 1.0) < 1e-9
    assert "SLA-missed" in attr["render"]
    assert summary["slo"] == mon["summary"]


def test_critical_path_flags_tampered_trace(sides):
    def run(S):
        eng, pe, tracer = tiered_engine(S, make_table(S))
        run_queries(S, eng, n=2)
        S.obs.verify(tracer, pe.meter)
        qt = tracer.queries[0]
        qt.spans[:] = [sp for sp in qt.spans if sp.kind != "admission"]
        cp = S.obs.critical_path(qt)
        with pytest.raises(S.obs.ConservationError, match="admission") as e:
            S.obs.verify(tracer, pe.meter)
        return dataclasses.asdict(cp), cp.ok, str(e.value)
    want, got = both(sides, run)
    assert got == want
    assert not got[1] and any("admission" in p for p in got[0]["problems"])


def test_critical_path_unserved_query(sides):
    def run(S):
        qt = SimpleNamespace(qid=7, tenant=0, shape="scan", met=None,
                             degraded=False, submitted_at=1.0, t_start=None,
                             t_end=None, spans=[], reads=[])
        cp = S.obs.critical_path(qt)
        return dataclasses.asdict(cp), cp.ok, cp.total_s
    want, got = both(sides, run)
    assert got == want
    assert not got[1] and got[2] == 0.0
    assert any("never served" in p for p in got[0]["problems"])


# --------------------------------------------------------------------------
# SLO burn-rate monitoring
# --------------------------------------------------------------------------

def test_slo_alerts_byte_identical_across_replays(sides):
    ref, port = sides
    m1 = monitored_chaos_run(port)[0]
    m2 = monitored_chaos_run(port)[0]
    assert m1.alerts_json() == m2.alerts_json()
    assert len(m1.alerts) > 0, "chaos run burned no budget — dead test"
    for a in m1.alerts:
        k = round(a.t / m1.cadence_s)
        assert a.t == k * m1.cadence_s
    jm = monitored_chaos_run(ref)[0]
    assert m1.alerts_json() == jm.alerts_json()
    assert monitor_state(m1) == monitor_state(jm)


def test_slo_fire_and_resolve(sides):
    def run(S):
        mon = S.obs.SLOMonitor(target=0.9, cadence_s=1.0)
        mon.tick(0.0)
        mon.observe(SimpleNamespace(met=False))
        fired = [a.as_dict() for a in mon.tick(1.0)]
        for _ in range(40):
            mon.observe(SimpleNamespace(met=True))
        resolved = [a.as_dict() for a in mon.tick(3.0)]
        return fired, resolved, monitor_state(mon)
    want, got = both(sides, run)
    assert got == want
    fired, resolved, state = got
    assert [a["kind"] for a in fired] == ["fire", "fire"]
    assert {a["rule"] for a in fired} == {"fast_burn", "slow_burn"}
    assert fired[0]["t"] == 1.0
    assert fired[0]["burn_long"] == pytest.approx(10.0)
    assert [a["kind"] for a in resolved] == ["resolve", "resolve"]
    assert state["summary"]["firing"] == []
    assert state["budgets"][0]["events"] == 41
    assert state["budgets"][0]["errors"] == 1


def test_slo_rejection_burns_budget(sides):
    def run(S):
        mon = S.obs.SLOMonitor(target=0.9, cadence_s=1.0)
        mon.observe_rejected(tenant=3)
        return mon.error_budget(3), mon.error_budget(99)
    want, got = both(sides, run)
    assert got == want
    assert got[0]["events"] == 1 and got[0]["errors"] == 1
    assert got[0]["remaining_fraction"] < 0
    assert got[1]["remaining_fraction"] == 1.0


def test_slo_engine_rejection_and_gauges(sides):
    def run(S):
        mon = S.obs.SLOMonitor(target=0.9, cadence_s=1e-5)
        eng, pe, tracer = tiered_engine(S, make_table(S), monitor=mon)
        run_queries(S, eng, n=4)
        q = S.Query(S.Pred("c00", "ge", 10), aggregates=("c01",))
        assert eng.submit(q, deadline=eng.clock()) is None
        return monitor_state(mon), eng.summary()["slo"], mon._next_tick
    want, got = both(sides, run)
    assert got == want
    state, slo, ticks = got
    assert state["tenants"][0][:2] == (5, 1)
    assert state["series"]["hit_rate"]["n"] > 0
    assert state["series"]["blended_gbps"]["v"][-1] > 0
    assert "watts" not in state["series"]
    assert slo["ticks"] == ticks


def test_slo_samples_the_power_cap(sides):
    """A monitored prefetch engine under a power cap: the watts and cap_w
    series equal the reference's. The reference's governor runs through
    this stream (it raises only where a window left at the limit reads one
    rounding over it; ROADMAP.md queue 3)."""
    def run(S):
        mon = S.obs.SLOMonitor(target=0.9, cadence_s=1e-6)
        table = make_table(S)
        tiers = S.paper_tiers(table.nbytes * 0.25, fast_gbps=10.0)
        pe = S.PlacementEngine.for_table(
            table, tiers, S.Policy.CACHE, chunk_rows=CHUNK_ROWS,
            meter=S.EnergyMeter(tiers, 7.5))
        cap = module(S, "energy").PowerCap(6.0, window_s=4e-6)
        eng = S.QueryEngine(table, tiered=pe, clock=S.Clock(),
                            power_cap=cap, monitor=mon,
                            tracer=S.obs.Tracer(), **S.eng_kw)
        run_queries(S, eng, n=6)
        S.obs.verify(eng.tracer, pe.meter)
        return (monitor_state(mon), cap.report(now=eng.clock()),
                S.obs.chrome_trace_json(eng.tracer))
    want, got = both(sides, run)
    assert got == want
    state, rep, _ = got
    assert state["series"]["cap_w"]["v"] == \
        [6.0] * state["series"]["cap_w"]["n"]
    assert state["series"]["watts"]["n"] > 0
    assert rep["throttled_queries"] > 0


def test_slo_monitor_requires_tiered(sides):
    def run(S):
        with pytest.raises(ValueError, match="tiered") as e:
            S.QueryEngine(make_table(S), monitor=S.obs.SLOMonitor(),
                          **S.eng_kw)
        return str(e.value)
    want, got = both(sides, run)
    assert got == want


def test_slo_validation(sides):
    def run(S):
        out = []
        for make, match in (
                (lambda: S.obs.SLOMonitor(target=1.0), "target"),
                (lambda: S.obs.SLOMonitor(cadence_s=0.0), "cadence"),
                (lambda: S.obs.BurnRateRule("bad", long_s=1.0, short_s=2.0,
                                            threshold=1.0), "short window"),
                (lambda: S.obs.BurnRateRule("bad", long_s=1.0, short_s=0.5,
                                            threshold=0.0), "positive")):
            with pytest.raises(ValueError, match=match) as e:
                make()
            out.append(str(e.value))
        fast, slow = S.obs.default_rules(0.01)
        return out, dataclasses.asdict(fast), dataclasses.asdict(slow)
    want, got = both(sides, run)
    assert got == want
    assert got[1]["long_s"] == 0.16 and got[2]["threshold"] == 1.5


# --------------------------------------------------------------------------
# ring series + percentile/histogram edge cases
# --------------------------------------------------------------------------

def test_ring_series_basics(sides):
    def run(S):
        s = S.obs.RingSeries("x", capacity=3)
        out = [s.last, s.last_t, s.at_or_before(10.0)]
        for i in range(4):
            s.push(float(i), float(i * 10))
        out += [len(s), s.at_or_before(0.5), s.at_or_before(2.5), s.last,
                s.last_t, s.window(1.0, 3.0), s.window_mean(1.0, 3.0),
                s.window_mean(90.0, 99.0), s.as_dict()]
        for bad, match in ((lambda: s.push(2.0, 0.0), "before"),
                           (lambda: S.obs.RingSeries("x", capacity=0),
                            "capacity")):
            with pytest.raises(ValueError, match=match) as e:
                bad()
            out.append(str(e.value))
        return out
    want, got = both(sides, run)
    assert got == want
    assert got[:3] == [None, None, None]
    assert got[3:12] == [3, None, 20.0, 30.0, 3.0,
                         [(2.0, 20.0), (3.0, 30.0)], 25.0, 0.0,
                         {"name": "x", "n": 3, "t": [1.0, 2.0, 3.0],
                          "v": [10.0, 20.0, 30.0]}]


def test_latency_percentile_edges(sides):
    def run(S):
        p = S.latency_percentile
        return ([p([], 99)] + [p([0.7], q) for q in (0, 50, 99, 100)]
                + [p([3.3] * 5, 99), p([1.0, 2.0, 3.0], 50)])
    want, got = both(sides, run)
    assert got == want == [0.0, 0.7, 0.7, 0.7, 0.7, 3.3, 2.0]


def test_histogram_edges(sides):
    def run(S):
        h = S.metrics.Histogram("lat")
        out = [h.mean, h.as_dict()]
        h.observe(2.5)
        out.append(h.as_dict())
        h2 = S.metrics.Histogram("eq")
        for _ in range(4):
            h2.observe(1.25)
        out += [h2.mean, h2.vmin, h2.vmax]
        with pytest.raises(ValueError, match="finite") as e:
            h.observe(float("nan"))
        return out + [str(e.value)]
    want, got = both(sides, run)
    assert got == want
    assert got[1] == {"count": 0, "sum": 0.0, "mean": 0.0, "min": None,
                      "max": None}
    assert got[3:6] == [1.25, 1.25, 1.25]


# --------------------------------------------------------------------------
# export: golden waterfall + Perfetto schema invariants
# --------------------------------------------------------------------------

def test_waterfall_matches_golden(sides):
    def run(S):
        eng, pe, tracer = tiered_engine(S, make_table(S))
        run_queries(S, eng, n=2)
        return S.obs.waterfall_query(tracer.queries[0], width=40) + "\n"
    want, got = both(sides, run)
    assert got == want
    assert got == (GOLDEN / "waterfall_plain.txt").read_text()


def test_chrome_trace_schema(sides):
    def run(S):
        return S.obs.chrome_trace_json(monitored_chaos_run(S, 20)[1])
    want, j = both(sides, run)
    assert j == want
    doc = json.loads(j)
    assert j == json.dumps(doc, sort_keys=True, separators=(",", ":"))
    phs = [e["ph"] for e in doc["traceEvents"]]
    assert phs.index("X") == len([p for p in phs if p == "M"])
    lanes = {}
    for e in doc["traceEvents"]:
        if e["ph"] != "X":
            continue
        last = lanes.get((e["pid"], e["tid"]))
        assert last is None or e["ts"] >= last, \
            f"lane {(e['pid'], e['tid'])} went backwards at {e['name']}"
        lanes[(e["pid"], e["tid"])] = e["ts"]
    assert len(lanes) > 2


# --------------------------------------------------------------------------
# trace-diff digests
# --------------------------------------------------------------------------

def test_digest_exact_and_derived(sides):
    def run(S):
        eng, pe, tracer = tiered_engine(S, make_table(S))
        run_queries(S, eng)
        d, d2 = S.obs.digest(eng, tracer), S.obs.digest(eng)
        return d, d2, json.dumps(d, sort_keys=True), \
            json.dumps(d2, sort_keys=True)
    want, got = both(sides, run)
    assert got == want
    d, d2, _, _ = got
    assert_json_safe(d)
    assert_json_safe(d2)
    assert d["v"] == 1 and d["exact"] and d["queries"] == 4
    assert d["snapshot"]["sla.served"] == 4
    assert any(k.startswith("scan/") for k in d["categories"])
    assert not d2["exact"]
    assert all(k.startswith("all/") for k in d2["categories"])
    assert d2["categories"]["all/fast_read"] > 0


def _diff(rep) -> dict:
    return {**dataclasses.asdict(rep), "render": rep.render(),
            "delta_total_s": rep.delta_total_s,
            "dominant": (None if rep.dominant() is None
                         else dataclasses.asdict(rep.dominant())),
            "keys": [(r.key, r.ratio) for r in rep.rows]}


def test_diff_names_dominant_category(sides):
    def run(S):
        base_eng, _, base_tr = tiered_engine(S, make_table(S),
                                             fast_frac=0.5)
        run_queries(S, base_eng)
        new_eng, _, new_tr = tiered_engine(S, make_table(S),
                                           fast_frac=0.125)
        run_queries(S, new_eng)
        return (_diff(S.obs.diff_traces(base_tr, new_tr)),
                _diff(S.obs.diff_digests(S.obs.digest(base_eng, base_tr),
                                         S.obs.digest(new_eng, new_tr))))
    want, got = both(sides, run)
    assert got == want
    rep, rep2 = got
    assert rep["exact"]
    dom = rep["dominant"]
    assert dom is not None and dom["category"] == "capacity_read"
    assert dom["delta_s"] > 0 and rep["delta_total_s"] > 0
    key = f"{dom['shape']}/{dom['category']}"
    assert f"dominant regression: {key}" in rep["render"]
    row = {f"{r['shape']}/{r['category']}": r for r in rep2["rows"]}[key]
    assert row["delta_s"] == pytest.approx(dom["delta_s"], rel=1e-12)


def test_diff_no_regression(sides):
    def run(S):
        eng, _, tr = tiered_engine(S, make_table(S))
        run_queries(S, eng)
        return _diff(S.obs.diff_traces(tr, tr))
    want, got = both(sides, run)
    assert got == want
    assert got["dominant"] is None and got["delta_total_s"] == 0.0
    assert "no category regressed" in got["render"]


# --------------------------------------------------------------------------
# the what-if hook, fed each package's Attribution
# --------------------------------------------------------------------------

def test_whatif_consistent_with_surface(sides):
    def run(S):
        monitor, tracer, pe, eng, att = monitored_chaos_run(S)
        attr = S.obs.attribute(tracer)
        bytes_q = (sum(r.bytes_scanned for r in eng.results)
                   / len(eng.results))
        return S.whatif(
            attr, db_bytes=pe.tiers.fast.capacity / 0.25,
            bytes_per_query=bytes_q, sla_s=10.0, current_fraction=0.25,
            hit_curve=S.zipf_hit_curve(8, 1.2), fast_gbps=pe.tiers.fast.gbps,
            capacity_gbps=pe.tiers.capacity.gbps)
    want, wi = both(sides, run)
    assert wi == want
    assert wi["current"]["read_s"] > 0
    rows = wi["rows"]
    assert [r["fast_fraction"] for r in rows] \
        == sorted(r["fast_fraction"] for r in rows)
    est = [r["est_read_s"] for r in rows]
    assert all(a >= b - 1e-15 for a, b in zip(est, est[1:]))
    assert wi["best"] is not None and wi["best"]["meets_sla"]


def test_whatif_rejects_bad_inputs(sides):
    def run(S):
        out = []
        for seconds, frac, match in (({"queue": 5.0}, 0.5, "read-bound"),
                                     ({"fast_read": 1.0}, 1.5,
                                      "current_fraction")):
            with pytest.raises(ValueError, match=match) as e:
                S.whatif(seconds, db_bytes=1e9, bytes_per_query=1e6,
                         sla_s=0.01, current_fraction=frac,
                         hit_curve=S.zipf_hit_curve(8, 1.2),
                         fast_gbps=10.0, capacity_gbps=1.0)
            out.append(str(e.value))
        return out
    want, got = both(sides, run)
    assert got == want
