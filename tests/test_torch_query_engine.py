"""Parity of the port's query engine with repro.query.QueryEngine on the CPU.

Both engines answer the same plans over the same table — the port's built
from the same seed (Table.synthetic) and from the reference table's
exported words (table_from_arrays) — and must agree exactly: aggregates,
count, selectivity, bytes, logical bytes and per-engine launch counts.
A numpy oracle over the decoded values checks both.
"""
import numpy as np
import pytest
import torch

import repro.db as rdb
import repro.query as rq
import repro_torch.db as tdb
import repro_torch.query as tq
from repro.db.queries import bytes_scanned as j_bytes_scanned
from repro.db.queries import scan_aggregate_query as j_scan_aggregate_query
from repro.db.queries import scan_query as j_scan_query
from repro_torch.db.queries import bytes_scanned, scan_aggregate_query, \
    scan_query
from repro_torch.query import physical

N_ROWS = 10_001         # every column carries tail padding
SPEC = {"a": 8, "b": 8, "w": 16, "x": 4}
SEED = 3

# (name, plan factory over a query module, numpy selection, aggregates):
# the plan shapes of tests/test_query_engine.py
PLAN_SHAPES = [
    ("single_pred_fused", lambda q: q.Pred("a", "lt", 50),
     lambda d: d["a"] < 50, ("b",)),
    ("fused_ge", lambda q: q.Pred("a", "ge", 100),
     lambda d: d["a"] >= 100, ("b",)),
    ("fused_gt", lambda q: q.Pred("a", "gt", 100),
     lambda d: d["a"] > 100, ("b",)),
    ("fused_eq", lambda q: q.Pred("a", "eq", 64),
     lambda d: d["a"] == 64, ("b",)),
    ("fused_ne", lambda q: q.Pred("a", "ne", 64),
     lambda d: d["a"] != 64, ("b",)),
    ("and_same_width",
     lambda q: q.Pred("a", "lt", 50) & q.Pred("b", "ge", 100),
     lambda d: (d["a"] < 50) & (d["b"] >= 100), ("b",)),
    ("and_mixed_width",
     lambda q: q.Pred("a", "lt", 50) & q.Pred("w", "ge", 9000),
     lambda d: (d["a"] < 50) & (d["w"] >= 9000), ("w",)),
    ("or_mixed_width",
     lambda q: q.Pred("x", "eq", 3) | q.Pred("w", "lt", 500),
     lambda d: (d["x"] == 3) | (d["w"] < 500), ("a",)),
    ("nested_and_or",
     lambda q: q.And.of(q.Or.of(q.Pred("a", "le", 20),
                                q.Pred("b", "gt", 120)),
                        q.Pred("x", "ne", 0)),
     lambda d: ((d["a"] <= 20) | (d["b"] > 120)) & (d["x"] != 0), ("b",)),
    ("multi_agg_mixed", lambda q: q.Pred("a", "ge", 64),
     lambda d: d["a"] >= 64, ("b", "w", "x")),
    ("empty_selection", lambda q: q.Pred("x", "gt", 7),
     lambda d: d["x"] > 7, ("a",)),
]


def export(table):
    """A reference table's state, as table_from_arrays takes it."""
    return {n: (np.asarray(c.words), c.code_bits, c.num_rows, c.dictionary)
            for n, c in table.columns.items()}


@pytest.fixture(scope="module")
def ref_table():
    return rdb.Table.synthetic("t", N_ROWS, SPEC, seed=SEED)


@pytest.fixture(scope="module", params=("synthetic", "from_arrays"))
def table(request, ref_table):
    if request.param == "synthetic":
        return tdb.Table.synthetic("t", N_ROWS, SPEC, seed=SEED,
                                   device="cpu")
    return tdb.table_from_arrays(export(ref_table), name="t", device="cpu")


@pytest.fixture(scope="module")
def decoded(ref_table):
    return {c: ref_table.columns[c].decode() for c in SPEC}


def oracle(decoded, sel, agg):
    vals = decoded[agg][sel]
    vmax = (1 << (SPEC[agg] - 1)) - 1
    return {"sum": int(vals.sum()) if sel.any() else 0,
            "count": int(sel.sum()),
            "min": int(vals.min()) if sel.any() else vmax,
            "max": int(vals.max()) if sel.any() else 0}


def run_one(engine, query):
    engine.submit(query)
    return engine.run()[0]


def test_tables_bit_identical_to_reference(table, ref_table):
    for name, col in ref_table.columns.items():
        tcol = table.columns[name]
        assert tcol.code_bits == col.code_bits
        assert tcol.num_rows == col.num_rows
        assert tcol.words.dtype == torch.int32
        np.testing.assert_array_equal(tcol.words.numpy().view(np.uint32),
                                      np.asarray(col.words))
        np.testing.assert_array_equal(
            tcol.valid_words.numpy().view(np.uint32),
            np.asarray(col.valid_words))
        np.testing.assert_array_equal(tcol.decode(), col.decode())
    assert table.nbytes == ref_table.nbytes
    assert table.num_rows == ref_table.num_rows


@pytest.mark.parametrize("name,mkplan,mksel,aggs", PLAN_SHAPES,
                         ids=[p[0] for p in PLAN_SHAPES])
def test_plan_shape_parity_with_reference(table, ref_table, decoded, name,
                                          mkplan, mksel, aggs):
    sel = mksel(decoded)
    want = {a: oracle(decoded, sel, a) for a in aggs}
    jeng = rq.QueryEngine(ref_table, mode="xla_ref")
    jres = run_one(jeng, rq.Query(mkplan(rq), aggregates=aggs))
    assert jres.aggregates == want
    for mode in ("auto", "torch_ref"):
        teng = tq.QueryEngine(table, mode=mode, device="cpu")
        tres = run_one(teng, tq.Query(mkplan(tq), aggregates=aggs))
        assert tres.aggregates == want, mode
        assert tres.count == jres.count == int(sel.sum())
        assert tres.selectivity == jres.selectivity
        assert tres.bytes_scanned == jres.bytes_scanned
        assert tres.logical_bytes == jres.logical_bytes
        assert teng.metrics.launch_counts() == jeng.metrics.launch_counts()
        assert teng.bytes_total == jeng.bytes_total
        assert tres.met and not tres.degraded and tres.tier is None


@pytest.mark.parametrize("name,mkplan,mksel,aggs",
                         [p for p in PLAN_SHAPES if p[0] in (
                             "single_pred_fused", "nested_and_or",
                             "multi_agg_mixed")],
                         ids=["single_pred_fused", "nested_and_or",
                              "multi_agg_mixed"])
def test_launch_counts_match_reference_kernel_mode(table, ref_table, name,
                                                   mkplan, mksel, aggs):
    """The reference's Pallas mode counts the same launches per query."""
    jeng = rq.QueryEngine(ref_table, mode="pallas")
    jres = run_one(jeng, rq.Query(mkplan(rq), aggregates=aggs))
    teng = tq.QueryEngine(table, device="cpu")
    tres = run_one(teng, tq.Query(mkplan(tq), aggregates=aggs))
    assert tres.aggregates == jres.aggregates
    assert teng.metrics.launch_counts() == jeng.metrics.launch_counts()


def test_empty_table_returns_identity():
    t = tdb.Table.synthetic("empty", 0, {"a": 8, "b": 8}, device="cpu")
    jt = rdb.Table.synthetic("empty", 0, {"a": 8, "b": 8})
    q = tq.Query(tq.Pred("a", "lt", 5), aggregates=("b",))
    res = run_one(tq.QueryEngine(t, device="cpu"), q)
    jres = run_one(rq.QueryEngine(jt, mode="xla_ref"),
                   rq.Query(rq.Pred("a", "lt", 5), aggregates=("b",)))
    assert res.aggregates == jres.aggregates == {
        "b": {"sum": 0, "count": 0, "min": 127, "max": 0}}
    assert res.count == 0 and res.selectivity == 0


def test_engine_sum_exact_beyond_int32():
    t = tdb.Table.synthetic("big", 300_000, {"p": 16}, seed=5, device="cpu")
    jt = rdb.Table.synthetic("big", 300_000, {"p": 16}, seed=5)
    want = int(jt.columns["p"].decode().astype(np.int64).sum())
    assert want > 2**31
    res = run_one(tq.QueryEngine(t, device="cpu"),
                  tq.Query(tq.Pred("p", "ge", 0), aggregates=("p",)))
    jres = run_one(rq.QueryEngine(jt, mode="xla_ref"),
                   rq.Query(rq.Pred("p", "ge", 0), aggregates=("p",)))
    assert res.aggregates == jres.aggregates
    assert res.aggregates["p"]["sum"] == want and res.count == 300_000


class TestLegacyWrappers:
    def test_scan_query_mask_matches_reference(self, table, ref_table):
        for preds in ([(("a", "lt", 50)), ("w", "ge", 9000)],
                      [("x", "eq", 3), ("b", "gt", 7)]):
            got = scan_query(table, [tq.Pred(*p) for p in preds])
            want = j_scan_query(ref_table, [rq.Pred(*p) for p in preds],
                                mode="xla_ref")
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          np.asarray(want))

    def test_scan_aggregate_query_and_bytes(self, table, ref_table):
        got = scan_aggregate_query(table, [tq.Pred("a", "le", 90)], "w")
        want = j_scan_aggregate_query(ref_table, [rq.Pred("a", "le", 90)],
                                      "w", mode="xla_ref")
        assert got == want
        assert bytes_scanned(table, [tq.Pred("a", "le", 90)], "w") == \
            j_bytes_scanned(ref_table, [rq.Pred("a", "le", 90)], "w")

    def test_tail_padding_never_matches(self):
        t = tdb.Table.synthetic("tail", 10, {"a": 8, "b": 8}, seed=0,
                                device="cpu")
        bv = t.columns["b"].decode()
        r = scan_aggregate_query(t, [tq.Pred("a", "le", 127)], "b")
        assert r["count"] == 10 and r["sum"] == int(bv.sum())


class TestChunkAccounting:
    def test_chunk_helpers_match_reference(self, table, ref_table):
        from repro.query import physical as jphys
        for chunk_rows in (1, 100, 4096, 10_001):
            assert physical.align_chunk_rows(table.columns, chunk_rows) == \
                jphys.align_chunk_rows(ref_table.columns, chunk_rows)
            plan = tq.Pred("a", "lt", 3) | tq.Pred("w", "ge", 2)
            jplan = rq.Pred("a", "lt", 3) | rq.Pred("w", "ge", 2)
            assert physical.referenced_chunk_bytes(
                plan, ("x",), table.columns, chunk_rows) == \
                jphys.referenced_chunk_bytes(jplan, ("x",),
                                             ref_table.columns, chunk_rows)
            assert physical.chunk_universe(table.columns, 4096) == \
                jphys.chunk_universe(ref_table.columns, 4096)

    def test_repack_mask_matches_reference(self, table, ref_table):
        from repro.query import physical as jphys
        rng = np.random.default_rng(1)
        for fb, tb in ((8, 16), (16, 4), (4, 8), (2, 16)):
            n_rows = 999
            sel = rng.random(n_rows) < 0.5
            from repro.kernels.scan_filter.ref import pack_mask
            m = pack_mask(sel, fb)
            to_words = -(-n_rows // (32 // tb))
            got = physical.repack_mask(
                torch.from_numpy(m.view(np.int32)), fb, tb, to_words)
            want = jphys.repack_mask(m, fb, tb, to_words)
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          np.asarray(want))


class TestValidation:
    def test_column_validation_messages_match_reference(self):
        for vals, bits in (([1, 2], 3), ([-1, 2], 8), ([300], 8)):
            with pytest.raises(ValueError) as jerr:
                rdb.BitPackedColumn.from_values("c", vals, bits)
            with pytest.raises(ValueError) as terr:
                tdb.BitPackedColumn.from_values("c", vals, bits,
                                                device="cpu")
            assert str(terr.value) == str(jerr.value)

    @pytest.mark.parametrize("n_rows", (0, 1, 3, 4, 5, 31, 32, 33))
    def test_valid_words_bit_identical(self, n_rows):
        for bits in (2, 4, 8, 16):
            c = tdb.BitPackedColumn.from_values("c", np.zeros(n_rows, int),
                                                bits, device="cpu")
            j = rdb.BitPackedColumn.from_values("c", np.zeros(n_rows, int),
                                                bits)
            np.testing.assert_array_equal(
                c.valid_words.numpy().view(np.uint32),
                np.asarray(j.valid_words))

    def test_table_from_arrays_rejects_bad_state(self):
        words = np.zeros(4, np.uint32)
        with pytest.raises(ValueError, match="uint32"):
            tdb.table_from_arrays({"a": (words.astype(np.int64), 8, 16,
                                         None)}, device="cpu")
        with pytest.raises(ValueError, match="do not fit"):
            tdb.table_from_arrays({"a": (words, 8, 17, None)}, device="cpu")
        with pytest.raises(ValueError, match="delimiter"):
            tdb.table_from_arrays({"a": (words | np.uint32(0x80), 8, 16,
                                         None)}, device="cpu")
        with pytest.raises(ValueError, match="unsupported"):
            tdb.table_from_arrays({"a": (words, 5, 16, None)}, device="cpu")

    def test_bind_errors_match_reference(self, table):
        eng = tq.QueryEngine(table, device="cpu")
        with pytest.raises(ValueError, match="unknown column"):
            eng.submit(tq.Query(tq.Pred("nope", "lt", 3), aggregates=("a",)))
        with pytest.raises(ValueError, match="payload max"):
            eng.submit(tq.Query(tq.Pred("x", "lt", 99), aggregates=("a",)))


class TestEngine:
    class Clock:
        def __init__(self, tick=0.01):
            self.t = 0.0
            self.tick = tick

        def __call__(self):
            self.t += self.tick
            return self.t

    def test_edf_order_summary_and_rejection(self, table):
        eng = tq.QueryEngine(table, clock=self.Clock(), est_gbps=1e9,
                             device="cpu")
        q = tq.Query(tq.Pred("a", "lt", 50), aggregates=("b",))
        ids = [eng.submit(q, deadline=d) for d in (float("inf"), 500.0,
                                                   100.0)]
        assert [r.qid for r in eng.run()] == [ids[2], ids[1], ids[0]]
        s = eng.summary()
        assert s["served"] == 3 and s["rejected"] == 0
        assert s["sla_attainment"] == 1.0
        assert s["latency_p99_s"] >= s["latency_p50_s"] > 0
        assert s["measured_gbps"] > 0
        assert eng.measured_bps == pytest.approx(eng.bytes_total
                                                 / eng.seconds_total)
        slow = tq.QueryEngine(table, clock=self.Clock(), est_gbps=1e-6,
                              device="cpu")
        assert slow.submit(q, deadline=0.001) is None
        assert slow.rejected == [1] and slow.run() == []

    def test_unified_snapshot_reads_the_port_engine(self, table):
        from repro_torch.obs import unified_snapshot
        eng = tq.QueryEngine(table, device="cpu")
        run_one(eng, tq.Query(tq.Pred("a", "lt", 50), aggregates=("b",)))
        snap = unified_snapshot(eng)
        assert snap["engine.queries"] == 1
        assert snap["launches.scan_aggregate"] == 1
        assert snap["sla.served"] == 1

    @pytest.mark.parametrize("kw", ("tiered", "power_cap", "chaos",
                                    "prefetch", "monitor"))
    def test_later_slice_arguments_raise(self, table, ref_table, kw):
        """tiered=, power_cap=, prefetch=, chaos= and monitor= are ported
        and refuse, as the reference's engine does, to run without what
        they need (a VirtualClock, the tier model); monitor= with the
        reference's message."""
        from repro.obs import SLOMonitor as JSLOMonitor
        from repro_torch.obs import SLOMonitor
        want = {"chaos": (ValueError, "chaos needs the tiered service "
                                      "model"),
                "monitor": (ValueError, "tiered"),
                "tiered": (ValueError, "advanceable clock"),
                "power_cap": (ValueError, "needs the tiered energy model"),
                "prefetch": (ValueError, "needs the tiered service model")}
        exc, match = want[kw]
        arg = SLOMonitor() if kw == "monitor" else object()
        with pytest.raises(exc, match=match) as got:
            tq.QueryEngine(table, device="cpu", **{kw: arg})
        if kw == "monitor":
            with pytest.raises(ValueError) as ref:
                rq.QueryEngine(ref_table, mode="xla_ref",
                               monitor=JSLOMonitor())
            assert str(got.value) == str(ref.value)

    def test_later_slice_paths_raise(self, table):
        """An enabled tracer needs the tiered timeline, as the reference's
        engine says; the paper model (ported) refuses to run before any
        query, with the reference's messages."""
        from repro_torch.obs.trace import Tracer
        with pytest.raises(ValueError, match="modeled tiered timeline"):
            tq.QueryEngine(table, device="cpu", tracer=Tracer())
        eng = tq.QueryEngine(table, device="cpu")
        for fn in (eng.model_check, lambda: eng.provision(0.1)):
            with pytest.raises(ValueError, match="no measured"):
                fn()


    def test_cuda_mode_on_cpu_table_raises(self, table):
        with pytest.raises(ValueError, match="mode='cuda'"):
            tq.QueryEngine(table, mode="cuda", device="cpu")
        with pytest.raises(ValueError, match="lies on the CPU"):
            scan_aggregate_query(table, [tq.Pred("a", "lt", 5)], "b",
                                 mode="cuda")


class TestModelFeedback:
    """tests/test_query_engine.py's model_check / provision on the port:
    both engines answer the same queries, their counters are forced to
    the same seconds, and the paper model's answers must be equal."""

    QUERIES = [("single_pred_fused", ("b",)), ("and_mixed_width", ("w",)),
               ("multi_agg_mixed", ("b", "w", "x"))]

    def engines(self, table, ref_table, seconds=0.0125):
        shapes = {n: f for n, f, _, _ in PLAN_SHAPES}
        teng = tq.QueryEngine(table, device="cpu")
        jeng = rq.QueryEngine(ref_table, mode="xla_ref")
        for name, aggs in self.QUERIES:
            run_one(teng, tq.Query(shapes[name](tq), aggregates=aggs))
            run_one(jeng, rq.Query(shapes[name](rq), aggregates=aggs))
        assert teng.bytes_total == jeng.bytes_total > 0
        assert len(teng.reports) == len(jeng.reports) == 3
        teng.seconds_total = jeng.seconds_total = seconds
        return teng, jeng

    def test_model_check_equals_reference(self, table, ref_table):
        import dataclasses

        import repro.core.systems as rsys
        import repro_torch.core.systems as tsys
        teng, jeng = self.engines(table, ref_table)
        tpu = dataclasses.asdict(rsys.TPU_V5E)
        tpu["link_bandwidth"] = tpu.pop("ici_link_bandwidth")
        tpu["links"] = tpu.pop("ici_links")
        carried = tsys.as_paper_system(tsys.AcceleratorSpec(**tpu))
        assert teng.model_check(carried) == jeng.model_check()
        h100 = tsys.as_paper_system(tsys.H100_SXM)
        assert teng.model_check() == teng.model_check(h100) == \
            jeng.model_check(rsys.SystemSpec(**dataclasses.asdict(h100)))
        assert teng.model_check()["system"] == "h100-sxm-as-paper"
        for t, r in ((tsys.DIE_STACKED, rsys.DIE_STACKED),
                     (tsys.TRADITIONAL, rsys.TRADITIONAL)):
            mc = teng.model_check(t)
            assert mc == jeng.model_check(r)
            assert mc["chips"] == 1 and mc["measured_gbps"] > 0
        for sla in (0.001, 0.1):
            for t, r in ((None, None), (carried, None),
                         (tsys.DIE_STACKED, rsys.DIE_STACKED)):
                got = teng.provision(sla, system=t)
                want = jeng.provision(sla, system=r) if t is not None \
                    else jeng.provision(sla, system=rsys.SystemSpec(
                        **dataclasses.asdict(h100)))
                assert got.summary() == want.summary()
                assert got.design.response_time <= sla * 1.01

    def test_model_feedback_errors_equal_reference(self, table, ref_table):
        teng = tq.QueryEngine(table, device="cpu")
        jeng = rq.QueryEngine(ref_table, mode="xla_ref")
        for call in (lambda e: e.model_check(),
                     lambda e: e.provision(sla_s=0.1)):
            with pytest.raises(ValueError) as got:
                call(teng)
            with pytest.raises(ValueError) as want:
                call(jeng)
            assert str(got.value) == str(want.value)
