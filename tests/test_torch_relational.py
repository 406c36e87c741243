"""Parity of the port's GroupBy / HashJoin with repro.query.relational and
repro.store.exec on the CPU.

tests/test_relational.py's table (6001 rows, chunk 1024: an RLE key, two
FOR columns, a plain one) is taken across bit for bit with
table_from_arrays and encoded by the port; the build sides are port
tables with the same codes. Every shape of that file goes through the
reference's execute_grouped_oracle / execute_grouped /
execute_grouped_encoded and the port's, on the plain table and on the
store, and through QueryEngine. Results, launch-count deltas and batch
records must be equal. Integer results: no tolerance.
"""
import numpy as np
import pytest
import torch

import repro.db as rdb
import repro.query as rq
import repro_torch.db as tdb
import repro_torch.query as tq
from repro.kernels.group_aggregate import ops as jgops
from repro.obs import metrics as jmetrics
from repro.query import relational as jrel
from repro.store import EncodedTable as JTable
from repro.store.exec import execute_grouped_encoded as j_grouped
from repro_torch.kernels.group_aggregate import ops as tgops
from repro_torch.obs import metrics as tmetrics
from repro_torch.query import relational as trel
from repro_torch.store import EncodedTable, execute_grouped_encoded

N_ROWS = 6001
CHUNK_ROWS = 1024
TORCH_MODES = ("auto", "torch_ref")


@pytest.fixture(scope="module")
def ref_table():
    rng = np.random.default_rng(3)
    t = rdb.Table("t")
    t.add(rdb.BitPackedColumn.from_values(
        "r", np.sort(rng.integers(0, 8, N_ROWS)), 8))
    t.add(rdb.BitPackedColumn.from_values(
        "f", 40 + rng.integers(0, 8, N_ROWS), 8))
    t.add(rdb.BitPackedColumn.from_values(
        "w", 9000 + rng.integers(0, 100, N_ROWS), 16))
    t.add(rdb.BitPackedColumn.from_values(
        "u", rng.integers(0, 128, N_ROWS), 8))
    return t


def carry(ref):
    return tdb.table_from_arrays(
        {n: (np.asarray(c.words), c.code_bits, c.num_rows, c.dictionary)
         for n, c in ref.columns.items()}, name=ref.name, device="cpu")


@pytest.fixture(scope="module")
def table(ref_table):
    return carry(ref_table)


@pytest.fixture(scope="module")
def ref_encoded(ref_table):
    return JTable.from_table(ref_table, chunk_rows=CHUNK_ROWS)


@pytest.fixture(scope="module")
def encoded(table):
    return EncodedTable.from_table(table, chunk_rows=CHUNK_ROWS)


@pytest.fixture(scope="module")
def ref_dim():
    d = rdb.Table("dim")
    d.add(rdb.BitPackedColumn.from_values("r", np.array([1, 3, 5, 99]), 8))
    d.add(rdb.BitPackedColumn.from_values("u", np.array([2, 7, 50, 90]), 8))
    return d


@pytest.fixture(scope="module")
def dim(ref_dim):
    return carry(ref_dim)


# name -> query builder over a plan namespace q and a build side d
PLAIN_SHAPES = {
    "groupby_where": lambda q, d: q.GroupBy("r", ("u", "f"),
                                            where=q.Pred("u", "lt", 90)),
    "mixed_width_predicate": lambda q, d: q.GroupBy(
        "r", ("u",), where=q.And((q.Pred("w", "ge", 9030),
                                  q.Pred("f", "lt", 45)))),
    "hash_join": lambda q, d: q.HashJoin(d, "r", "r", aggs=("u",),
                                         where=q.Pred("f", "lt", 46)),
    "count_only": lambda q, d: q.GroupBy("r"),
    "empty_selection": lambda q, d: q.GroupBy("r", ("u",),
                                              where=q.Pred("u", "gt", 127)),
    "join_no_where": lambda q, d: q.HashJoin(d, "r", "r", aggs=("u",)),
}
ENCODED_SHAPES = {
    "groupby_two_aggs": lambda q, d: q.GroupBy("r", ("u", "f")),
    "for_key_where": lambda q, d: q.GroupBy("f", ("w",),
                                            where=q.Pred("u", "lt", 64)),
    "rle_count_only": lambda q, d: q.GroupBy("r"),
    "rle_key_pred": lambda q, d: q.GroupBy("r",
                                           where=q.Pred("r", "le", 4)),
    "for16_key": lambda q, d: q.GroupBy("w", ("u",)),
    "join_plain_key": lambda q, d: q.HashJoin(d, "u", "u", aggs=("f",),
                                              where=q.Pred("r", "lt", 7)),
    "join_rle_key": lambda q, d: q.HashJoin(d, "r", "r", aggs=("u",)),
}

_COUNTER_PREFIXES = ("launches/", "batch/", "batch_chunks/")


def record(registry) -> dict:
    """Launch counts and batched-group records of a metrics scope."""
    return {k: c.value for k, c in registry.counters.items()
            if k.startswith(_COUNTER_PREFIXES) and c.value}


def run_ref(fn):
    reg = jmetrics.MetricsRegistry("j")
    with jmetrics.scoped(reg):
        out = fn()
    return out, record(reg)


def run_port(fn):
    reg = tmetrics.MetricsRegistry("t")
    with tmetrics.scoped(reg):
        out = fn()
    return out, record(reg)


def assert_int_result(res):
    assert type(res["count"]) is int
    for k, g in res["groups"].items():
        assert type(k) is int and type(g["count"]) is int
        assert all(type(s) is int for s in g["sums"].values())


# --------------------------------------------------------------------------
# bind / error paths
# --------------------------------------------------------------------------

def test_unknown_column_raises(table):
    for q in (tq.GroupBy("zz"), tq.GroupBy("r", ("zz",)),
              tq.GroupBy("r", where=tq.Pred("zz", "lt", 3))):
        with pytest.raises(ValueError, match="zz"):
            trel.execute_grouped(q, table)
        with pytest.raises(ValueError, match="zz"):
            trel.execute_grouped_oracle(q, table)


def test_plan_node_errors():
    with pytest.raises(ValueError, match="group key"):
        tq.GroupBy("r", ("r",))
    with pytest.raises(ValueError, match="one group-key"):
        tq.GroupBy(("r", "u"))


def test_join_build_side_missing_column_raises(table):
    with pytest.raises(ValueError, match="no column"):
        tq.HashJoin(table, "r", "zz")


def test_join_key_width_mismatch_names_both_sides(table, dim, ref_table,
                                                  ref_dim):
    with pytest.raises(ValueError) as e:
        trel.bind_check(tq.HashJoin(dim, "w", "r"), table.columns)
    with pytest.raises(ValueError) as je:
        jrel.bind_check(rq.HashJoin(ref_dim, "w", "r"), ref_table.columns)
    assert str(e.value) == str(je.value)
    assert "16-bit" in str(e.value) and "'w'" in str(e.value)


def test_engine_submit_runs_bind_checks(table, encoded, dim):
    for t in (table, encoded):
        eng = tq.QueryEngine(t, device="cpu")
        with pytest.raises(ValueError, match="zz"):
            eng.submit(tq.GroupBy("zz"))
        with pytest.raises(ValueError, match="width mismatch"):
            eng.submit(tq.HashJoin(dim, "w", "r"))
        with pytest.raises(NotImplementedError, match="step 6"):
            execute_grouped_encoded(tq.GroupBy("r"), encoded,
                                    guard=object())


def test_build_keys_and_domain(dim, ref_dim):
    j = tq.HashJoin(dim, "r", "r")
    bk = trel.build_keys(j)
    assert bk.dtype == torch.int64
    assert bk.tolist() == jrel.build_keys(
        rq.HashJoin(ref_dim, "r", "r")).tolist() == [1, 3, 5, 99]
    assert trel.group_domain(j, 2, 50).tolist() == [3, 5]
    assert trel.group_domain(tq.GroupBy("r"), 3, 6).tolist() == [3, 4, 5, 6]
    assert len(trel.group_domain(tq.GroupBy("r"), 1, 0)) == 0


# --------------------------------------------------------------------------
# plain table
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", PLAIN_SHAPES)
def test_plain_matches_reference(table, ref_table, dim, ref_dim, name):
    jq, q = PLAIN_SHAPES[name](rq, ref_dim), PLAIN_SHAPES[name](tq, dim)
    want = jrel.execute_grouped_oracle(jq, ref_table)
    assert trel.execute_grouped_oracle(q, table) == want
    assert_int_result(trel.execute_grouped_oracle(q, table))
    jgot, jrec = run_ref(lambda: jrel.execute_grouped(jq, ref_table,
                                                      mode="xla_ref"))
    assert jgot == want
    for mode in TORCH_MODES:
        got, rec = run_port(lambda: trel.execute_grouped(q, table,
                                                         mode=mode))
        assert got == want, mode
        assert_int_result(got)
        assert rec == jrec, mode


def test_plain_pallas_matches(table, ref_table, dim, ref_dim):
    jq = PLAIN_SHAPES["hash_join"](rq, ref_dim)
    assert trel.execute_grouped(PLAIN_SHAPES["hash_join"](tq, dim), table) \
        == jrel.execute_grouped(jq, ref_table, mode="pallas")


def test_zero_rows():
    empty = tdb.Table("e")
    empty.add(tdb.BitPackedColumn.from_values("r", np.zeros(0, np.int64), 8,
                                              device="cpu"))
    assert trel.execute_grouped(tq.GroupBy("r"), empty) \
        == trel.execute_grouped_oracle(tq.GroupBy("r"), empty) \
        == trel.empty_result() == jrel.empty_result()


@pytest.mark.parametrize("cutoff", (4, 0))
def test_wide_key_takes_fallback(table, ref_table, monkeypatch, cutoff):
    """Shrinking the dense cutoff (the strategy knob the reference test
    patches) sends the plain table through the fallback in both
    packages, with the same launch records."""
    monkeypatch.setattr(jrel, "DENSE_MAX_GROUPS", cutoff)
    monkeypatch.setattr(jgops, "DENSE_MAX_GROUPS", cutoff)
    monkeypatch.setattr(trel, "DENSE_MAX_GROUPS", cutoff)
    monkeypatch.setattr(tgops, "DENSE_MAX_GROUPS", cutoff)
    for jq, q in ((rq.GroupBy("w", ("u",)), tq.GroupBy("w", ("u",))),
                  (rq.GroupBy("r", ("u", "f"), where=rq.Pred("u", "lt", 90)),
                   tq.GroupBy("r", ("u", "f"), where=tq.Pred("u", "lt", 90)))):
        want, jrec = run_ref(lambda: jrel.execute_grouped(jq, ref_table))
        got, rec = run_port(lambda: trel.execute_grouped(q, table))
        assert got == want == jrel.execute_grouped_oracle(jq, ref_table)
        assert rec == jrec == {"launches/group_aggregate_fallback": 1}


def test_fallback_slices(table, monkeypatch):
    """The fallback walks the rows in slices; the answer does not depend
    on the slice size."""
    q = tq.GroupBy("w", ("u", "f"), where=tq.Pred("u", "lt", 100))
    want = trel.execute_grouped_oracle(q, table)
    for size in (1, 1000, 4096):
        monkeypatch.setattr(trel, "SLICE_ROWS", size)
        assert trel.execute_grouped_oracle(q, table) == want


# --------------------------------------------------------------------------
# compressed store
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ENCODED_SHAPES)
def test_encoded_matches_reference(table, ref_table, encoded, ref_encoded,
                                   dim, ref_dim, name):
    jq, q = ENCODED_SHAPES[name](rq, ref_dim), ENCODED_SHAPES[name](tq, dim)
    want = jrel.execute_grouped_oracle(jq, ref_table)
    assert trel.execute_grouped_oracle(q, table) == want
    jgot, jrec = run_ref(lambda: j_grouped(jq, ref_encoded, mode="xla_ref"))
    assert jgot == want
    for mode in TORCH_MODES:
        got, rec = run_port(lambda: execute_grouped_encoded(q, encoded,
                                                            mode=mode))
        assert got == want, mode
        assert_int_result(got)
        assert rec == jrec, mode


@pytest.mark.parametrize("name", ("for_key_where", "rle_key_pred"))
def test_encoded_pallas_matches(encoded, ref_encoded, dim, ref_dim, name):
    jq, q = ENCODED_SHAPES[name](rq, ref_dim), ENCODED_SHAPES[name](tq, dim)
    assert execute_grouped_encoded(q, encoded) \
        == j_grouped(jq, ref_encoded, mode="pallas")


def test_rle_pregrouped_is_one_launch(table, encoded, ref_encoded):
    """A count-only GroupBy on the RLE key takes one batched run launch: no
    dense plane, no fallback, as in the reference."""
    q, jq = (tq.GroupBy("r", where=tq.Pred("r", "lt", 6)),
             rq.GroupBy("r", where=rq.Pred("r", "lt", 6)))
    execute_grouped_encoded(q, encoded)                  # warm the caches
    got, rec = run_port(lambda: execute_grouped_encoded(q, encoded))
    want, jrec = run_ref(lambda: j_grouped(jq, ref_encoded, mode="xla_ref"))
    assert got == want == trel.execute_grouped_oracle(q, table)
    launches = {k: v for k, v in rec.items() if k.startswith("launches/")}
    assert launches == {"launches/group_aggregate_rle": 1}
    assert rec == jrec


def test_encoded_forced_fallback(table, encoded, ref_encoded, dim, ref_dim,
                                 monkeypatch):
    for mod in (jrel, jgops, trel, tgops):
        monkeypatch.setattr(mod, "DENSE_MAX_GROUPS", 0)
    for jq, q in ((rq.GroupBy("r", ("u",)), tq.GroupBy("r", ("u",))),
                  (rq.HashJoin(ref_dim, "u", "u", aggs=("f",)),
                   tq.HashJoin(dim, "u", "u", aggs=("f",)))):
        want, jrec = run_ref(lambda: j_grouped(jq, ref_encoded,
                                               mode="xla_ref"))
        got, rec = run_port(lambda: execute_grouped_encoded(q, encoded))
        assert got == want == trel.execute_grouped_oracle(q, table)
        assert rec == jrec == {
            "launches/group_aggregate_fallback": encoded.n_chunks}


def test_join_domain_outside_key_range(encoded, ref_encoded):
    """A build side whose keys all lie outside the probe key's range has an
    empty domain: every chunk takes the fallback and nothing joins."""
    far = tdb.Table("far")
    far.add(tdb.BitPackedColumn.from_values("r", np.array([100, 120]), 8,
                                            device="cpu"))
    jfar = rdb.Table("far")
    jfar.add(rdb.BitPackedColumn.from_values("r", np.array([100, 120]), 8))
    want, jrec = run_ref(lambda: j_grouped(rq.HashJoin(jfar, "r", "r"),
                                           ref_encoded, mode="xla_ref"))
    got, rec = run_port(lambda: execute_grouped_encoded(
        tq.HashJoin(far, "r", "r"), encoded))
    assert got == want == trel.empty_result()
    assert rec == jrec


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("store", (False, True), ids=("plain", "encoded"))
def test_engine_grouped_results(table, encoded, ref_table, ref_encoded, dim,
                                ref_dim, store):
    t, jt = (encoded, ref_encoded) if store else (table, ref_table)
    shapes = ENCODED_SHAPES if store else PLAIN_SHAPES
    eng = tq.QueryEngine(t, device="cpu")
    jeng = rq.QueryEngine(jt, mode="xla_ref")
    for name, mk in shapes.items():
        q, jq = mk(tq, dim), mk(rq, ref_dim)
        eng.submit(q)
        jeng.submit(jq)
        (r,), (jr,) = eng.run(), jeng.run()
        want = jrel.execute_grouped_oracle(jq, ref_table)
        assert r.aggregates == jr.aggregates == want, name
        assert r.count == jr.count == want["count"]
        assert r.selectivity == jr.selectivity
        assert r.bytes_scanned == jr.bytes_scanned == eng.bytes_scanned(q)
        assert r.logical_bytes == jr.logical_bytes
    counts = eng.metrics.launch_counts()
    assert counts == jeng.metrics.launch_counts()
    assert counts.get("group_aggregate", 0) > 0


def test_engine_tracer_shape(table, dim):
    """The engine names each query's shape for the tracer as the
    reference does: join, grouped or scan."""
    seen = []

    class Recorder:
        enabled = False

        def begin_query(self, qid, **kw):
            seen.append(kw["shape"])

    eng = tq.QueryEngine(table, device="cpu", tracer=Recorder())
    for q in (tq.HashJoin(dim, "r", "r"), tq.GroupBy("r"),
              tq.Query(tq.Pred("r", "lt", 3), aggregates=("u",))):
        eng.submit(q)
        eng.run()
    assert seen == ["join", "grouped", "scan"]
