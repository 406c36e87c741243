"""Parity of the port's sharded tables (repro_torch.query.sharded,
repro_torch.store.sharded, the sharded branches of QueryEngine and
PlacementEngine, and resilience's degraded re-execution) with the
reference on the CPU.

In process, JAX sees one CPU device: the port at 1, 2, 3, 7 and 8 virtual
shards is held against the reference's 1-shard ShardedTable and its
unsharded engine, in the reference's "pallas" (interpret) and "xla_ref"
modes — tests/test_query_engine.py's eleven plan shapes at 10_001 rows (so
every column carries tail padding), the compressed store's delta view,
tests/multidevice_child.py's grouped cases, and the 300_000-row 16-bit
sum past 2^31.

The per-shard surfaces differ from an unsharded run, so they are held
against the reference on 8 host devices: this file runs itself as a child
(`python tests/test_torch_sharded.py child OUT`) under
XLA_FLAGS=--xla_force_host_platform_device_count=8; the child computes
the reference's surfaces (`surfaces(REF)`) and pickles them to OUT, the
parent computes the port's with the same code (`surfaces(PORT)`) and
compares. A third side computes them on a mesh of ranks: an 8-rank gloo
world on the CPU (repro_torch.dist.world.spawn), a shard a rank, every
rank running `surfaces(RANKS)` alike; each rank's surfaces, launch
counts included, are held against the same child. Integer paths only:
every comparison is ==.
"""
from __future__ import annotations

import math
import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

N_ROWS = 10_001                 # every column carries tail padding
SPEC = {"a": 8, "b": 8, "w": 16, "x": 4}
SEED = 11
STORE_CHUNK_ROWS = 4096
PLACE_CHUNK_ROWS = 512
SHARDS = (1, 2, 3, 7, 8)
CHILD_SHARDS = 8
LOST = ([0], [7], [3, 5], list(range(7)))
LOST_GROUPED = ([0], [3, 5], list(range(7)))
CHILD_TIMEOUT_S = 300
WORLD_DEADLINE_S = 240

# (name, plan over a query module q, numpy selection, aggregates): the
# plan shapes of tests/test_query_engine.py
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

# flat queries of tests/multidevice_child.py (check_sharded_query_engine,
# check_resilience), plus le at the payload max (the fused tautology)
FLAT_QUERIES = [
    ("fused", lambda q: q.Pred("a", "lt", 64), ("b",)),
    ("and_mixed", lambda q: q.Pred("a", "lt", 50) & q.Pred("w", "ge", 9000),
     ("w", "b")),
    ("or_mixed", lambda q: q.Pred("x", "eq", 3) | q.Pred("w", "lt", 500),
     ("a",)),
    ("empty", lambda q: q.Pred("a", "gt", 127), ("b",)),
    ("le_vmax", lambda q: q.Pred("a", "le", 127), ("b",)),
]
# tests/multidevice_child.py::check_compressed_store's queries
STORE_QUERIES = [
    ("rle_col", lambda q: q.Pred("r", "lt", 4), ("r",)),
    ("for_x_for", lambda q: q.Pred("f", "ge", 44), ("w",)),
    ("mixed_and", lambda q: q.Pred("f", "ge", 42) & q.Pred("w", "lt", 9080),
     ("w", "u")),
    ("empty", lambda q: q.Pred("f", "lt", 40), ("f",)),
    ("all_match", lambda q: q.Pred("w", "ge", 0), ("w",)),
]
# tests/multidevice_child.py::check_relational's queries (d: the build side)
GROUPED_QUERIES = [
    ("multi_agg", lambda q, d: q.GroupBy("r", ("u", "w"))),
    ("filtered", lambda q, d: q.GroupBy("f", ("w",),
                                        where=q.Pred("u", "lt", 64))),
    ("count_only", lambda q, d: q.GroupBy("r", where=q.Pred("r", "lt", 5))),
    ("join_clip", lambda q, d: q.HashJoin(d, "u", "u", aggs=("f",),
                                          where=q.Pred("r", "lt", 7))),
    ("empty_sel", lambda q, d: q.GroupBy("u", ("r",),
                                         where=q.Pred("u", "gt", 127))),
]
# keys past the dense cutoff on the flat table (w is 16-bit): the oracle
WIDE_QUERIES = [
    ("wide", lambda q, d: q.GroupBy("w", ("b",))),
    ("wide_where", lambda q, d: q.GroupBy("w", ("a", "x"),
                                          where=q.Pred("a", "lt", 64))),
]


# --------------------------------------------------------------------------
# the two packages behind one namespace, so both run the same code
# --------------------------------------------------------------------------

def _ref_side():
    import repro.db as db
    import repro.query as q
    from repro.core import systems
    from repro.kernels import dispatch
    from repro.launch.mesh import make_mesh
    from repro.query import relational
    from repro.resilience import (ChaosHarness, DegradedResultError,
                                  FaultSpec, execute_degraded)
    from repro.resilience.recover import execute_grouped_degraded
    from repro.serve.sla import VirtualClock
    from repro.store import EncodedTable, ShardedEncodedTable
    from repro.store.exec import translate_plan
    from repro.tier import placement, tiers
    return SimpleNamespace(
        name="reference", db=db, q=q, systems=systems, dispatch=dispatch,
        relational=relational, mesh=lambda n: make_mesh((n,), ("data",)),
        Chaos=ChaosHarness, Degraded=DegradedResultError,
        FaultSpec=FaultSpec, execute_degraded=execute_degraded,
        execute_grouped_degraded=execute_grouped_degraded,
        Clock=VirtualClock, EncodedTable=EncodedTable,
        Sharded=q.ShardedTable, ShardedEncoded=ShardedEncodedTable,
        translate_plan=translate_plan, placement=placement, tiers=tiers,
        mode="xla_ref", kw={},
        words=lambda w: np.asarray(w).astype(np.uint32).tolist(),
        planes=lambda p: np.asarray(p).tolist(),
        domain=lambda q_, lo, hi, dev: relational.group_domain(q_, lo, hi))


def _port_side():
    import repro_torch.db as db
    import repro_torch.query as q
    from repro_torch.core import systems
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.query import relational
    from repro_torch.resilience import (ChaosHarness, DegradedResultError,
                                        FaultSpec, execute_degraded,
                                        execute_grouped_degraded)
    from repro_torch.serve.sla import VirtualClock
    from repro_torch.store import EncodedTable, ShardedEncodedTable
    from repro_torch.store.exec import translate_plan
    from repro_torch.tier import placement, tiers
    return SimpleNamespace(
        name="port", db=db, q=q, systems=systems, dispatch=dispatch,
        relational=relational,
        mesh=lambda n: make_mesh((n,), ("data",), device="cpu"),
        Chaos=ChaosHarness, Degraded=DegradedResultError,
        FaultSpec=FaultSpec, execute_degraded=execute_degraded,
        execute_grouped_degraded=execute_grouped_degraded,
        Clock=VirtualClock, EncodedTable=EncodedTable,
        Sharded=q.ShardedTable, ShardedEncoded=ShardedEncodedTable,
        translate_plan=translate_plan, placement=placement, tiers=tiers,
        mode="torch_ref", kw={"device": "cpu"},
        words=lambda w: w.numpy().astype(np.uint32).tolist(),
        planes=lambda p: p.numpy().tolist(),
        domain=lambda q_, lo, hi, dev: relational.group_domain(
            q_, lo, hi, device=dev))


def _rank_side():
    """The port on a mesh of the world's ranks, one CPU shard a rank."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    side = _port_side()
    side.name = "ranks"
    side.mesh = lambda n: make_mesh((n,), ("data",), group=dist.group.WORLD)
    return side


def flat_table(side, rows=N_ROWS, seed=SEED):
    return side.db.Table.synthetic("t", rows, SPEC, seed=seed, **side.kw)


def store_table(side, rows=N_ROWS):
    """tests/multidevice_child.py's compressed-store mix: r sorted (RLE),
    f and w frame-of-reference, u plain."""
    rng = np.random.default_rng(17)
    t = side.db.Table("s")
    for name, vals, bits in (
            ("r", np.sort(rng.integers(0, 8, rows)), 8),
            ("f", 40 + rng.integers(0, 8, rows), 8),
            ("w", 9000 + rng.integers(0, 100, rows), 16),
            ("u", rng.integers(0, 128, rows), 8)):
        t.add(side.db.BitPackedColumn.from_values(name, vals, bits,
                                                  **side.kw))
    return t


def dim_table(side):
    t = side.db.Table("dim")
    t.add(side.db.BitPackedColumn.from_values(
        "u", np.array([2, 7, 50, 90, 127]), 8, **side.kw))
    return t


def _agg(side, t, mk, aggs):
    return t.execute(mk(side.q), aggs, mode=side.mode)


def _inner(t):
    return getattr(t, "inner", t)


def _raw(side, t, plan):
    frames = getattr(t, "frames", None)
    return side.translate_plan(plan, frames) if frames is not None else plan


def _degraded(side, fn):
    try:
        return fn()
    except side.Degraded as e:
        return ("raised", str(e))


def _views(side, n):
    store = store_table(side)
    enc = side.EncodedTable.from_table(store, chunk_rows=STORE_CHUNK_ROWS)
    mesh = side.mesh(n)
    tiny = side.db.Table.synthetic("z", 7, {"a": 8, "b": 8}, seed=1,
                                   **side.kw)
    return {"flat": (side.Sharded.shard(flat_table(side), mesh),
                     FLAT_QUERIES),
            "store": (side.Sharded.shard(store, mesh), STORE_QUERIES),
            "delta": (side.ShardedEncoded.shard(enc, mesh), STORE_QUERIES),
            "tiny": (side.Sharded.shard(tiny, mesh),
                     [("all", lambda q: q.Pred("a", "ge", 0), ("b",))])}


def _layout(side, t) -> dict:
    inner = _inner(t)
    padded = inner.slices
    if getattr(inner, "ranked", False):
        # the padded columns whole, gathered from the ranks
        from repro_torch.dist.world import all_gather
        group = inner.mesh.axis_group(inner.axis)
        padded = {c: SimpleNamespace(
            code_bits=s.code_bits,
            words=all_gather(s.words, group).view(-1),
            valid=all_gather(s.valid, group).view(-1))
            for c, s in padded.items()}
    out = {"n_shards": t.n_shards, "nbytes": t.nbytes,
           "rows_per_shard": inner.rows_per_shard,
           "slices": {c: (s.code_bits, side.words(s.words),
                          side.words(s.valid))
                      for c, s in padded.items()},
           "row_ranges": [inner.shard_row_range(i)
                          for i in range(t.n_shards)],
           "host_slices": [{c: (s.code_bits, side.words(s.words),
                                side.words(s.valid))
                            for c, s in inner.host_shard_slices(i).items()}
                           for i in range(t.n_shards)],
           "key_ranges": {c: inner.key_code_range(c)
                          for c in inner.table.columns}}
    if hasattr(t, "frames"):
        out["frames"] = t.frames
        out["columns"] = {c: (m.code_bits, m.nbytes, m.logical_nbytes)
                          for c, m in t.columns.items()}
    return out


def _flat_surfaces(side, t, queries) -> dict:
    pe = side.placement.PlacementEngine.for_table(
        t, side.tiers.paper_tiers(t.nbytes // 2),
        side.placement.Policy.CACHE, chunk_rows=PLACE_CHUNK_ROWS)
    out = {"universe": (pe.ids, pe.nbytes.tolist(), pe.chunk_rows),
           "queries": {}}
    side.dispatch.reset_launch_counts()
    for name, mk, aggs in queries:
        plan = mk(side.q)
        raw = _raw(side, t, plan)
        rec = {"execute": [t.execute(plan, aggs, mode=side.mode)
                           for _ in range(2)],
               "partials": _inner(t).execute_partials(raw, aggs,
                                                      mode=side.mode),
               "chunk_bytes": sorted(t.chunk_bytes(
                   plan, aggs, PLACE_CHUNK_ROWS).items())}
        rec["degraded"] = [_degraded(side, lambda: side.execute_degraded(
            t, plan, aggs, lost, mode=side.mode))
            for lost in LOST + (list(range(t.n_shards)),)]
        out["queries"][name] = rec
    out["launches"] = side.dispatch.launch_counts()
    return out


def _grouped_surfaces(side, t, queries=GROUPED_QUERIES) -> dict:
    dim = dim_table(side)
    inner = _inner(t)
    frames = getattr(t, "frames", None)
    out = {}
    side.dispatch.reset_launch_counts()
    for name, mk in queries:
        query = mk(side.q, dim)
        rec = {"result": t.execute_grouped(query, mode=side.mode)}
        kbase = frames[query.key][0] if frames is not None else 0
        kmin, kmax = inner.key_code_range(query.key)
        domain = side.domain(query, kbase + kmin, kbase + kmax,
                             getattr(t, "device", None))
        if len(domain) and side.relational.dense_ok(domain):
            raw_domain = domain - kbase
            rec["planes"] = {c: side.planes(p) for c, p in
                             inner.execute_grouped_planes(
                                 _raw(side, t, query.plan()), query.key,
                                 query.aggs, raw_domain,
                                 mode=side.mode).items()}
        rec["degraded"] = [_degraded(
            side, lambda: side.execute_grouped_degraded(
                t, query, lost, mode=side.mode))
            for lost in LOST_GROUPED + (list(range(t.n_shards)),)]
        out[name] = rec
    out["launches"] = side.dispatch.launch_counts()
    return out


def _engine_surfaces(side, t, queries) -> dict:
    """A tiered engine (modeled time, so the numbers are the same in any
    run) over the sharded table: results, summary, model_check and
    launches across repeated queries."""
    clock = side.Clock()
    pe = side.placement.PlacementEngine.for_table(
        t, side.tiers.paper_tiers(t.nbytes // 2),
        side.placement.Policy.CACHE, chunk_rows=PLACE_CHUNK_ROWS)
    eng = side.q.QueryEngine(t, mode=side.mode, clock=clock, tiered=pe,
                             **side.kw)
    results = []
    for _ in range(2):
        for _name, mk, aggs in queries:
            eng.submit(side.q.Query(mk(side.q), aggregates=aggs),
                       deadline=clock() + 1.0)
            r = eng.run()[0]
            results.append((r.qid, r.aggregates, r.count, r.selectivity,
                            r.bytes_scanned, r.latency_s, r.met, r.tier))
    return {"results": results, "summary": eng.summary(),
            "model_check": eng.model_check(side.systems.DIE_STACKED),
            "launches": eng.metrics.launch_counts(),
            "n_shards": eng.n_shards}


def _chaos_surfaces(side, t, query) -> dict:
    """tests/multidevice_child.py::check_resilience's engine-level chaos:
    seeded shard dropouts under CACHE."""
    def run():
        clock = side.Clock()
        pe = side.placement.PlacementEngine.for_table(
            t, side.tiers.paper_tiers(t.nbytes // 2),
            side.placement.Policy.CACHE, chunk_rows=4096)
        eng = side.q.QueryEngine(
            t, mode=side.mode, clock=clock, tiered=pe, **side.kw,
            chaos=side.Chaos(side.FaultSpec(seed=5, shard_loss_rate=0.5)))
        results = []
        for _ in range(10):
            eng.submit(query, deadline=clock() + 10.0)
            r = eng.run()[0]
            results.append((r.aggregates, r.degraded, r.latency_s, r.tier))
        return {"results": results, "summary": eng.summary(),
                "charges": [c.as_dict() for c in pe.meter.charges]}
    return {"first": run(), "second": run()}


def surfaces(side, n=CHILD_SHARDS) -> dict:
    views = _views(side, n)
    out = {"layout": {k: _layout(side, t) for k, (t, _) in views.items()},
           "flat": {k: _flat_surfaces(side, t, qs)
                    for k, (t, qs) in views.items()},
           "grouped": {k: _grouped_surfaces(side, views[k][0])
                       for k in ("store", "delta")}}
    wide = side.ShardedEncoded.shard(side.EncodedTable.from_table(
        flat_table(side), chunk_rows=STORE_CHUNK_ROWS), side.mesh(n))
    out["grouped_wide"] = {
        "flat": _grouped_surfaces(side, views["flat"][0], WIDE_QUERIES),
        "flat_delta": _grouped_surfaces(side, wide, WIDE_QUERIES)}
    st, qs = views["flat"]
    out["engine"] = _engine_surfaces(side, side.Sharded.shard(
        flat_table(side), side.mesh(n)), qs)
    out["chaos"] = _chaos_surfaces(
        side, st, side.q.Query(side.q.Pred("a", "lt", 64),
                               aggregates=("b",)))
    return out


def _rank_surfaces() -> list:
    """One rank of the world: its surfaces, and (on rank 0) every rank's,
    gathered."""
    import torch.distributed as dist
    mine = surfaces(_rank_side())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def _child(out_path: str) -> None:
    import jax
    assert len(jax.devices()) == CHILD_SHARDS, jax.devices()
    with open(out_path, "wb") as f:
        pickle.dump(surfaces(_ref_side()), f)


if __name__ == "__main__":
    _child(sys.argv[2])
    sys.exit(0)


# --------------------------------------------------------------------------
# the reference on 8 host devices, in a child process
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def child(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded") / "reference.pkl"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, __file__, "child", str(out)],
                         env=env, capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT_S)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port():
    return surfaces(_port_side())


@pytest.fixture(scope="module")
def ranks():
    """Every rank's surfaces from one 8-rank gloo world on the CPU."""
    from repro_torch.dist import world
    every = world.spawn(_rank_surfaces, CHILD_SHARDS, backend="gloo",
                        deadline_s=WORLD_DEADLINE_S)
    assert len(every) == CHILD_SHARDS
    return every


@pytest.mark.parametrize("view", ("flat", "store", "delta", "tiny"))
def test_layout_equals_the_8_device_reference(child, port, view):
    """rows_per_shard, nbytes, the padded words and validity masks, each
    shard's row range, host_shard_slices and key_code_range."""
    got, want = port["layout"][view], child["layout"][view]
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], (view, key)


@pytest.mark.parametrize("view", ("flat", "store", "delta", "tiny"))
def test_execution_equals_the_8_device_reference(child, port, view):
    """execute (twice), execute_partials, chunk_bytes, the placement
    universe, execute_degraded for every lost subset (all lost raises
    the typed error), and the launch counts of the whole sequence."""
    got, want = port["flat"][view], child["flat"][view]
    assert got["universe"] == want["universe"]
    for name, rec in want["queries"].items():
        mine = got["queries"][name]
        for key in rec:
            assert mine[key] == rec[key], (view, name, key)
        merged = mine["execute"][0]
        for col, d in merged.items():
            parts = [p[col] for p in mine["partials"]]
            assert d["count"] == sum(p["count"] for p in parts)
        for res in mine["degraded"][:-1]:
            assert res[0] == mine["execute"][0] and res[1] > 0
        assert mine["degraded"][-1][0] == "raised"
    assert got["launches"] == want["launches"], view


@pytest.mark.parametrize("view", ("store", "delta"))
def test_grouped_equals_the_8_device_reference(child, port, view):
    """execute_grouped, the (8, G, 3) execute_grouped_planes stacks,
    execute_grouped_degraded for the child's lost subsets, launches."""
    got, want = port["grouped"][view], child["grouped"][view]
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], (view, name)
    for name, _ in GROUPED_QUERIES:
        for res in got[name]["degraded"][:-1]:
            assert res[0] == got[name]["result"]
        assert got[name]["degraded"][-1][0] == "raised"


@pytest.mark.parametrize("view", ("flat", "flat_delta"))
def test_grouped_wide_key_equals_the_8_device_reference(child, port, view):
    """Keys past the dense cutoff (the oracle): execute_grouped and
    execute_grouped_degraded on the plain and delta views, launches."""
    got, want = port["grouped_wide"][view], child["grouped_wide"][view]
    assert got == want, view
    for name, _ in WIDE_QUERIES:
        assert len(got[name]["result"]["groups"]) > 1024, name
        for res in got[name]["degraded"][:-1]:
            assert res[0] == got[name]["result"]
        assert got[name]["degraded"][-1][0] == "raised"


def test_tiered_engine_equals_the_8_device_reference(child, port):
    """A tiered engine over 8 shards: results, summary (tier stats and
    energy ledger at chips = 8), model_check and launches across repeated
    queries (counted once per query shape, as the reference traces)."""
    got, want = port["engine"], child["engine"]
    assert got["n_shards"] == want["n_shards"] == CHILD_SHARDS
    assert got["results"] == want["results"]
    assert got["summary"] == want["summary"]
    assert got["model_check"] == want["model_check"]
    assert got["model_check"]["chips"] == CHILD_SHARDS
    assert got["launches"] == want["launches"]


def test_chaos_shard_loss_equals_the_8_device_reference(child, port):
    got, want = port["chaos"], child["chaos"]
    assert got == want
    assert got["first"] == got["second"]
    res = got["first"]["summary"]["resilience"]
    assert res["shard_losses"] > 0
    assert res["shard_recoveries"] == res["shard_losses"]
    assert got["first"]["summary"]["tier"]["recovery_bytes"] > 0


# --------------------------------------------------------------------------
# the port on 8 ranks against the reference on 8 devices
# --------------------------------------------------------------------------

@pytest.mark.parametrize("view", ("flat", "store", "delta", "tiny"))
def test_rank_layout_equals_the_8_device_reference(child, ranks, view):
    """Every rank: rows_per_shard, nbytes (global), the padded words and
    validity masks gathered from the ranks, row ranges, host_shard_slices
    and key_code_range."""
    want = child["layout"][view]
    for rank, got in enumerate(ranks):
        for key in want:
            assert got["layout"][view][key] == want[key], (rank, view, key)
        assert got["layout"][view].keys() == want.keys()


@pytest.mark.parametrize("view", ("flat", "store", "delta", "tiny"))
def test_rank_execution_equals_the_8_device_reference(child, ranks, view):
    """Every rank: execute (twice), execute_partials, chunk_bytes, the
    placement universe, execute_degraded for every lost subset (all
    lost raises) and the launch counts of the whole sequence."""
    want = child["flat"][view]
    for rank, every in enumerate(ranks):
        got = every["flat"][view]
        assert got["universe"] == want["universe"], rank
        for name, rec in want["queries"].items():
            for key in rec:
                assert got["queries"][name][key] == rec[key], (rank, name,
                                                               key)
        assert got["launches"] == want["launches"], (rank, view)


@pytest.mark.parametrize("view", ("store", "delta"))
def test_rank_grouped_equals_the_8_device_reference(child, ranks, view):
    """Every rank: execute_grouped, the (8, G, 3) planes all-gathered from
    the ranks, execute_grouped_degraded and the launch counts."""
    want = child["grouped"][view]
    for rank, every in enumerate(ranks):
        assert every["grouped"][view] == want, (rank, view)


@pytest.mark.parametrize("view", ("flat", "flat_delta"))
def test_rank_grouped_wide_key_equals_the_8_device_reference(child, ranks,
                                                             view):
    """Every rank: the wide key's fallback, each rank grouping its own
    shard (and the lost shards dealt to it) and the groups merged over
    the ranks, against the reference's oracle; degraded included."""
    want = child["grouped_wide"][view]
    for rank, every in enumerate(ranks):
        assert every["grouped_wide"][view] == want, (rank, view)


def test_rank_tiered_engine_equals_the_8_device_reference(child, ranks):
    """QueryEngine over the rank-mesh table on every rank (SPMD): results,
    summary, model_check at chips = 8 and launches."""
    want = child["engine"]
    for rank, every in enumerate(ranks):
        assert every["engine"] == want, rank
        assert every["engine"]["model_check"]["chips"] == CHILD_SHARDS


def test_rank_chaos_shard_loss_equals_the_8_device_reference(child, ranks):
    want = child["chaos"]
    for rank, every in enumerate(ranks):
        assert every["chaos"] == want, rank


# --------------------------------------------------------------------------
# in process: the port at 1-8 shards against the reference's one device
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sides():
    return _ref_side(), _port_side()


@pytest.fixture(scope="module")
def flat(sides):
    ref, port_ = sides
    jt = flat_table(ref)
    decoded = {c: jt.columns[c].decode() for c in SPEC}
    return jt, flat_table(port_), decoded


def oracle(decoded, sel, agg):
    vals = decoded[agg][sel]
    vmax = (1 << (SPEC[agg] - 1)) - 1
    return {"sum": int(vals.sum()) if sel.any() else 0,
            "count": int(sel.sum()),
            "min": int(vals.min()) if sel.any() else vmax,
            "max": int(vals.max()) if sel.any() else 0}


def run_one(eng, query):
    eng.submit(query)
    return eng.run()[0]


_REF_CACHE: dict = {}


def reference_shape(ref, jt, name, mkplan, aggs):
    """The reference's answers for one plan shape (computed once): its
    1-shard ShardedTable engine in pallas and xla_ref (a fresh table each,
    so its launch counts are a first execution's, then a repeat's) and
    its unsharded engine."""
    if name not in _REF_CACHE:
        rec = {}
        for mode in ("pallas", "xla_ref"):
            st = ref.Sharded.shard(jt, ref.mesh(1))
            eng = ref.q.QueryEngine(st, mode=mode)
            r = run_one(eng, ref.q.Query(mkplan(ref.q), aggregates=aggs))
            first = eng.metrics.launch_counts()
            run_one(eng, ref.q.Query(mkplan(ref.q), aggregates=aggs))
            rec[mode] = (r, first, eng.metrics.launch_counts())
            flat_r = run_one(ref.q.QueryEngine(jt, mode=mode),
                             ref.q.Query(mkplan(ref.q), aggregates=aggs))
            assert flat_r.aggregates == r.aggregates
        _REF_CACHE[name] = rec
    return _REF_CACHE[name]


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("name,mkplan,mksel,aggs", PLAN_SHAPES,
                         ids=[p[0] for p in PLAN_SHAPES])
def test_plan_shapes_equal_the_reference(sides, flat, name, mkplan, mksel,
                                         aggs, n):
    ref, port_ = sides
    jt, tt, decoded = flat
    want = {a: oracle(decoded, mksel(decoded), a) for a in aggs}
    rec = reference_shape(ref, jt, name, mkplan, aggs)
    for mode in ("auto", "torch_ref"):
        # a fresh table each: dispatches count at a shape's first run
        st = port_.Sharded.shard(tt, port_.mesh(n))
        eng = port_.q.QueryEngine(st, mode=mode, device="cpu")
        res = run_one(eng, port_.q.Query(mkplan(port_.q), aggregates=aggs))
        jres, first, again = rec["xla_ref" if mode == "torch_ref"
                                 else "pallas"]
        assert res.aggregates == jres.aggregates == want, (mode, n)
        assert res.count == jres.count
        assert res.selectivity == jres.selectivity
        assert res.bytes_scanned == jres.bytes_scanned
        assert eng.metrics.launch_counts() == first, (mode, n)
        run_one(eng, port_.q.Query(mkplan(port_.q), aggregates=aggs))
        assert eng.metrics.launch_counts() == again == first
        assert eng.n_shards == n and eng.sharded
    parts = st.execute_partials(mkplan(port_.q), aggs)
    assert len(parts) == n
    for a in aggs:
        got = want[a]
        assert sum(p[a]["count"] for p in parts) == got["count"]
        assert sum(p[a]["sum"] for p in parts) == got["sum"]
        hit = [p[a] for p in parts if p[a]["count"]]
        if hit:
            assert min(p["min"] for p in hit) == got["min"]
            assert max(p["max"] for p in hit) == got["max"]


@pytest.mark.parametrize("split", ((1024, 1), (64, 4), (1024, 64)))
@pytest.mark.parametrize("name,mkplan,mksel,aggs", PLAN_SHAPES,
                         ids=[p[0] for p in PLAN_SHAPES])
def test_split_shards_equal_the_reference(sides, flat, monkeypatch, name,
                                          mkplan, mksel, aggs, split):
    """Each shard's words split into sub-chunks for the batched kernels
    (physical.shard_split; the card's shards are 2^22-2^26 words, these
    are hundreds): the folded per-shard rows give the reference's
    answers, partials equal to the unsplit ones, the same launches."""
    from repro_torch.query import physical
    ref, port_ = sides
    jt, tt, decoded = flat
    monkeypatch.setattr(physical, "SPLIT_CHUNKS", split[0])
    monkeypatch.setattr(physical, "SPLIT_WORDS", split[1])
    jres, first, _ = reference_shape(ref, jt, name, mkplan, aggs)["xla_ref"]
    for n in (3, 8):
        st = port_.Sharded.shard(tt, port_.mesh(n))
        eng = port_.q.QueryEngine(st, device="cpu")
        res = run_one(eng, port_.q.Query(mkplan(port_.q), aggregates=aggs))
        assert res.aggregates == jres.aggregates, n
        assert eng.metrics.launch_counts() == first
        parts = st.execute_partials(mkplan(port_.q), aggs)
        monkeypatch.setattr(physical, "SPLIT_WORDS", 1 << 40)
        unsplit = st.execute_partials(mkplan(port_.q), aggs)
        monkeypatch.setattr(physical, "SPLIT_WORDS", split[1])
        assert parts == unsplit


def test_shard_split_divides_evenly():
    from repro_torch.query.physical import shard_split
    assert shard_split(1 << 25, 128, 4096) == 128    # 2^30 rows, 8 shards
    assert shard_split(4 * 9586981, 146, 4096) == 4  # 2^30 rows, 7 shards
    assert shard_split(1 << 25, 1 << 20, 16384) == 2048
    assert shard_split(100, 128, 4096) == 1
    for w in (1, 7, 1000, 1 << 20, 3 * 5 * 7 * 4096):
        for top in (1, 8, 1024):
            for m in (1, 16, 4096):
                k = shard_split(w, top, m)
                assert w % k == 0 and k <= top
                assert k == 1 or w // k >= m


@pytest.fixture(scope="module")
def stores(sides):
    ref, port_ = sides
    js, ts = store_table(ref), store_table(port_)
    return (js, ts,
            ref.EncodedTable.from_table(js, chunk_rows=STORE_CHUNK_ROWS),
            port_.EncodedTable.from_table(ts, chunk_rows=STORE_CHUNK_ROWS))


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("name,mkplan,aggs", STORE_QUERIES,
                         ids=[q[0] for q in STORE_QUERIES])
def test_delta_view_equals_the_reference(sides, stores, name, mkplan, aggs,
                                         n):
    """ShardedEncodedTable: one global frame a column, the deltas packed
    and sharded; answers equal the reference's 1-shard view and the plain
    table's, frames equal the reference's, and the view never exceeds the
    plain device footprint."""
    ref, port_ = sides
    js, ts, jenc, tenc = stores
    se = port_.ShardedEncoded.shard(tenc, port_.mesh(n))
    jse = ref.ShardedEncoded.shard(jenc, ref.mesh(1))
    got = se.execute(mkplan(port_.q), aggs)
    assert got == jse.execute(mkplan(ref.q), aggs, mode="xla_ref") == \
        ref.Sharded.shard(js, ref.mesh(1)).execute(mkplan(ref.q), aggs,
                                                   mode="xla_ref")
    assert se.frames == jse.frames
    assert se.nbytes < port_.Sharded.shard(ts, port_.mesh(n)).nbytes
    eng = port_.q.QueryEngine(se, device="cpu")
    assert run_one(eng, port_.q.Query(mkplan(port_.q),
                                      aggregates=aggs)).aggregates == got


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("view", ("plain", "delta"))
@pytest.mark.parametrize("name,mk", GROUPED_QUERIES,
                         ids=[q[0] for q in GROUPED_QUERIES])
def test_grouped_equals_the_reference(sides, stores, name, mk, view, n):
    ref, port_ = sides
    js, ts, jenc, tenc = stores
    jdim, tdim = dim_table(ref), dim_table(port_)
    want = ref.relational.execute_grouped_oracle(mk(ref.q, jdim), js)
    if view == "plain":
        t = port_.Sharded.shard(ts, port_.mesh(n))
        jt = ref.Sharded.shard(js, ref.mesh(1))
    else:
        t = port_.ShardedEncoded.shard(tenc, port_.mesh(n))
        jt = ref.ShardedEncoded.shard(jenc, ref.mesh(1))
    assert jt.execute_grouped(mk(ref.q, jdim), mode="xla_ref") == want
    got = t.execute_grouped(mk(port_.q, tdim))
    assert got == want
    eng = port_.q.QueryEngine(t, device="cpu")
    assert run_one(eng, mk(port_.q, tdim)).aggregates == want


@pytest.mark.parametrize("n", (1, 8))
def test_engine_sum_exact_beyond_int32(sides, n):
    """tests/test_torch_query_engine.py's 300_000-row 16-bit table: the
    combined sum passes 2^31 while each shard's planes stay normalized."""
    ref, port_ = sides
    t = port_.db.Table.synthetic("big", 300_000, {"p": 16}, seed=5,
                                 device="cpu")
    jt = ref.db.Table.synthetic("big", 300_000, {"p": 16}, seed=5)
    want = int(jt.columns["p"].decode().astype(np.int64).sum())
    assert want > 2**31
    q = port_.q.Query(port_.q.Pred("p", "ge", 0), aggregates=("p",))
    res = run_one(port_.q.QueryEngine(port_.Sharded.shard(t, port_.mesh(n)),
                                      device="cpu"), q)
    jres = run_one(ref.q.QueryEngine(ref.Sharded.shard(jt, ref.mesh(1)),
                                     mode="xla_ref"),
                   ref.q.Query(ref.q.Pred("p", "ge", 0), aggregates=("p",)))
    assert res.aggregates == jres.aggregates
    assert res.aggregates["p"]["sum"] == want and res.count == 300_000


def test_combine_in_int64_agrees_with_the_int32_psum():
    """The port adds the shards' sum planes in int64; the reference's
    psum adds them in int32. Below 2^31 rows the int32 sums cannot
    overflow (lo < 2^16 a shard, hi < 2^31 / 2^16 in total), so the
    finalized sums agree; here at 8 shards of 2^27 rows of 16-bit codes at
    their payload max, the largest int32 case a card holds."""
    from repro_torch.kernels.aggregate.ops import finalize
    from repro_torch.query.physical import combine_rows
    vmax = (1 << 15) - 1
    per_shard = (1 << 27) * vmax
    row = [per_shard & 0xFFFF, per_shard >> 16, 1 << 27, vmax, vmax]
    rows = torch.tensor([row] * 8, dtype=torch.int32)
    int32_planes = rows.sum(0, dtype=torch.int32)
    assert int(int32_planes[1]) == 8 * (per_shard >> 16) < 2**31
    got = finalize(combine_rows(rows))
    assert got == {"sum": 8 * per_shard, "count": 1 << 30, "min": vmax,
                   "max": vmax}
    assert got["sum"] == (int(int32_planes[1]) << 16) + int(int32_planes[0])


def test_shard_errors_equal_the_reference(sides, flat):
    ref, port_ = sides
    jt, tt, _ = flat
    for call in (lambda s, t: s.Sharded.shard(t, s.mesh(1), axis="model"),
                 lambda s, t: s.Sharded.shard(s.db.Table("e"), s.mesh(1))):
        with pytest.raises(ValueError) as got:
            call(port_, tt)
        with pytest.raises(ValueError) as want:
            call(ref, jt)
        assert str(got.value) == str(want.value)
    st = port_.Sharded.shard(tt, port_.mesh(3))
    with pytest.raises(ValueError, match="outside"):
        st.shard_row_range(3)
    with pytest.raises(ValueError, match="outside"):
        port_.execute_degraded(st, port_.q.Pred("a", "lt", 4), ("b",), [5])


def test_padding_free_shards_alias_the_table(sides):
    """When rows split evenly no shard needs padding: the sharded view
    keeps the table's words and validity masks (no copy), with the same
    answers and bytes."""
    _, port_ = sides
    t = port_.db.Table.synthetic("even", 8 * 1024, SPEC, seed=2,
                                 device="cpu")
    st = port_.Sharded.shard(t, port_.mesh(8))
    for name, col in t.columns.items():
        assert st.slices[name].words is col.words
        assert st.slices[name].valid is col.valid_words
    assert st.nbytes == t.nbytes
    q = port_.q.Query(port_.q.Pred("a", "lt", 50) & port_.q.Pred(
        "w", "ge", 9000), aggregates=("w", "x"))
    assert run_one(port_.q.QueryEngine(st, device="cpu"), q).aggregates == \
        run_one(port_.q.QueryEngine(t, device="cpu"), q).aggregates


def test_mesh_stays_on_one_device():
    from repro_torch.launch.mesh import make_mesh
    m = make_mesh((2, 4), ("data", "model"), device="cpu")
    assert m.shape == {"data": 2, "model": 4} and m.size == 8
    assert m.axes == ("data", "model") and m.device == torch.device("cpu")
    assert make_mesh((3,), ("data",), device=["cpu"] * 3).device.type == \
        "cpu"
    with pytest.raises(NotImplementedError, match="group="):
        make_mesh((2,), ("data",), device=["cpu", "meta"])
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((2, 2), ("data",), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((2,), ("data",))
    else:
        assert make_mesh((2,), ("data",)).device.type == "cuda"


def test_sharded_placement_universe_equals_the_reference(sides, flat):
    """PlacementEngine.for_table over a sharded table chunks the padded
    slices, aligned on their own widths."""
    ref, port_ = sides
    jt, tt, _ = flat
    for n in (1, 7):
        pe = port_.placement.PlacementEngine.for_table(
            port_.Sharded.shard(tt, port_.mesh(n)),
            port_.tiers.paper_tiers(1 << 14), port_.placement.Policy.STATIC,
            chunk_rows=300)
        assert sum(pe.nbytes) == port_.Sharded.shard(
            tt, port_.mesh(n)).nbytes
    pe = port_.placement.PlacementEngine.for_table(
        port_.Sharded.shard(tt, port_.mesh(1)),
        port_.tiers.paper_tiers(1 << 14), port_.placement.Policy.STATIC,
        chunk_rows=300)
    jpe = ref.placement.PlacementEngine.for_table(
        ref.Sharded.shard(jt, ref.mesh(1)),
        ref.tiers.paper_tiers(1 << 14), ref.placement.Policy.STATIC,
        chunk_rows=300)
    assert pe.ids == jpe.ids and pe.nbytes.tolist() == jpe.nbytes.tolist()
    assert pe.chunk_rows == jpe.chunk_rows
    assert pe.in_fast.tolist() == jpe.in_fast.tolist()
    assert not math.isnan(pe.resident_fast_fraction)
