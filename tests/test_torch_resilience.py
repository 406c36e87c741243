"""Parity of the port's resilience layer (repro_torch.resilience, the
engine's chaos=, the store's guard=, replay_trace(chaos=)) with
repro.resilience on the CPU.

tests/test_resilience.py's cases run through both packages from the same
seeds and tables (the port's taken across bit for bit): the fault draws
(stalls, shard losses, corrupt chunks, flipped bit positions), retry and
breaker behaviour, ChunkGuard's check / scrub / summary with repair on
and off, engine runs under stalls, retries, the breaker, degraded shards
and prefetch, torn files, and examples/chaos_replay.py's replay at its
own size (8 columns x 8192 rows, 512-row chunks): attainment, summary,
answers, the energy ledger and the recovery spans. Everything is
compared with ==: these are integer paths and modeled time.

The port's chunks tuple is immutable and keys the planes cached on each
column, so a flipped or repaired chunk is installed with
EncodedColumn.replace_chunk; `TestFlipAndCaches` holds that a batched
query after a flip sees the flipped chunk (the reference's answer over
its corrupted store) or, guarded, the repaired one — never stale planes.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest

N_ROWS = 10_001
SPEC = {"a": 8, "b": 8}
CHUNK_ROWS = 2048


def _ref():
    import repro.db as db
    import repro.query as q
    from repro import resilience as res
    from repro.query import physical
    from repro.launch.mesh import make_mesh
    from repro.obs import Tracer
    from repro.serve.sla import VirtualClock
    from repro.store import EncodedTable
    from repro.store.exec import (execute_encoded, execute_grouped_encoded,
                                  identity_ints)
    from repro.tier import (Policy, TraceSpec, make_trace, paper_tiers,
                            replay_trace)
    from repro.tier.placement import PlacementEngine
    from repro.tier.prefetch import PrefetchPipeline
    return SimpleNamespace(
        db=db, q=q, res=res, physical=physical, Tracer=Tracer,
        Clock=VirtualClock,
        EncodedTable=EncodedTable, execute=execute_encoded,
        execute_grouped=execute_grouped_encoded, identity=identity_ints,
        Policy=Policy, TraceSpec=TraceSpec, make_trace=make_trace,
        paper_tiers=paper_tiers, replay_trace=replay_trace,
        PlacementEngine=PlacementEngine, Prefetch=PrefetchPipeline,
        mesh=lambda: make_mesh((1,), ("data",)), kw={},
        modes=("pallas", "xla_ref"),
        plane=lambda x: None if x is None else np.asarray(x).view(
            np.uint32).tolist())


def _port():
    import repro_torch.db as db
    import repro_torch.query as q
    from repro_torch import resilience as res
    from repro_torch.query import physical
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import Tracer
    from repro_torch.serve.sla import VirtualClock
    from repro_torch.store import EncodedTable
    from repro_torch.store.exec import (execute_encoded,
                                        execute_grouped_encoded,
                                        identity_ints)
    from repro_torch.tier import (Policy, TraceSpec, make_trace,
                                  paper_tiers, replay_trace)
    from repro_torch.tier.placement import PlacementEngine
    from repro_torch.tier.prefetch import PrefetchPipeline
    return SimpleNamespace(
        db=db, q=q, res=res, physical=physical, Tracer=Tracer,
        Clock=VirtualClock,
        EncodedTable=EncodedTable, execute=execute_encoded,
        execute_grouped=execute_grouped_encoded, identity=identity_ints,
        Policy=Policy, TraceSpec=TraceSpec, make_trace=make_trace,
        paper_tiers=paper_tiers, replay_trace=replay_trace,
        PlacementEngine=PlacementEngine, Prefetch=PrefetchPipeline,
        mesh=lambda: make_mesh((1,), ("data",), device="cpu"),
        kw={"device": "cpu"}, modes=("auto", "torch_ref"),
        plane=lambda x: None if x is None else x.numpy().view(
            np.uint32).tolist())


@pytest.fixture(scope="module")
def sides():
    return _ref(), _port()


def across(ref_t, name="t"):
    import repro_torch.db as tdb
    return tdb.table_from_arrays(
        {n: (np.asarray(c.words), c.code_bits, c.num_rows, c.dictionary)
         for n, c in ref_t.columns.items()}, name=name, device="cpu")


@pytest.fixture(scope="module")
def tables(sides):
    ref, _ = sides
    jt = ref.db.Table.synthetic("t", N_ROWS, SPEC, seed=3)
    return jt, across(jt)


def store_mix(ref, n_rows=N_ROWS):
    """An RLE, a FOR and a plain column: every payload layout flips."""
    rng = np.random.default_rng(5)
    t = ref.db.Table("s")
    for name, vals, bits in (
            ("r", np.sort(rng.integers(0, 8, n_rows)), 8),
            ("f", 40 + rng.integers(0, 8, n_rows), 8),
            ("u", rng.integers(0, 128, n_rows), 8)):
        t.add(ref.db.BitPackedColumn.from_values(name, vals, bits))
    return t


def encoded_pair(sides, ref_t, port_t):
    ref, port = sides
    return (ref.EncodedTable.from_table(ref_t, chunk_rows=CHUNK_ROWS),
            port.EncodedTable.from_table(port_t, chunk_rows=CHUNK_ROWS))


def chunk_state(side, ch) -> tuple:
    return (ch.encoding.value, ch.n_rows, ch.width, ch.base, ch.n_runs,
            ch.checksum, side.plane(ch.words), side.plane(ch.values),
            side.plane(ch.lengths))


def store_state(side, et) -> list:
    return [[chunk_state(side, ch) for ch in col.chunks]
            for col in et.columns.values()]


def query(side):
    return side.q.Query(side.q.Pred("a", "lt", 50), aggregates=("b",))


# --------------------------------------------------------------------------
# fault draws
# --------------------------------------------------------------------------
class TestFaultInjector:
    SPECS = (dict(seed=9, stall_rate=0.5, corrupt_rate=0.3,
                  shard_loss_rate=0.4),
             dict(seed=42, stall_rate=0.1, corrupt_rate=0.05,
                  shard_loss_rate=1.0),
             dict(seed=0))

    @pytest.mark.parametrize("spec", SPECS)
    def test_draws_equal_the_reference(self, sides, spec):
        ref, port = sides
        mine = port.res.FaultInjector(port.res.FaultSpec(**spec))
        theirs = ref.res.FaultInjector(ref.res.FaultSpec(**spec))
        events = [(q, ("col", c), a) for q in range(6) for c in range(5)
                  for a in (0, 1, 2, 1 << 20)]
        assert [mine.stalled(*e) for e in events] == \
            [theirs.stalled(*e) for e in events]
        for n in (1, 2, 7, 8):
            assert [mine.lost_shards(q, n) for q in range(40)] == \
                [theirs.lost_shards(q, n) for q in range(40)]
        ids = [(c, i) for c in ("a", "b", "c07") for i in range(64)]
        assert mine.corrupt_chunks(ids) == theirs.corrupt_chunks(ids)
        assert mine.spec.as_dict() == theirs.spec.as_dict()

    def test_draws_commute_and_replay(self, sides):
        _, port = sides
        inj = port.res.FaultInjector(port.res.FaultSpec(
            seed=9, stall_rate=0.5, corrupt_rate=0.3, shard_loss_rate=0.4))
        events = [(q, ("col", c), a) for q in range(5) for c in range(4)
                  for a in range(3)]
        fwd = [inj.stalled(*e) for e in events]
        rev = [inj.stalled(*e) for e in reversed(events)]
        assert fwd == rev[::-1]
        ids = [("a", i) for i in range(16)]
        assert inj.corrupt_chunks(ids) == inj.corrupt_chunks(ids[::-1])[::-1]
        assert inj.lost_shards(3, 8) == inj.lost_shards(3, 8)

    @pytest.mark.parametrize("kw", (dict(stall_rate=1.5),
                                    dict(corrupt_rate=-0.1),
                                    dict(stall_factor=0.5)))
    def test_spec_validation_equals_the_reference(self, sides, kw):
        ref, port = sides
        with pytest.raises(ValueError) as got:
            port.res.FaultSpec(**kw)
        with pytest.raises(ValueError) as want:
            ref.res.FaultSpec(**kw)
        assert str(got.value) == str(want.value)

    def test_rates_zero_is_silent(self, sides):
        _, port = sides
        inj = port.res.FaultInjector(port.res.FaultSpec(seed=1))
        assert not inj.stalled(1, ("a", 0), 0)
        assert inj.lost_shards(1, 8) == ()
        assert inj.corrupt_chunks([("a", 0)]) == []
        with pytest.raises(TypeError, match="strings and ints"):
            inj._rng(1.5)

    @pytest.mark.parametrize("seed", (4, 6, 11))
    def test_flip_bit_equals_the_reference(self, sides, seed):
        """Every chunk of an RLE / FOR / plain store: the port's flipped
        copy holds the reference's flipped planes (same position, same
        bit), fails its checksum, and leaves the original intact."""
        ref, port = sides
        jt = store_mix(ref)
        jenc, tenc = encoded_pair(sides, jt, across(jt))
        mine = port.res.FaultInjector(port.res.FaultSpec(seed=seed))
        theirs = ref.res.FaultInjector(ref.res.FaultSpec(seed=seed))
        for name in jenc.columns:
            for ci, (jch, tch) in enumerate(zip(jenc.columns[name].chunks,
                                                tenc.columns[name].chunks)):
                before = chunk_state(port, tch)
                flipped = mine.flip_bit(tch, name, ci)
                assert theirs.flip_bit(jch, name, ci) is (flipped is not None)
                assert chunk_state(port, tch) == before and tch.verify()
                assert chunk_state(port, flipped) == chunk_state(ref, jch)
                assert not flipped.verify() and not jch.verify()
                assert flipped.stats is tch.stats

    def test_flip_bit_of_an_empty_chunk(self, sides):
        _, port = sides
        from repro_torch.store import encode_chunk
        inj = port.res.FaultInjector(port.res.FaultSpec(seed=1))
        for enc in ("rle", "plain", "for"):
            assert inj.flip_bit(encode_chunk([], 8, enc, device="cpu"),
                                "a", 0) is None


# --------------------------------------------------------------------------
# retry and the breaker
# --------------------------------------------------------------------------
class TestRetryAndBreaker:
    def test_backoff_and_budget_equal_the_reference(self, sides):
        ref, port = sides
        kw = dict(timeout_s=1.0, backoff_s=0.1, backoff_cap_s=0.3,
                  growth=2.0, max_retries=5)
        mine, theirs = port.res.RetryPolicy(**kw), ref.res.RetryPolicy(**kw)
        assert [mine.backoff(k) for k in range(8)] == \
            [theirs.backoff(k) for k in range(8)] == \
            [0.1, 0.2, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3]
        assert mine.worst_case_extra_s() == theirs.worst_case_extra_s() \
            == pytest.approx(5 * 1.0 + 1.2)
        assert mine.as_dict() == theirs.as_dict()

    @pytest.mark.parametrize("kw", (dict(timeout_s=0.0),
                                    dict(timeout_s=math.inf),
                                    dict(timeout_s=1.0, max_retries=-1),
                                    dict(timeout_s=1.0, growth=0.5),
                                    dict(timeout_s=1.0, backoff_s=-1.0)))
    def test_retry_validation_equals_the_reference(self, sides, kw):
        ref, port = sides
        with pytest.raises(ValueError) as got:
            port.res.RetryPolicy(**kw)
        with pytest.raises(ValueError) as want:
            ref.res.RetryPolicy(**kw)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError) as got:
            port.res.RetryPolicy(timeout_s=1.0).backoff(-1)
        with pytest.raises(ValueError) as want:
            ref.res.RetryPolicy(timeout_s=1.0).backoff(-1)
        assert str(got.value) == str(want.value)

    def test_breaker_walks_the_reference_states(self, sides):
        ref, port = sides
        rng = np.random.default_rng(0)
        steps = [(str(rng.choice(["fault", "ok", "allow"])),
                  float(t)) for t in np.cumsum(rng.uniform(0, 4e-3, 200))]
        seen = []
        for side in (port, ref):
            b = side.res.CircuitBreaker(fail_threshold=3, cooldown_s=5e-3)
            trail = []
            for kind, t in steps:
                if kind == "fault":
                    b.record_fault(t)
                elif kind == "ok":
                    b.record_ok(t)
                else:
                    trail.append(b.allow_fast(t))
                trail.append((b.state, b.consecutive_faults, b.opens))
            seen.append((trail, b.summary()))
        assert seen[0] == seen[1]
        assert seen[0][1]["opens"] > 0
        for kw in (dict(fail_threshold=0), dict(cooldown_s=0.0)):
            with pytest.raises(ValueError) as got:
                port.res.CircuitBreaker(**kw)
            with pytest.raises(ValueError) as want:
                ref.res.CircuitBreaker(**kw)
            assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# checksummed chunks: detect, quarantine, repair
# --------------------------------------------------------------------------
class TestChunkGuard:
    def corrupted(self, sides, spec, repair=True, mk=None):
        """Both packages' stores of the same table, a guard each, and
        the same seeded bits flipped."""
        ref, port = sides
        jt = (mk or store_mix)(ref)
        jenc, tenc = encoded_pair(sides, jt, across(jt))
        out = []
        for side, enc in ((ref, jenc), (port, tenc)):
            guard = side.res.ChunkGuard(enc, repair=repair)
            chaos = side.res.ChaosHarness(side.res.FaultSpec(**spec),
                                          guard=guard, recover=repair)
            out.append((enc, guard, chaos.inject_corruption()))
        return out

    @pytest.mark.parametrize("seed", (4, 9))
    def test_guard_repairs_from_oracle(self, sides, seed):
        ref, port = sides
        (jenc, jguard, jids), (tenc, tguard, tids) = self.corrupted(
            sides, dict(seed=seed, corrupt_rate=0.4))
        assert tids == jids and tids
        clean = store_mix(ref)
        plans = [(lambda q: q.Pred("u", "lt", 50), ("f",)),
                 (lambda q: q.Pred("r", "lt", 4), ("r",)),
                 (lambda q: q.Pred("f", "ge", 42) & q.Pred("u", "lt", 90),
                  ("u", "r"))]
        for mk, aggs in plans:
            want = ref.execute(mk(ref.q), aggs, ref.EncodedTable.from_table(
                clean, chunk_rows=CHUNK_ROWS), mode="xla_ref")
            got = port.execute(mk(port.q), aggs, tenc, guard=tguard)
            assert got == want == ref.execute(mk(ref.q), aggs, jenc,
                                              mode="xla_ref", guard=jguard)
        assert tguard.quarantined == jguard.quarantined
        assert tguard.repaired == jguard.repaired
        assert set(tguard.repaired) == set(tguard.quarantined)
        assert tguard.summary() == jguard.summary()
        assert tguard.repair_logical_bytes_total > 0
        # the repaired chunks are the reference's re-encodings, and verify
        assert store_state(port, tenc) == store_state(ref, jenc)
        n = len(tguard.repaired)
        assert port.execute(plans[0][0](port.q), plans[0][1], tenc,
                            guard=tguard) is not None
        assert len(tguard.repaired) == n

    def test_scrub_and_summary(self, sides):
        (jenc, jguard, jids), (tenc, tguard, tids) = self.corrupted(
            sides, dict(seed=6, corrupt_rate=0.5))
        assert tguard.scrub() == jguard.scrub()
        assert tguard.summary() == jguard.summary()
        assert tguard.summary()["repaired"] == len(tids) > 0
        assert tguard.scrub() == jguard.scrub() == []
        assert tguard.chunk_ids() == jguard.chunk_ids()

    def test_no_repair_raises_typed(self, sides):
        ref, port = sides
        (jenc, jguard, _), (tenc, tguard, _) = self.corrupted(
            sides, dict(seed=4, corrupt_rate=0.4), repair=False)
        for call in (
                lambda s, e, g: s.execute(s.q.Pred("u", "lt", 50), ("f",),
                                          e, guard=g,
                                          **({"mode": "xla_ref"}
                                             if s is ref else {})),
                lambda s, e, g: s.execute_grouped(
                    s.q.GroupBy("r", ("u",)), e, guard=g,
                    **({"mode": "xla_ref"} if s is ref else {}))):
            with pytest.raises(port.res.ChunkCorruptionError) as got:
                call(port, tenc, tguard)
            with pytest.raises(ref.res.ChunkCorruptionError) as want:
                call(ref, jenc, jguard)
            assert str(got.value) == str(want.value)
            assert "checksum" in str(got.value)
        assert isinstance(got.value, port.res.DegradedResultError)
        assert tguard.quarantined == jguard.quarantined
        assert tguard.repaired == []

    def test_verify_chunks_equals_verify(self, sides):
        """One host copy for a batch of chunks gives each chunk's own
        verify() verdict: clean, flipped and empty chunks alike."""
        from repro_torch.store import encode_chunk
        from repro_torch.store.encode import verify_chunks
        (_, _, _), (tenc, _, tids) = self.corrupted(
            sides, dict(seed=4, corrupt_rate=0.4))
        chunks = [ch for col in tenc.columns.values() for ch in col.chunks]
        chunks += [encode_chunk([], 8, enc, device="cpu")
                   for enc in ("rle", "plain", "for")]
        got = verify_chunks(chunks)
        assert got == [ch.verify() for ch in chunks]
        assert got.count(False) == len(tids) > 0
        assert verify_chunks([]) == []

    def test_guard_needs_a_store(self, sides, tables):
        ref, port = sides
        jt, tt = tables
        with pytest.raises(ValueError) as got:
            port.res.ChunkGuard(tt)
        with pytest.raises(ValueError) as want:
            ref.res.ChunkGuard(jt)
        assert str(got.value) == str(want.value)


class TestFlipAndCaches:
    """A batched store query caches its bound planes on the column, keyed
    by the chunks tuple: after a flip it must see the flipped chunk (the
    reference's answer over its corrupted store), and with a guard the
    repaired one (the clean answer)."""

    PLANS = [(lambda q: q.Pred("u", "lt", 50), ("f",)),
             (lambda q: q.Pred("r", "lt", 4), ("r",)),
             (lambda q: q.Pred("f", "ge", 42) & q.Pred("u", "lt", 90),
              ("u",))]

    def test_flat_queries_see_the_flip_then_the_repair(self, sides):
        ref, port = sides
        jt = store_mix(ref)
        jenc, tenc = encoded_pair(sides, jt, across(jt))
        clean = [port.execute(mk(port.q), aggs, tenc)
                 for mk, aggs in self.PLANS]       # planes now cached
        out = []
        for side, enc in ((ref, jenc), (port, tenc)):
            guard = side.res.ChunkGuard(enc)
            ids = side.res.ChaosHarness(
                side.res.FaultSpec(seed=4, corrupt_rate=0.4),
                guard=guard).inject_corruption()
            out.append((guard, ids))
        (jguard, jids), (tguard, tids) = out
        assert tids == jids and tids
        flipped = [port.execute(mk(port.q), aggs, tenc)
                   for mk, aggs in self.PLANS]
        assert flipped == [ref.execute(mk(ref.q), aggs, jenc,
                                       mode="xla_ref")
                           for mk, aggs in self.PLANS]
        assert flipped == [port.execute(mk(port.q), aggs, tenc,
                                        batched=False)
                           for mk, aggs in self.PLANS]
        assert flipped != clean            # the flips reached the answers
        repaired = [port.execute(mk(port.q), aggs, tenc, guard=tguard)
                    for mk, aggs in self.PLANS]
        assert repaired == clean
        assert store_state(port, tenc) == store_state(
            ref, ref.EncodedTable.from_table(jt, chunk_rows=CHUNK_ROWS))

    def test_grouped_queries_see_the_flip_then_the_repair(self, sides):
        ref, port = sides
        jt = store_mix(ref)
        jenc, tenc = encoded_pair(sides, jt, across(jt))
        shapes = (lambda q: q.GroupBy("r", ("u",)),
                  lambda q: q.GroupBy("f", ("u",),
                                      where=q.Pred("u", "lt", 64)),
                  lambda q: q.GroupBy("r", where=q.Pred("r", "le", 4)))
        clean = [port.execute_grouped(mk(port.q), tenc) for mk in shapes]
        guards = []
        for side, enc in ((ref, jenc), (port, tenc)):
            guard = side.res.ChunkGuard(enc)
            side.res.ChaosHarness(side.res.FaultSpec(seed=9,
                                                     corrupt_rate=0.3),
                                  guard=guard).inject_corruption()
            guards.append(guard)
        flipped = [port.execute_grouped(mk(port.q), tenc) for mk in shapes]
        assert flipped == [ref.execute_grouped(mk(ref.q), jenc,
                                               mode="xla_ref")
                           for mk in shapes]
        assert flipped != clean
        assert [port.execute_grouped(mk(port.q), tenc, guard=guards[1])
                for mk in shapes] == clean == [
            ref.execute_grouped(mk(ref.q), jenc, mode="xla_ref",
                                guard=guards[0]) for mk in shapes]
        assert guards[1].summary() == guards[0].summary()
        assert guards[1].summary()["repaired"] > 0


# --------------------------------------------------------------------------
# the engine under chaos
# --------------------------------------------------------------------------

def make_engine(side, table, spec, *, recover=True, retry=None,
                breaker=None, guard=None, policy="cache",
                chunk_rows=CHUNK_ROWS, fast_fraction=0.5, prefetch=0):
    clock = side.Clock()
    pe = side.PlacementEngine.for_table(
        table, side.paper_tiers(max(1, int(table.nbytes * fast_fraction))),
        side.Policy(policy), chunk_rows=chunk_rows)
    pf = side.Prefetch(pe, prefetch) if prefetch else None
    chaos = side.res.ChaosHarness(
        side.res.FaultSpec(**spec), recover=recover,
        retry=None if retry is None else side.res.RetryPolicy(**retry),
        breaker=None if breaker is None
        else side.res.CircuitBreaker(**breaker), guard=guard)
    mode = {"mode": "xla_ref"} if not side.kw else side.kw
    return side.q.QueryEngine(table, clock=clock, tiered=pe, chaos=chaos,
                              prefetch=pf, **mode), clock


def run_n(side, eng, clock, n, deadline_s=10.0, mk=None):
    out = []
    for _ in range(n):
        eng.submit(mk(side) if mk else query(side),
                   deadline=clock() + deadline_s)
        out.extend(eng.run())
    return out


def results(rs):
    return [(r.qid, r.aggregates, r.count, r.latency_s, r.met, r.tier,
             r.degraded, r.error) for r in rs]


def both(sides, tables, n, spec, **kw):
    ref, port = sides
    jt, tt = tables
    out = []
    for side, t in ((port, tt), (ref, jt)):
        eng, clock = make_engine(side, t, spec, **kw)
        rs = run_n(side, eng, clock, n)
        out.append((eng, rs))
    (teng, trs), (jeng, jrs) = out
    assert results(trs) == results(jrs)
    assert teng.summary() == jeng.summary()
    assert [c.as_dict() for c in teng.tiered.meter.charges] == \
        [c.as_dict() for c in jeng.tiered.meter.charges]
    return teng, trs


class TestEngineUnderChaos:
    def test_bit_exact_and_deterministic_under_stalls(self, sides, tables):
        ref, port = sides
        jt, tt = tables
        kw = dict(retry=dict(timeout_s=1e-9, backoff_s=1e-8,
                             max_retries=2))
        e1, r1 = both(sides, tables, 10, dict(seed=7, stall_rate=0.4), **kw)
        e2, r2 = both(sides, tables, 10, dict(seed=7, stall_rate=0.4), **kw)
        want = run_n(port, *make_engine(port, tt, dict(seed=1)), 1)[0]
        assert all(r.aggregates == want.aggregates for r in r1)
        assert results(r1) == results(r2)
        s = e1.summary()["resilience"]
        assert s == e2.summary()["resilience"]
        assert s["stalls"] > 0 and s["retries"] > 0

    def test_fault_free_chaos_equals_plain_tiered(self, sides, tables):
        _, port = sides
        _, tt = tables
        eng_c, _ = both(sides, tables, 5, dict(seed=1))
        clk = port.Clock()
        eng_p = port.q.QueryEngine(
            tt, clock=clk, device="cpu",
            tiered=port.PlacementEngine.for_table(
                tt, port.paper_tiers(tt.nbytes // 2), port.Policy.CACHE,
                chunk_rows=CHUNK_ROWS))
        rp = run_n(port, eng_p, clk, 5)
        for a, b in zip(eng_c.results, rp):
            assert (a.aggregates, a.latency_s, a.tier) == \
                (b.aggregates, b.latency_s, b.tier)
        assert eng_c.summary()["energy"]["recovery_j"] == 0
        assert eng_c.summary()["tier"]["recovery_bytes"] == 0

    def test_retry_bytes_charged_exactly_once(self, sides, tables):
        eng, _ = both(sides, tables, 8, dict(seed=7, stall_rate=0.5),
                      retry=dict(timeout_s=1e-9, max_retries=2))
        meter = eng.tiered.meter
        kinds = {}
        for c in meter.charges:
            kinds.setdefault(c.kind, []).append(c)
        assert set(kinds) == {"query", "recovery"}
        qids = [c.qid for c in kinds["recovery"]]
        assert len(qids) == len(set(qids))
        assert sum(c.fast_bytes + c.capacity_bytes for c in meter.charges) \
            == eng.tiered.fast_bytes_total + eng.tiered.capacity_bytes_total
        assert eng.tiered.recovery_bytes_total == sum(
            c.fast_bytes + c.capacity_bytes for c in kinds["recovery"])

    def test_no_recovery_stalls_ride_to_completion(self, sides, tables):
        spec = dict(seed=7, stall_rate=0.4, stall_factor=64.0)
        _, rr = both(sides, tables, 10, spec,
                     retry=dict(timeout_s=1e-9, max_retries=1))
        en, rn = both(sides, tables, 10, spec, recover=False)
        assert sum(r.latency_s for r in rr) < sum(r.latency_s for r in rn)
        assert en.summary()["resilience"]["retries"] == 0

    def test_admission_rejects_inflated_estimate(self, sides, tables):
        ref, port = sides
        jt, tt = tables
        got = []
        for side, t in ((port, tt), (ref, jt)):
            eng, clock = make_engine(
                side, t, dict(seed=7, stall_rate=0.5),
                retry=dict(timeout_s=5e-4, backoff_s=1e-4, max_retries=3))
            q = query(side)
            base = eng._est_service_s(type("P", (), {
                "bytes_scanned": eng.bytes_scanned(q),
                "chunks": eng.chunk_accesses(q)})())
            got.append((base,
                        eng.submit(q, deadline=clock() + base * 0.5),
                        eng.submit(q, deadline=clock() + base * 2.0),
                        eng.rejected))
        assert got[0] == got[1]
        assert got[0][1] is None and got[0][2] is not None

    def test_breaker_demotes_and_recovers(self, sides, tables):
        spec = dict(seed=3, stall_rate=0.9, stall_factor=64.0)
        retry = dict(timeout_s=1e-9, max_retries=1)
        eng, _ = both(sides, tables, 10, spec, retry=retry,
                      breaker=dict(fail_threshold=2, cooldown_s=1e-3))
        assert eng.summary()["resilience"]["breaker"]["opens"] >= 1
        eng2, _ = both(sides, tables, 6, spec, retry=retry,
                       breaker=dict(fail_threshold=1, cooldown_s=1e9),
                       policy="memcache")
        assert eng2.tiered.demoted
        assert eng2.tiered.freq.sum() > 0

    def test_degraded_reports_count_as_missed(self, sides, tables):
        ref, port = sides
        jt, tt = tables
        got = []
        for side, t in ((port, tt), (ref, jt)):
            st = side.q.ShardedTable.shard(t, side.mesh())
            eng, clock = make_engine(side, st,
                                     dict(seed=2, shard_loss_rate=0.9),
                                     recover=False)
            eng.chaos.injector.lost_shards = \
                lambda qid, n: (0,) if qid % 2 == 0 else ()
            rs = run_n(side, eng, clock, 6)
            got.append((results(rs), eng.summary()))
        assert got[0] == got[1]
        rs, s = got[0]
        degraded = [r for r in rs if r[6]]
        assert degraded
        for r in degraded:
            assert r[1] == {} and r[2] == 0 and not r[4] and r[7]
        assert s["degraded"] == len(degraded)
        assert s["sla_attainment"] == (len(rs) - len(degraded)) / len(rs)

    def test_guard_of_another_table_is_refused(self, sides, tables):
        ref, port = sides
        jt, tt = tables
        msgs = []
        for side, t in ((port, tt), (ref, jt)):
            other = side.EncodedTable.from_table(t, chunk_rows=CHUNK_ROWS)
            with pytest.raises(ValueError) as e:
                make_engine(side, side.EncodedTable.from_table(
                    t, chunk_rows=CHUNK_ROWS), dict(seed=1),
                    guard=side.res.ChunkGuard(other))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and "different table" in msgs[0]


class TestDegradedIdentities:
    @pytest.mark.parametrize("mode", ("auto", "torch_ref"))
    def test_empty_selection_identity_under_faults(self, sides, tables,
                                                   mode):
        _, port = sides
        _, tt = tables
        q = port.q.Query(port.q.Pred("a", "gt", 127), aggregates=("b",))
        et = port.EncodedTable.from_table(tt, chunk_rows=CHUNK_ROWS)
        guard = port.res.ChunkGuard(et)
        port.res.ChaosHarness(port.res.FaultSpec(seed=4, corrupt_rate=0.4),
                              guard=guard).inject_corruption()
        got = port.execute(q.plan(), q.aggregates, et, mode=mode,
                           guard=guard)
        assert got == {"b": port.identity(SPEC["b"])}

    @pytest.mark.parametrize("mode", ("auto", "torch_ref"))
    def test_zero_row_shard_recovery_is_identity(self, sides, mode):
        ref, port = sides
        got = []
        for side, m in ((port, mode), (ref, "xla_ref")):
            t = side.db.Table.synthetic("z", 7, {"a": 8, "b": 8}, seed=1,
                                        **side.kw)
            st = side.q.ShardedTable.shard(t, side.mesh())
            q = side.q.Query(side.q.Pred("a", "ge", 0), aggregates=("b",))
            with pytest.raises(side.res.DegradedResultError,
                               match="all 1 shards") as e:
                side.res.execute_degraded(st, q.plan(), q.aggregates, [0],
                                          mode=m)
            d, rb = side.res.execute_degraded(st, q.plan(), q.aggregates,
                                              [], mode=m)
            assert d == st.execute(q.plan(), q.aggregates, mode=m)
            got.append((str(e.value), d, rb))
        assert got[0] == got[1]

    def test_lost_shard_validation(self, sides, tables):
        ref, port = sides
        jt, tt = tables
        msgs = []
        for side, t in ((port, tt), (ref, jt)):
            st = side.q.ShardedTable.shard(t, side.mesh())
            q = query(side)
            with pytest.raises(ValueError, match="outside") as e:
                side.res.execute_degraded(st, q.plan(), q.aggregates, [5])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


class TestTornFiles:
    def test_tear_equals_the_reference(self, sides, tmp_path):
        ref, port = sides
        for seed in (6, 8):
            paths = []
            for side in (port, ref):
                d = tmp_path / f"{side.modes[0]}{seed}"
                d.mkdir()
                p = d / "node.0.heartbeat"
                p.write_bytes(b"0123456789" * 20)
                assert side.res.FaultInjector(
                    side.res.FaultSpec(seed=seed)).tear_file(p)
                paths.append(p.read_bytes())
            assert paths[0] == paths[1] and len(paths[0]) < 200
        inj = port.res.FaultInjector(port.res.FaultSpec(seed=1))
        assert not inj.tear_file(tmp_path / "missing")
        (tmp_path / "empty").write_bytes(b"")
        assert not inj.tear_file(tmp_path / "empty")


class TestPrefetchUnderChaos:
    def test_stalled_streams_never_wrong_and_charge_once(self, sides,
                                                         tables):
        from collections import Counter
        buf = max(1, int(tables[1].nbytes * 0.25))
        kw = dict(retry=dict(timeout_s=1e-6, max_retries=1),
                  fast_fraction=0.4)
        _, clean = both(sides, tables, 8, dict(seed=11), **kw)
        eng, faulted = both(sides, tables, 8, dict(seed=11, stall_rate=0.5),
                            prefetch=buf, **kw)
        for r0, r1 in zip(clean, faulted):
            assert r1.aggregates == r0.aggregates
        assert eng.chaos.prefetch_stalls > 0
        recovery = [c for c in eng.tiered.meter.charges
                    if c.kind == "recovery"]
        assert all(n <= 1 for n in Counter(c.qid for c in recovery).values())
        assert sum(c.capacity_bytes for c in recovery) > 0
        assert eng.prefetch.stats()["stalled_chunks"] == \
            eng.chaos.prefetch_stalls

    def test_chaos_prefetch_replay_is_deterministic(self, sides, tables):
        buf = max(1, int(tables[1].nbytes * 0.25))
        kw = dict(retry=dict(timeout_s=1e-6, max_retries=1),
                  fast_fraction=0.4, prefetch=buf)
        ea, ra = both(sides, tables, 8, dict(seed=5, stall_rate=0.3), **kw)
        eb, rb = both(sides, tables, 8, dict(seed=5, stall_rate=0.3), **kw)
        assert results(ra) == results(rb)
        assert ea.prefetch.stats() == eb.prefetch.stats()

    def test_prefetch_under_breaker_demotion_stages_nothing(self, sides,
                                                            tables):
        ref, port = sides
        jt, tt = tables
        got = []
        for side, t in ((port, tt), (ref, jt)):
            eng, clock = make_engine(
                side, t, dict(seed=0), fast_fraction=0.4,
                breaker=dict(fail_threshold=1, cooldown_s=1e9),
                prefetch=max(1, int(t.nbytes * 0.25)))
            eng.chaos.breaker.record_fault(0.0)
            run_n(side, eng, clock, 3)
            got.append((eng.tiered.demoted, eng.prefetch.stats(),
                        eng.summary()))
        assert got[0] == got[1]
        assert got[0][0] and got[0][1]["staged_chunks"] == 0


# --------------------------------------------------------------------------
# examples/chaos_replay.py's replay, at its own size
# --------------------------------------------------------------------------
N_COLS, REPLAY_ROWS, REPLAY_CHUNK_ROWS = 8, 8192, 512
REPLAY_SPEC = dict(seed=42, stall_rate=0.1, corrupt_rate=0.05)
SLA_SLACK = 2.5


def chaos_run(side, recover: bool, mode=None):
    """examples/chaos_replay.py::chaos_run, traced, on either package."""
    import repro.db as rdb
    jt = rdb.Table.synthetic(
        "events", REPLAY_ROWS, {f"c{i:02d}": 8 for i in range(N_COLS)},
        seed=0)
    table = jt if not side.kw else across(jt, "events")
    encoded = side.EncodedTable.from_table(table,
                                           chunk_rows=REPLAY_CHUNK_ROWS)
    tiers = side.paper_tiers(table.nbytes * 0.25, fast_gbps=0.016)
    trace = side.make_trace(table, side.TraceSpec(n_queries=120, skew=1.2,
                                                  seed=11))
    clean_s = (encoded.nbytes
               / sum(len(c.chunks) for c in encoded.columns.values())
               / tiers.fast.bandwidth)
    chaos = side.res.ChaosHarness(
        side.res.FaultSpec(**REPLAY_SPEC),
        guard=side.res.ChunkGuard(encoded), recover=recover,
        retry=side.res.RetryPolicy(timeout_s=2.0 * clean_s,
                                   backoff_s=0.5 * clean_s, max_retries=2))
    corrupted = chaos.inject_corruption()
    bytes_typ = sum(
        side.physical.referenced_bytes(tq.query.plan(),
                                       tq.query.aggregates, encoded.columns)
        for tq in trace) / len(trace)
    sla_s = SLA_SLACK * bytes_typ / tiers.fast.bandwidth
    tracer = side.Tracer()
    kw = {"mode": mode} if mode else {}
    pe, eng, att = side.replay_trace(encoded, trace, tiers,
                                     side.Policy.CACHE, sla_s=sla_s,
                                     chunk_rows=REPLAY_CHUNK_ROWS,
                                     chaos=chaos, tracer=tracer, **kw)
    answers = [(r.qid, r.degraded, tuple(sorted(
        (k, tuple(sorted(v.items()))) for k, v in r.aggregates.items())))
        for r in eng.results]
    spans = [(qt.qid, qt.t_start, qt.t_end, qt.met, qt.degraded, qt.error,
              [sp.as_dict() for sp in qt.spans]) for qt in tracer.queries]
    return {"attainment": att, "summary": chaos.summary(),
            "recovery_j": pe.meter.recovery_j, "answers": answers,
            "corrupted": corrupted, "ledger": [c.as_dict()
                                               for c in pe.meter.charges],
            "meter": pe.meter.summary(), "tier": pe.stats(),
            "spans": spans, "results": results(eng.results)}


@pytest.fixture(scope="module")
def replays(sides):
    ref, port = sides
    return {"ref_on": chaos_run(ref, True, "xla_ref"),
            "ref_off": chaos_run(ref, False, "xla_ref"),
            "on": chaos_run(port, True), "again": chaos_run(port, True),
            "off": chaos_run(port, False),
            "torch_ref": chaos_run(port, True, "torch_ref")}


class TestChaosReplay:
    def test_replay_equals_the_reference(self, replays):
        assert replays["on"] == replays["ref_on"]
        assert replays["off"] == replays["ref_off"]

    def test_same_seed_same_verdict(self, replays):
        assert replays["on"] == replays["again"] == replays["torch_ref"]
        s = replays["on"]["summary"]
        assert s["stalls"] > 0 and s["repairs"] > 0 and s["retries"] > 0
        assert s["degraded_queries"] == 0
        assert replays["on"]["corrupted"]

    def test_recovery_buys_attainment(self, replays):
        on, off = replays["on"], replays["off"]
        assert on["attainment"] > off["attainment"]
        assert off["summary"]["degraded_queries"] > 0
        clean = {qid: a for qid, d, a in on["answers"]}
        for qid, degraded, ans in off["answers"]:
            if not degraded:
                assert ans == clean[qid]

    def test_recovery_spans_carry_the_recovery_ledger(self, replays):
        on = replays["on"]
        kinds = {sp["kind"] for *_, sps in on["spans"] for sp in sps}
        assert {"repair", "retry"} <= kinds
        rec_j = sum(sp.get("joules", 0.0) for *_, sps in on["spans"]
                    for sp in sps if sp.get("ledger") == "recovery")
        assert rec_j == pytest.approx(on["recovery_j"], rel=1e-12)
