"""Parity of the port's compressed store with repro.store on the CPU.

The reference table of tests/test_store.py (6001 rows, chunk 1024: an RLE
column, two FOR columns, a plain one and a 4-bit one, every column with
tail padding in its last chunk) is taken across bit for bit
(table_from_arrays) and encoded by the port on the CPU. Encodings,
statistics, planes, checksums and byte counts must equal the reference's;
the sixteen plan shapes must give the same aggregates, bytes, launch
counts and batch records through execute_encoded (batched and not) and
through QueryEngine. Integer paths: no tolerance anywhere.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.db as rdb
import repro.query as rq
import repro_torch.db as tdb
import repro_torch.query as tq
from repro.kernels import dispatch as jdispatch
from repro.obs import metrics as jmetrics
from repro.store import EncodedTable as JTable
from repro.store import Encoding as JEncoding
from repro.store import encode_chunk as j_encode_chunk
from repro.store import execute_encoded as j_execute
from repro.store.exec import translate_pred as j_translate_pred
from repro_torch.kernels import dispatch
from repro_torch.obs import metrics as tmetrics
from repro_torch.store import (EncodedTable, Encoding, EncodingStats,
                               choose_encoding, encode_chunk,
                               encoded_table_from_arrays, execute_encoded,
                               translate_pred)
from repro_torch.store.exec import fixup_base, identity_ints

N_ROWS = 6001
CHUNK_ROWS = 1024
OPS = ("lt", "le", "gt", "ge", "eq", "ne")


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
    t.add(rdb.BitPackedColumn.from_values(
        "x", rng.integers(0, 8, N_ROWS), 4))
    return t


@pytest.fixture(scope="module")
def table(ref_table):
    return tdb.table_from_arrays(
        {n: (np.asarray(c.words), c.code_bits, c.num_rows, c.dictionary)
         for n, c in ref_table.columns.items()}, name="t", device="cpu")


@pytest.fixture(scope="module")
def ref_encoded(ref_table):
    return JTable.from_table(ref_table, chunk_rows=CHUNK_ROWS)


@pytest.fixture(scope="module")
def encoded(table):
    return EncodedTable.from_table(table, chunk_rows=CHUNK_ROWS)


def export(ref_encoded):
    """A reference EncodedTable's state, as encoded_table_from_arrays
    takes it."""
    def plane(x):
        return None if x is None else np.asarray(x)
    return {n: {"code_bits": c.code_bits, "num_rows": c.num_rows,
                "dictionary": c.dictionary,
                "chunks": [{"encoding": ch.encoding.value,
                            "n_rows": ch.n_rows, "code_bits": ch.code_bits,
                            "width": ch.width, "base": ch.base,
                            "words": plane(ch.words),
                            "values": plane(ch.values),
                            "lengths": plane(ch.lengths),
                            "valid": plane(ch.valid),
                            "checksum": ch.checksum} for ch in c.chunks]}
            for n, c in ref_encoded.columns.items()}


def np_plane(t):
    return None if t is None else t.numpy().view(np.uint32)


def assert_chunk_equal(got, want):
    assert got.encoding.value == want.encoding.value
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    for f in ("n_rows", "code_bits", "width", "base", "n_runs", "checksum",
              "nbytes", "logical_nbytes"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("words", "values", "lengths", "valid"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(np_plane(g),
                                          np.asarray(w).view(np.uint32))
    assert got.verify() and got.checksum == got.payload_checksum()
    np.testing.assert_array_equal(got.decode(), want.decode())


def assert_tables_equal(got, want):
    assert got.chunk_rows == want.chunk_rows
    assert list(got.columns) == list(want.columns)
    for name, wcol in want.columns.items():
        gcol = got.columns[name]
        assert (gcol.code_bits, gcol.num_rows, gcol.chunk_rows) == \
            (wcol.code_bits, wcol.num_rows, wcol.chunk_rows)
        assert len(gcol.chunks) == len(wcol.chunks)
        for g, w in zip(gcol.chunks, wcol.chunks):
            assert_chunk_equal(g, w)
        assert gcol.nbytes == wcol.nbytes
        assert gcol.logical_nbytes == wcol.logical_nbytes
        assert gcol.ratio == wcol.ratio
        assert gcol.encodings() == wcol.encodings()
        assert gcol.chunk_physical_bytes(2 * got.chunk_rows) == \
            wcol.chunk_physical_bytes(2 * want.chunk_rows)
    assert (got.num_rows, got.n_chunks, got.nbytes, got.logical_nbytes) == \
        (want.num_rows, want.n_chunks, want.nbytes, want.logical_nbytes)
    assert got.ratio == want.ratio
    assert got.stats() == want.stats()


# --------------------------------------------------------------------------
# encodings
# --------------------------------------------------------------------------
class TestEncode:
    def test_table_encodes_bit_for_bit(self, encoded, ref_encoded):
        assert_tables_equal(encoded, ref_encoded)
        assert encoded.device == torch.device("cpu")
        enc = encoded.stats()["encodings"]
        assert enc["r"]["rle"] == enc["f"]["for"] == enc["w"]["for"] == \
            enc["u"]["plain"] == encoded.n_chunks

    def test_decode_table_matches(self, encoded, ref_table):
        t = encoded.decode_table()
        for name, col in ref_table.columns.items():
            np.testing.assert_array_equal(
                t.columns[name].words.numpy().view(np.uint32),
                np.asarray(col.words))

    @pytest.mark.parametrize("pin", list(JEncoding),
                             ids=lambda e: e.value)
    def test_pinned_encodings(self, table, ref_table, pin):
        pins = {"u": pin, "r": pin}
        got = EncodedTable.from_table(
            table, chunk_rows=700,
            encodings={k: Encoding(v.value) for k, v in pins.items()})
        want = JTable.from_table(ref_table, chunk_rows=700, encodings=pins)
        assert_tables_equal(got, want)

    @pytest.mark.parametrize("chunk_rows", (1, 7, 4096, 70000))
    def test_chunk_alignment_matches(self, table, ref_table, chunk_rows):
        small = tdb.Table("s")
        jsmall = rdb.Table("s")
        for name in ("u", "x"):
            col, jcol = table.columns[name], ref_table.columns[name]
            small.add(tdb.BitPackedColumn.from_values(
                name, col.decode()[:300], col.code_bits, device="cpu"))
            jsmall.add(rdb.BitPackedColumn.from_values(
                name, jcol.decode()[:300], jcol.code_bits))
        if chunk_rows > 65536:
            for fn, t in ((EncodedTable.from_table, small),
                          (JTable.from_table, jsmall)):
                with pytest.raises(ValueError, match="MAX_CHUNK_ROWS"):
                    fn(t, chunk_rows=chunk_rows)
            return
        assert_tables_equal(EncodedTable.from_table(small, chunk_rows),
                            JTable.from_table(jsmall, chunk_rows))

    @pytest.mark.parametrize("bits", (2, 4, 8, 16))
    def test_tiny_chunks_tie_to_plain(self, bits):
        """A chunk of one repeated value ties RLE and PLAIN at 4 bytes for
        small n; PLAIN wins the tie, as in the reference (ROADMAP queue 3)."""
        vmax = (1 << (bits - 1)) - 1
        for n in range(1, 12):
            codes = np.full(n, vmax, np.uint32)
            got = encode_chunk(codes, bits, device="cpu")
            want = j_encode_chunk(codes, bits)
            assert_chunk_equal(got, want)
            assert choose_encoding(got.stats).value == \
                want.encoding.value
        assert encode_chunk(np.full(3, 1, np.uint32), 16,
                            device="cpu").encoding is Encoding.PLAIN

    @pytest.mark.parametrize("enc", [None, *JEncoding],
                             ids=lambda e: "auto" if e is None else e.value)
    def test_encode_chunk_every_encoding(self, enc):
        rng = np.random.default_rng(7)
        for codes, bits in (
                (np.asarray([5, 5, 5, 9, 9, 0, 1, 2, 3], np.uint32), 8),
                (1000 + np.arange(8, dtype=np.uint32), 16),
                (np.sort(rng.integers(0, 4, 3000)).astype(np.uint32), 4),
                (rng.integers(0, 2, 777).astype(np.uint32), 2),
                (np.zeros(0, np.uint32), 8)):
            tenc = None if enc is None else Encoding(enc.value)
            got = encode_chunk(codes, bits, tenc, device="cpu")
            want = j_encode_chunk(codes, bits, enc)
            assert_chunk_equal(got, want)
            if len(codes) == 0:
                assert got.nbytes == 0 and got.decode().size == 0

    def test_stats_match_reference(self):
        rng = np.random.default_rng(2)
        from repro.store import EncodingStats as JStats
        for codes, bits in ((rng.integers(0, 128, 999), 8),
                            (np.zeros(0, np.uint32), 4),
                            (np.sort(rng.integers(300, 310, 64)), 16)):
            codes = np.asarray(codes, np.uint32)
            got = EncodingStats.from_codes(codes, bits)
            want = JStats.from_codes(codes, bits)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            for e in Encoding:
                assert got.nbytes(e) == want.nbytes(JEncoding(e.value))

    def test_validation_messages_match_reference(self, table, ref_table):
        for args in ((np.zeros(70000, np.uint32), 8),
                     (np.asarray([300], np.uint32), 8)):
            with pytest.raises(ValueError) as jerr:
                j_encode_chunk(*args)
            with pytest.raises(ValueError) as terr:
                encode_chunk(*args, device="cpu")
            assert str(terr.value) == str(jerr.value)
        with pytest.raises(ValueError, match="unknown column"):
            EncodedTable.from_table(table, encodings={"nope": Encoding.RLE})
        from repro_torch.store import EncodedColumn
        with pytest.raises(ValueError, match="chunk_rows=0"):
            EncodedColumn.from_values("c", [1, 2], 8, chunk_rows=0,
                                      device="cpu")
        with pytest.raises(ValueError, match="payload max"):
            EncodedColumn.from_values("c", [1, 200], 8, device="cpu")

    def test_checksum_detects_a_flipped_bit(self, table):
        et = EncodedTable.from_table(table, chunk_rows=CHUNK_ROWS)
        ch = et.columns["u"].chunks[2]
        assert ch.verify()
        ch.words[5] ^= 1 << 3
        assert not ch.verify()


# --------------------------------------------------------------------------
# the state-carrying function
# --------------------------------------------------------------------------
class TestFromArrays:
    def test_reference_state_round_trips(self, ref_encoded):
        got = encoded_table_from_arrays(export(ref_encoded), CHUNK_ROWS,
                                        name="t", device="cpu")
        assert_tables_equal(got, ref_encoded)
        assert execute_encoded(tq.Pred("f", "ge", 43), ("r", "w"), got) == \
            j_execute(rq.Pred("f", "ge", 43), ("r", "w"), ref_encoded,
                      mode="xla_ref")

    def test_checksum_checked_on_the_way_in(self, ref_encoded):
        state = export(ref_encoded)
        words = state["u"]["chunks"][1]["words"].copy()
        words[3] ^= np.uint32(1)
        state["u"]["chunks"][1]["words"] = words
        with pytest.raises(ValueError, match="'u' chunk 1: crc32"):
            encoded_table_from_arrays(state, CHUNK_ROWS, device="cpu")
        state = export(ref_encoded)
        state["r"]["num_rows"] += 1
        with pytest.raises(ValueError, match="rows"):
            encoded_table_from_arrays(state, CHUNK_ROWS, device="cpu")


# --------------------------------------------------------------------------
# the sixteen plan shapes of tests/test_store.py
# --------------------------------------------------------------------------
PLAN_SHAPES = [
    ("rle_fused_self_agg", lambda q: q.Pred("r", "lt", 4), ("r",)),
    ("rle_fused_eq", lambda q: q.Pred("r", "eq", 3), ("r",)),
    ("rle_fused_ne", lambda q: q.Pred("r", "ne", 3), ("r",)),
    ("rle_pred_other_agg", lambda q: q.Pred("r", "ge", 6), ("f",)),
    ("for_fused_same_width", lambda q: q.Pred("f", "ge", 44), ("f",)),
    ("for_cross_column", lambda q: q.Pred("f", "lt", 44), ("w",)),
    ("for16_pred", lambda q: q.Pred("w", "ge", 9050), ("u",)),
    ("plain_pred_for_agg", lambda q: q.Pred("u", "lt", 64), ("w",)),
    ("and_mixed_encodings",
     lambda q: q.Pred("f", "ge", 42) & q.Pred("w", "lt", 9080), ("w", "x")),
    ("or_mixed_widths",
     lambda q: q.Pred("x", "eq", 3) | q.Pred("w", "lt", 9010), ("u",)),
    ("nested_and_or",
     lambda q: q.And.of(q.Or.of(q.Pred("r", "le", 2),
                                q.Pred("u", "gt", 120)),
                        q.Pred("x", "ne", 0)), ("f",)),
    ("multi_agg_all_encodings", lambda q: q.Pred("f", "ge", 43),
     ("r", "f", "w", "u", "x")),
    ("empty_selection_rle", lambda q: q.Pred("r", "gt", 7), ("r",)),
    ("empty_selection_for", lambda q: q.Pred("f", "lt", 40), ("w",)),
    ("all_match_for", lambda q: q.Pred("w", "ge", 0), ("w",)),
    ("below_frame_constant", lambda q: q.Pred("w", "lt", 5), ("w",)),
]
IDS = [p[0] for p in PLAN_SHAPES]

_COUNTER_PREFIXES = ("launches/", "batch/", "batch_chunks/")


def dispatch_record(registry) -> dict:
    """Launch counts and batched-group records of a metrics scope."""
    return {k: c.value for k, c in registry.counters.items()
            if k.startswith(_COUNTER_PREFIXES) and c.value}


@pytest.mark.parametrize("batched", (True, False), ids=("batched", "loop"))
@pytest.mark.parametrize("name,mkplan,aggs", PLAN_SHAPES, ids=IDS)
def test_execute_encoded_matches_reference(encoded, ref_encoded, ref_table,
                                           name, mkplan, aggs, batched):
    jreg = jmetrics.MetricsRegistry("j")
    with jmetrics.scoped(jreg):
        want = j_execute(mkplan(rq), aggs, ref_encoded, mode="xla_ref",
                         batched=batched)
    plain = rq.QueryEngine(ref_table, mode="xla_ref")
    plain.submit(rq.Query(mkplan(rq), aggregates=aggs))
    assert plain.run()[0].aggregates == want
    for mode in ("auto", "torch_ref"):
        treg = tmetrics.MetricsRegistry("t")
        with tmetrics.scoped(treg):
            got = execute_encoded(mkplan(tq), aggs, encoded, mode=mode,
                                  batched=batched)
        assert got == want, mode
        assert all(type(v) is int for d in got.values() for v in d.values())
        assert dispatch_record(treg) == dispatch_record(jreg), mode


@pytest.mark.parametrize("name,mkplan,aggs", PLAN_SHAPES, ids=IDS)
def test_engine_matches_reference(encoded, ref_encoded, table, name, mkplan,
                                  aggs):
    """Through QueryEngine: the reference's Pallas (interpret) and jnp
    modes against the port's auto and torch_ref on CPU tensors, plus the
    port's plain-table engine."""
    jres = {}
    for mode in ("pallas", "xla_ref"):
        jeng = rq.QueryEngine(ref_encoded, mode=mode)
        jeng.submit(rq.Query(mkplan(rq), aggregates=aggs))
        jres[mode] = (jeng.run()[0], dispatch_record(jeng.metrics))
    assert jres["pallas"][0].aggregates == jres["xla_ref"][0].aggregates
    want, want_rec = jres["xla_ref"]
    flat = tq.QueryEngine(table, device="cpu")
    flat.submit(tq.Query(mkplan(tq), aggregates=aggs))
    assert flat.run()[0].aggregates == want.aggregates
    for mode in ("auto", "torch_ref"):
        eng = tq.QueryEngine(encoded, mode=mode, device="cpu")
        eng.submit(tq.Query(mkplan(tq), aggregates=aggs))
        res = eng.run()[0]
        assert res.aggregates == want.aggregates, mode
        assert (res.count, res.selectivity, res.bytes_scanned,
                res.logical_bytes) == (want.count, want.selectivity,
                                       want.bytes_scanned,
                                       want.logical_bytes)
        assert dispatch_record(eng.metrics) == want_rec
        assert dispatch_record(eng.metrics) == jres["pallas"][1]
        assert res.met and not res.degraded and res.tier is None


def test_bind_cache_reused_and_keyed_by_chunk_identity(table):
    et = EncodedTable.from_table(table, chunk_rows=CHUNK_ROWS)
    plan, aggs = tq.Pred("f", "lt", 44), ("w",)
    want = execute_encoded(plan, aggs, et)
    col = et.columns["w"]
    (key, bg), = ((k, v) for k, v in col._cache.items() if k[0] == "bind")
    assert execute_encoded(plan, aggs, et) == want
    assert col._cache[key] is bg                  # reused
    with pytest.raises(TypeError):
        col.chunks[0] = col.chunks[0]             # chunks are a tuple
    col.replace_chunk(0, dataclasses.replace(col.chunks[0]))
    assert execute_encoded(plan, aggs, et) == want
    assert col._cache[key] is not bg              # rebound


def test_chunk_arrays_follow_chunk_replacement(table):
    """The per-column metadata arrays (and nbytes / logical_nbytes, read
    from them) follow a replaced chunk; so do the cached run planes."""
    et = EncodedTable.from_table(table, chunk_rows=CHUNK_ROWS)
    col = et.columns["r"]
    a = col.chunk_arrays()
    assert a.nbytes.tolist() == [c.nbytes for c in col.chunks]
    assert a.width.tolist() == [8] * et.n_chunks and a.rle.all()
    want = execute_encoded(tq.Pred("r", "lt", 4), ("r",), et)
    every = ("runs", np.arange(et.n_chunks).tobytes())
    assert every in col._cache
    codes = col.chunks[1].decode()
    col.replace_chunk(1, encode_chunk(codes, 8, Encoding.PLAIN,
                                      device="cpu"))
    b = col.chunk_arrays()
    assert b is not a and not b.rle[1] and b.width[1] == 8
    assert col.nbytes == sum(c.nbytes for c in col.chunks) != int(
        a.nbytes.sum())
    assert col.logical_nbytes == int(a.logical_nbytes.sum())
    assert execute_encoded(tq.Pred("r", "lt", 4), ("r",), et) == want
    rest = ("runs", np.delete(np.arange(et.n_chunks), 1).tobytes())
    assert rest in col._cache and every not in col._cache


@pytest.mark.parametrize("batched", (True, False))
def test_translate_plan_memoized_on_frame_tuple(monkeypatch, batched):
    """Chunks sharing a (base, width) frame translate the plan once per
    execute call, as in the reference."""
    import repro_torch.store.exec as X

    rng = np.random.default_rng(0)
    t = tdb.Table("m")
    for c in ("a", "b"):
        t.add(tdb.BitPackedColumn.from_values(c, rng.integers(0, 128, 4096),
                                              8, device="cpu"))
    enc = EncodedTable.from_table(
        t, chunk_rows=512, encodings={"a": Encoding.PLAIN,
                                      "b": Encoding.PLAIN})
    assert enc.n_chunks == 8
    calls = []
    real = X.translate_plan
    monkeypatch.setattr(X, "translate_plan",
                        lambda plan, frames: calls.append(1) or
                        real(plan, frames))
    got = execute_encoded(tq.Pred("a", "lt", 64), ("b",), enc,
                          batched=batched)
    assert len(calls) == 1
    assert got == execute_encoded(tq.Pred("a", "lt", 64), ("b",), enc,
                                  batched=batched)


def test_varied_frames_batch_into_one_launch():
    """FOR chunks with different bases share one fused launch; every
    chunk's translated constant rides in as data."""
    rng = np.random.default_rng(4)
    codes = np.concatenate([base + rng.integers(0, 6, 512)
                            for base in (10, 20, 10, 90, 0, 50, 51, 120)])
    codes[-5:] = 127
    t = tdb.Table("v")
    t.add(tdb.BitPackedColumn.from_values("a", codes, 8, device="cpu"))
    jt = rdb.Table("v")
    jt.add(rdb.BitPackedColumn.from_values("a", codes, 8))
    et = EncodedTable.from_table(t, chunk_rows=512)
    jet = JTable.from_table(jt, chunk_rows=512)
    assert_tables_equal(et, jet)
    for op in OPS:
        for c in (0, 10, 14, 50, 56, 127):
            dispatch.reset_launch_counts()
            got = execute_encoded(tq.Pred("a", op, c), ("a",), et)
            assert dispatch.launch_counts() == {"scan_aggregate": 1}
            assert got == j_execute(rq.Pred("a", op, c), ("a",), jet,
                                    mode="xla_ref"), (op, c)


# --------------------------------------------------------------------------
# identities, bytes, engine surface
# --------------------------------------------------------------------------
class TestIdentities:
    def test_helpers_match_reference(self):
        from repro.store.exec import fixup_base as jfix
        from repro.store.exec import identity_ints as jid
        for bits in (2, 4, 8, 16):
            assert identity_ints(bits) == jid(bits)
        for agg, base in (({"sum": 0, "count": 0, "min": 7, "max": 0}, 40),
                          ({"sum": 12, "count": 3, "min": 1, "max": 7}, 40),
                          ({"sum": 12, "count": 3, "min": 1, "max": 7}, 0)):
            assert fixup_base(agg, base, 8) == jfix(agg, base, 8)

    def test_zero_row_encoded_table(self):
        t = tdb.Table("empty")
        jt = rdb.Table("empty")
        for c in ("a", "b"):
            t.add(tdb.BitPackedColumn.from_values(c, np.zeros(0, np.uint32),
                                                  8, device="cpu"))
            jt.add(rdb.BitPackedColumn.from_values(c, np.zeros(0, np.uint32),
                                                   8))
        et, jet = EncodedTable.from_table(t), JTable.from_table(jt)
        assert et.n_chunks == jet.n_chunks == 0 and et.device is None
        for batched in (True, False):
            assert execute_encoded(tq.Pred("a", "lt", 5), ("b",), et,
                                   batched=batched) == \
                {"b": identity_ints(8)}
        eng = tq.QueryEngine(et, device="cpu")
        eng.submit(tq.Query(tq.Pred("a", "lt", 5), aggregates=("b",)))
        res = eng.run()[0]
        assert res.aggregates == {"b": identity_ints(8)} and res.count == 0

    def test_empty_selection_identical_across_paths(self, table, encoded):
        q = tq.Query(tq.Pred("f", "lt", 40), aggregates=("f", "w"))
        outs = []
        for tbl in (table, encoded):
            for mode in ("auto", "torch_ref"):
                eng = tq.QueryEngine(tbl, mode=mode, device="cpu")
                eng.submit(q)
                outs.append(eng.run()[0].aggregates)
        assert all(o == {"f": identity_ints(8), "w": identity_ints(16)}
                   for o in outs), outs


class TestTranslation:
    @pytest.mark.parametrize("op", OPS)
    def test_translate_pred_matches_reference_exhaustive(self, op):
        for base, width in ((40, 4), (0, 8), (9000, 8), (3, 2), (100, 16)):
            dvmax = (1 << (width - 1)) - 1
            deltas = np.arange(dvmax + 1)
            fn = {"lt": np.less, "le": np.less_equal, "gt": np.greater,
                  "ge": np.greater_equal, "eq": np.equal,
                  "ne": np.not_equal}
            consts = set(range(max(0, base - 3), base + 4)) | set(
                range(base + dvmax - 3, base + dvmax + 4)) | set(
                range(base, base + dvmax, max(1, dvmax // 64)))
            for c in sorted(consts):
                got = translate_pred(op, c, base, width)
                assert got == j_translate_pred(op, c, base, width)
                np.testing.assert_array_equal(
                    fn[got[0]](deltas, got[1]), fn[op](base + deltas, c))

    def test_unknown_op_raises(self):
        with pytest.raises(ValueError, match="unknown predicate op"):
            translate_pred("like", 3, 0, 8)


class TestEngine:
    def test_bytes_physical_and_logical(self, encoded, ref_encoded):
        eng = tq.QueryEngine(encoded, device="cpu")
        eng.submit(tq.Query(tq.Pred("f", "ge", 44), aggregates=("w",)))
        res = eng.run()[0]
        jeng = rq.QueryEngine(ref_encoded, mode="xla_ref")
        jeng.submit(rq.Query(rq.Pred("f", "ge", 44), aggregates=("w",)))
        jres = jeng.run()[0]
        assert 0 < res.bytes_scanned == jres.bytes_scanned \
            < res.logical_bytes == jres.logical_bytes
        s = eng.summary()
        assert s["logical_bytes"] > s["bytes_scanned"]
        assert s["effective_gbps"] > s["measured_gbps"] > 0
        eng = tq.QueryEngine(encoded, device="cpu")
        eng.submit(tq.Query(tq.Pred("r", "lt", 4), aggregates=("r",)))
        res = eng.run()[0]
        assert res.bytes_scanned < 0.05 * res.logical_bytes

    def test_later_slice_paths_raise(self, encoded, ref_encoded):
        """guard= (verify-on-read) is ported: over an uncorrupted store
        every chunk verifies and the answer is the unguarded one, as in
        the reference."""
        from repro.resilience import ChunkGuard as JChunkGuard
        from repro_torch.resilience import ChunkGuard
        guard, jguard = ChunkGuard(encoded), JChunkGuard(ref_encoded)
        got = execute_encoded(tq.Pred("u", "lt", 3), ("u",), encoded,
                              guard=guard)
        assert got == execute_encoded(tq.Pred("u", "lt", 3), ("u",),
                                      encoded) == j_execute(
            rq.Pred("u", "lt", 3), ("u",), ref_encoded, mode="xla_ref",
            guard=jguard)
        assert guard.summary() == jguard.summary()
        assert guard.summary()["quarantined"] == 0

    def test_engine_checks_the_store_device(self, encoded):
        with pytest.raises(ValueError, match="mode='cuda'"):
            tq.QueryEngine(encoded, mode="cuda", device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tq.QueryEngine(encoded)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                encode_chunk([1, 2], 8)
        with pytest.raises(ValueError, match="lies on the CPU"):
            execute_encoded(tq.Pred("u", "lt", 3), ("u",), encoded,
                            mode="cuda")

    def test_unified_launch_counts_default_scope(self, encoded,
                                                 ref_encoded):
        dispatch.reset_launch_counts()
        jdispatch.reset_launch_counts()
        execute_encoded(tq.Pred("r", "lt", 3), ("r",), encoded,
                        batched=False)
        j_execute(rq.Pred("r", "lt", 3), ("r",), ref_encoded,
                  mode="xla_ref", batched=False)
        assert dispatch.launch_counts() == jdispatch.launch_counts() == \
            {"scan_compressed": encoded.n_chunks}
