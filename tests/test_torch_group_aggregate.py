"""Parity of the port's grouped aggregates (group_aggregate) with the
reference on the CPU.

The same seeded numpy key/value/select planes and run planes go through
repro.kernels.group_aggregate.ops (the jnp oracle, and the Pallas kernels
in interpret mode) and repro_torch.kernels.group_aggregate.ops on CPU
tensors (the plain PyTorch versions, under auto and torch_ref), then
through both packages' finalize_grouped. Integer results: equal field for
field, no tolerance.
"""
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels.group_aggregate import ops as jops
from repro_torch.kernels import dispatch
from repro_torch.kernels.group_aggregate import kernel as tkernel
from repro_torch.kernels.group_aggregate import ops as tops
from repro_torch.kernels.group_aggregate import ref as tref

MODES = ("auto", "torch_ref")
JOIN_KEYS = np.array([1, 3, 5, 40, 99, 127])       # not contiguous


def planes(rng, n_chunks, rows, kmax, vmax, ragged=True):
    """Ragged per-chunk key/value/select arrays (chunk k loses k * 37
    rows), keys drawn past the domain so that some count nowhere."""
    out = []
    for k in range(n_chunks):
        n = max(rows - (k * 37 if ragged else 0), 0)
        out.append((rng.integers(0, kmax + 1, n),
                    rng.integers(0, vmax + 1, n),
                    rng.integers(0, 2, n)))
    return out


def lifted(chunks):
    """The three planes lifted by each package: (reference jnp, port
    torch)."""
    j = [jops.lift_chunks([c[i] for c in chunks]) for i in range(3)]
    t = [tops.lift_chunks([torch.from_numpy(c[i]) for c in chunks])
         for i in range(3)]
    return j, t


def assert_planes(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("domain", ("arange", "join"))
@pytest.mark.parametrize("n_chunks,rows", ((1, 1), (1, 1000), (3, 300),
                                           (7, 129)))
def test_dense_matches_reference(n_chunks, rows, domain):
    rng = np.random.default_rng(n_chunks * 1000 + rows)
    gk = np.arange(0, 12) if domain == "arange" else JOIN_KEYS
    chunks = planes(rng, n_chunks, rows, kmax=int(gk.max()) + 9,
                    vmax=(1 << 15) - 1)
    (jk, jv, js), (tk, tv, ts) = lifted(chunks)
    want = np.asarray(jops.group_sum_count_batched(jk, jv, js, gk,
                                                   mode="xla_ref"))
    np.testing.assert_array_equal(
        np.asarray(jops.group_sum_count_batched(jk, jv, js, gk,
                                                mode="pallas")), want)
    for mode in MODES:
        got = tops.group_sum_count_batched(tk, tv, ts, torch.from_numpy(gk),
                                           mode=mode)
        assert_planes(got, want)
        for k in range(n_chunks):
            jf = jops.finalize_grouped(gk, want[k], base=7)
            tf = tops.finalize_grouped(torch.from_numpy(gk), got[k], base=7)
            for a, b in zip(tf, jf):
                np.testing.assert_array_equal(a, b)


def test_dense_single_chunk_and_big_sums():
    """group_sum_count (one chunk) and a full 65536-row chunk of 65535s,
    whose sum passes 2^31: exact in both packages."""
    rng = np.random.default_rng(5)
    k, v, s = (rng.integers(0, 9, 5000), rng.integers(0, 300, 5000),
               rng.integers(0, 2, 5000))
    gk = np.arange(2, 7)
    want = np.asarray(jops.group_sum_count(k, v, s, gk, mode="xla_ref"))
    for mode in MODES:
        assert_planes(tops.group_sum_count(
            torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(s),
            torch.from_numpy(gk), mode=mode), want)
    n = 65536
    k, v, s = np.zeros(n, np.int64), np.full(n, 65535), np.ones(n, np.int64)
    gk = np.arange(1)
    want = np.asarray(jops.group_sum_count(k, v, s, gk, mode="xla_ref"))
    got = tops.group_sum_count(torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(s), torch.from_numpy(gk))
    assert_planes(got, want)
    _, sums, counts = tops.finalize_grouped(gk, got)
    assert sums.tolist() == [65535 * n] and counts.tolist() == [n]


def runs(rng, n_chunks, n_runs, vmax=127):
    """Ragged run planes (chunk k keeps n_runs - k runs), zero lengths
    included."""
    return [(rng.integers(0, vmax + 1, max(n_runs - k, 0)).astype(np.int32),
             rng.integers(0, 5, max(n_runs - k, 0)).astype(np.int32))
            for k in range(n_chunks)]


PREDS = (None, ("ge", 0, False), ("ge", 60, False), ("ge", 60, True),
         ("eq", 7, False), ("eq", 7, True))


@pytest.mark.parametrize("pred", PREDS, ids=str)
@pytest.mark.parametrize("n_chunks,n_runs", ((1, 1), (1, 3), (4, 101),
                                             (3, 1001)))
def test_rle_matches_reference(n_chunks, n_runs, pred):
    rng = np.random.default_rng(n_chunks * 7 + n_runs)
    chunks = runs(rng, n_chunks, n_runs)
    tchunks = [(torch.from_numpy(v), torch.from_numpy(n)) for v, n in chunks]
    for gk in (np.arange(0, 128), np.arange(5, 20), JOIN_KEYS):
        want = np.asarray(jops.rle_group_accumulate_batched(
            chunks, gk, pred=pred, mode="xla_ref"))
        np.testing.assert_array_equal(np.asarray(
            jops.rle_group_accumulate_batched(chunks, gk, pred=pred,
                                              mode="pallas")), want)
        for mode in MODES:
            got = tops.rle_group_accumulate_batched(
                tchunks, torch.from_numpy(gk), pred=pred, mode=mode)
            assert_planes(got, want)
        if n_chunks == 1:
            v, n = tchunks[0]
            assert_planes(tops.rle_group_accumulate(
                v, n, torch.from_numpy(gk), pred=pred), want[0])


def test_rle_sum_wraps_as_the_reference():
    """One run of 65536 rows of 65535: the reference forms n * v in int32
    and gets the plane [0, -1, 65536] (a sum of -65536 once finalized);
    the port matches it on purpose (ROADMAP, queue 3)."""
    chunks = [(np.array([65535], np.int32), np.array([65536], np.int32))]
    gk = np.array([65535])
    for mode in ("xla_ref", "pallas"):
        want = np.asarray(jops.rle_group_accumulate_batched(chunks, gk,
                                                            mode=mode))
        assert want.tolist() == [[[0, -1, 65536]]]
    tch = [(torch.from_numpy(v), torch.from_numpy(n)) for v, n in chunks]
    for mode in MODES:
        got = tops.rle_group_accumulate_batched(tch, torch.from_numpy(gk),
                                                mode=mode)
        assert got.tolist() == [[[0, -1, 65536]]]
    _, sums, counts = tops.finalize_grouped(gk, got[0])
    assert sums.tolist() == [-65536] and counts.tolist() == [65536]


def test_lift_chunks_matches_reference():
    rng = np.random.default_rng(2)
    sizes = (0, 1, 127, 128, 129, 1000)
    chunks = [rng.integers(0, 100, n) for n in sizes]
    want = np.asarray(jops.lift_chunks(chunks))
    got = tops.lift_chunks([torch.from_numpy(c) for c in chunks])
    assert_planes(got, want)
    one = torch.arange(256, dtype=torch.int32)
    assert tops.lift_chunks([one]).data_ptr() == one.data_ptr()   # a view
    assert_planes(tops.lift_chunks([torch.zeros(0, dtype=torch.int32)]),
                  np.asarray(jops.lift_chunks([np.zeros(0, np.int64)])))


@pytest.mark.parametrize("shape", ((0, 5), (3, 0)))
def test_empty_inputs(shape):
    n_chunks, g = shape
    gk = torch.arange(g)
    p = tops.lift_chunks([torch.zeros(4, dtype=torch.int32)] * n_chunks) \
        if n_chunks else torch.zeros((0, 1, 128), dtype=torch.int32)
    got = tops.group_sum_count_batched(p, p, p, gk)
    want = np.asarray(jops.group_sum_count_batched(
        np.asarray(p), np.asarray(p), np.asarray(p), np.arange(g),
        mode="xla_ref"))
    assert got.shape == want.shape == (n_chunks, g, 3)
    assert not got.any()
    r = [(torch.zeros(2, dtype=torch.int32),) * 2] * n_chunks
    assert tops.rle_group_accumulate_batched(r, gk).shape == (n_chunks, g, 3)


def test_registered_example_matches_reference():
    op = dispatch.get("group_aggregate")
    jop = jdispatch.get("group_aggregate")
    args, kwargs = op.example(np.random.default_rng(0))
    jargs, jkwargs = jop.example(np.random.default_rng(0))
    want = np.asarray(jop.fn(*jargs, **jkwargs))
    assert_planes(op.fn(*args, **kwargs), want)
    assert_planes(op.ref(*args, **kwargs), want)
    assert dispatch._OP_MODULES == jdispatch._OP_MODULES


def test_dispatch_counts_one_per_call():
    gk = torch.arange(3)
    p = tops.lift_chunks([torch.zeros(5, dtype=torch.int32)])
    dispatch.reset_launch_counts()
    tops.group_sum_count_batched(p, p, p, gk)
    tops.rle_group_accumulate_batched([(p[0, 0], p[0, 0])] * 3, gk)
    assert dispatch.launch_counts() == {"group_aggregate": 1,
                                        "group_aggregate_rle": 1}


def test_cuda_paths_refuse_cpu_tensors():
    gk = torch.arange(3, dtype=torch.int32)
    p = tops.lift_chunks([torch.zeros(5, dtype=torch.int32)])
    with pytest.raises(ValueError, match="lies on the CPU"):
        tops.group_sum_count_batched(p, p, p, gk, mode="cuda")
    with pytest.raises(ValueError, match="lies on the CPU"):
        tops.rle_group_accumulate_batched([(gk, gk)], gk, mode="cuda")
    before = (tkernel.LAUNCHES, tkernel.RLE_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.group_sum_count_batched_planes(p, p, p, gk)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.rle_group_accumulate_batched_planes(gk[None], gk[None], gk)
    assert (tkernel.LAUNCHES, tkernel.RLE_LAUNCHES) == before


def test_plain_versions_slice_large_planes(monkeypatch):
    """The dense plain version walks its planes in slices; the answer
    does not depend on the slice size."""
    rng = np.random.default_rng(9)
    chunks = planes(rng, 5, 700, kmax=20, vmax=1000)
    _, (tk, tv, ts) = lifted(chunks)
    gk = torch.arange(3, 17)
    whole = tref.group_sum_count_batched_ref(tk, tv, ts, gk)
    for size in (128, 1000, 3 * 768):
        monkeypatch.setattr(tref, "SLICE_ELEMS", size)
        assert torch.equal(tref.group_sum_count_batched_ref(tk, tv, ts, gk),
                           whole)
