"""Parity of the port's RLE scan+aggregate (scan_compressed) with the
reference on the CPU.

The same seeded numpy run planes go through
repro.kernels.scan_compressed.ops (jnp oracle, and the Pallas kernels in
interpret mode) and repro_torch.kernels.scan_compressed.ops on CPU
tensors (the plain PyTorch version, under auto and torch_ref). Integer
results: equal field for field.
"""
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels.aggregate import ops as jagg
from repro.kernels.scan_compressed import ops as jops
from repro_torch.kernels import dispatch
from repro_torch.kernels.aggregate import ops as tagg
from repro_torch.kernels.scan_compressed import kernel as tkernel
from repro_torch.kernels.scan_compressed import ops as tops
from repro_torch.kernels.scan_compressed import ref as tref

OPS = ("lt", "le", "gt", "ge", "eq", "ne")
MODES = ("auto", "torch_ref")


def ints(d):
    return {k: int(v) for k, v in d.items()}


def runs(rng, n, bits, max_len=5):
    vmax = (1 << (bits - 1)) - 1
    return (rng.integers(0, vmax + 1, n).astype(np.int32),
            rng.integers(0, max_len, n).astype(np.int32))   # zero lengths


def rows_oracle(v, n, constant, op, bits):
    rows = np.repeat(v, n).astype(np.int64)
    sel = {"lt": rows < constant, "le": rows <= constant,
           "gt": rows > constant, "ge": rows >= constant,
           "eq": rows == constant, "ne": rows != constant}[op]
    vmax = (1 << (bits - 1)) - 1
    return {"sum": int(rows[sel].sum()), "count": int(sel.sum()),
            "min": int(rows[sel].min()) if sel.any() else vmax,
            "max": int(rows[sel].max()) if sel.any() else 0}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("bits", (2, 4, 8, 16))
def test_rle_scan_aggregate_matches_reference(bits, op):
    rng = np.random.default_rng(10 * bits + OPS.index(op))
    v, n = runs(rng, 301, bits)
    vmax = (1 << (bits - 1)) - 1
    for c in sorted({0, 1, vmax // 2, vmax}):
        want = ints(jops.rle_scan_aggregate(v, n, c, op, bits,
                                            mode="xla_ref"))
        for mode in MODES:
            got = tops.rle_scan_aggregate(torch.from_numpy(v),
                                          torch.from_numpy(n), c, op, bits,
                                          mode=mode)
            assert all(x.dtype == torch.int32 and x.dim() == 0
                       for x in got.values())
            assert ints(got) == want, (c, mode)
        assert tagg.finalize(got) == jagg.finalize(want) == \
            rows_oracle(v, n, c, op, bits)
    c = vmax // 2
    assert ints(tops.rle_scan_aggregate(v, n, c, op, bits)) == \
        ints(jops.rle_scan_aggregate(v, n, c, op, bits, mode="pallas"))


@pytest.mark.parametrize("op", OPS)
def test_batched_ragged_chunks_match_reference(op):
    """Ragged run counts (zero included), zero-length runs, one launch;
    each row equals the single-chunk op on that chunk."""
    rng = np.random.default_rng(OPS.index(op))
    planes = [runs(rng, k, 8) for k in (5, 0, 130, 1, 64, 3, 0)]
    want = np.asarray(jops.rle_scan_aggregate_batched(planes, 60, op, 8,
                                                      mode="xla_ref"))
    np.testing.assert_array_equal(
        np.asarray(jops.rle_scan_aggregate_batched(planes, 60, op, 8,
                                                   mode="pallas")), want)
    tplanes = [(torch.from_numpy(v), torch.from_numpy(n)) for v, n in planes]
    for mode in MODES:
        got = tops.rle_scan_aggregate_batched(tplanes, 60, op, 8, mode=mode)
        assert got.dtype == torch.int32 and got.shape == (len(planes), 5)
        np.testing.assert_array_equal(got.numpy(), want)
    for k, (v, n) in enumerate(planes):
        assert ints(tops.rle_scan_aggregate(v, n, 60, op, 8)) == \
            dict(zip(("sum_lo", "sum_hi", "count", "min", "max"),
                     want[k].tolist()))


def test_batched_equal_sizes_and_all_empty():
    rng = np.random.default_rng(1)
    planes = [runs(rng, 16, 4) for _ in range(9)]
    want = np.asarray(jops.rle_scan_aggregate_batched(planes, 3, "ge", 4,
                                                      mode="xla_ref"))
    got = tops.rle_scan_aggregate_batched(planes, 3, "ge", 4)
    np.testing.assert_array_equal(got.numpy(), want)
    v2, n2 = tops.stack_runs(planes)
    np.testing.assert_array_equal(
        tops.rle_scan_aggregate_stacked(v2, n2, 3, "ge", 4).numpy(), want)
    empty = [(np.zeros(0, np.int32), np.zeros(0, np.int32))] * 3
    np.testing.assert_array_equal(
        tops.rle_scan_aggregate_batched(empty, 3, "lt", 8).numpy(),
        np.asarray(jops.rle_scan_aggregate_batched(empty, 3, "lt", 8,
                                                   mode="pallas")))
    assert tops.rle_scan_aggregate_batched([], 3, "lt", 8).shape == (0, 5)


@pytest.mark.parametrize("bits", (2, 4, 8, 16))
def test_zero_runs_and_no_match_are_the_identity(bits):
    vmax = (1 << (bits - 1)) - 1
    ident = {"sum_lo": 0, "sum_hi": 0, "count": 0, "min": vmax, "max": 0}
    z = np.zeros(0, np.int32)
    for mode in MODES:
        assert ints(tops.rle_scan_aggregate(z, z, 1, "lt", bits,
                                            mode=mode)) == ident
        v = np.asarray([1, 0, 1], np.int32)
        n = np.asarray([4, 4, 0], np.int32)
        assert ints(tops.rle_scan_aggregate(v, n, vmax, "gt", bits,
                                            mode=mode)) == ident
    assert ints(jops.rle_scan_aggregate(z, z, 1, "lt", bits,
                                        mode="pallas")) == ident


def test_sum_at_the_chunk_bound():
    """A full chunk (65536 rows) of the 16-bit payload max: the sum,
    2147418112, grazes 2^31 and stays exact."""
    for v, n in ((np.full(1, 32767, np.int32), np.full(1, 65536, np.int32)),
                 (np.full(4096, 32767, np.int32),
                  np.full(4096, 16, np.int32))):
        want = jagg.finalize(jops.rle_scan_aggregate(v, n, 0, "ge", 16,
                                                     mode="xla_ref"))
        assert want["sum"] == 32767 * 65536 and want["count"] == 65536
        for mode in MODES:
            got = tagg.finalize(tops.rle_scan_aggregate(v, n, 0, "ge", 16,
                                                        mode=mode))
            assert got == want
        row = tops.rle_scan_aggregate_batched([(v, n), (v, n)], 0, "ge", 16)
        assert row[:, 1].tolist() == [(32767 * 65536) >> 16] * 2


def test_plain_version_sums_in_int64():
    v = torch.full((1, 3), 32767, dtype=torch.int32)
    n = torch.full((1, 3), 65536, dtype=torch.int32)
    row = tref.rle_scan_aggregate_batched_ref(v, n, 0, "ge", 16)[0]
    assert (int(row[1]) << 16) + int(row[0]) == 3 * 32767 * 65536


def test_launch_counts_match_reference():
    rng = np.random.default_rng(0)
    v, n = runs(rng, 40, 8)
    dispatch.reset_launch_counts()
    jdispatch.reset_launch_counts()
    tops.rle_scan_aggregate(v, n, 5, "lt", 8)
    jops.rle_scan_aggregate(v, n, 5, "lt", 8, mode="xla_ref")
    tops.rle_scan_aggregate_batched([(v, n)] * 3, 5, "lt", 8)
    jops.rle_scan_aggregate_batched([(v, n)] * 3, 5, "lt", 8,
                                    mode="xla_ref")
    assert dispatch.launch_counts() == jdispatch.launch_counts() == \
        {"scan_compressed": 2}


def test_bad_op_and_cpu_tensors_raise():
    one = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown predicate op"):
        tops.rle_scan_aggregate(one, one, 1, "like", 8)
    with pytest.raises(ValueError, match="unknown predicate op"):
        tops.rle_scan_aggregate_batched([(one, one)], 1, "like", 8)
    with pytest.raises(ValueError, match="lies on the CPU"):
        tops.rle_scan_aggregate(one, one, 1, "lt", 8, mode="cuda")
    before = (tkernel.LAUNCHES, tkernel.BATCHED_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.rle_scan_aggregate_packed(one, one, constant=1, op="lt",
                                          code_bits=8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.rle_scan_aggregate_batched_packed(
            one[None], one[None], constant=1, op="lt", code_bits=8)
    with pytest.raises(ValueError, match="unknown predicate op"):
        tkernel.rle_scan_aggregate_packed(one, one, constant=1, op="like",
                                          code_bits=8)
    assert (tkernel.LAUNCHES, tkernel.BATCHED_LAUNCHES) == before


def test_registered_in_the_reference_order():
    assert dispatch._OP_MODULES == jdispatch._OP_MODULES
    op = dispatch.get("scan_compressed")
    args, kwargs = op.example(np.random.default_rng(0))
    assert ints(op.fn(*args, **kwargs)) == ints(op.ref(*args, **kwargs))
