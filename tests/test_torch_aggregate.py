"""Parity of the port's masked aggregate with the reference on the CPU.

The same seeded numpy words and masks go through
repro.kernels.aggregate.ops.aggregate (jnp oracle and Pallas interpret
mode) and repro_torch.kernels.aggregate.ops.aggregate on CPU tensors (the
plain PyTorch version). Integer results: equal field for field.
"""
import numpy as np
import pytest
import torch

from repro.kernels.aggregate import ops as jops
from repro.kernels.aggregate import ref as jref
from repro.kernels.scan_filter import ref as jscan
from repro_torch.kernels.aggregate import kernel as tkernel
from repro_torch.kernels.aggregate import ops as tops
from repro_torch.kernels.aggregate import ref as tref
from repro_torch.kernels.scan_filter.ref import to_torch

BITS = (2, 4, 8, 16)
N_WORDS = (1, 127, 1000, 4093)       # ragged against the 128-word tile


def ints(d):
    return {k: int(v) for k, v in d.items()}


def make(rng, bits, n_words, kind):
    vmax = (1 << (bits - 1)) - 1
    cpw = 32 // bits
    words = jscan.pack(rng.integers(0, vmax + 1, n_words * cpw), bits)
    if kind == "random":
        sel = rng.random(n_words * cpw) < 0.3
    else:
        sel = np.full(n_words * cpw, kind == "all")
    return words, jscan.pack_mask(sel, bits)


@pytest.mark.parametrize("kind", ("random", "all", "none"))
@pytest.mark.parametrize("bits", BITS)
def test_aggregate_matches_reference(bits, kind):
    rng = np.random.default_rng(bits)
    for n in N_WORDS:
        words, mask = make(rng, bits, n, kind)
        want = ints(jops.aggregate(words, mask, bits, mode="xla_ref"))
        assert ints(jops.aggregate(words, mask, bits, mode="pallas")) == want
        wt, mt = to_torch(words, "cpu"), to_torch(mask, "cpu")
        for mode in ("auto", "torch_ref"):
            got = tops.aggregate(wt, mt, bits, mode=mode)
            assert all(v.dtype == torch.int32 and v.dim() == 0
                       for v in got.values())
            assert ints(got) == want, (n, mode)
            assert tops.finalize(got) == jops.finalize(want)


@pytest.mark.parametrize("bits", BITS)
def test_empty_input_is_the_identity(bits):
    empty = torch.zeros(0, dtype=torch.int32)
    want = ints(jref.identity(bits))
    assert ints(tops.aggregate(empty, empty, bits)) == want
    assert ints(tops.identity(bits, "cpu")) == want
    assert tops.finalize(tops.identity(bits, "cpu")) == \
        jops.finalize(jref.identity(bits))


def test_sixteen_bit_sum_past_int32():
    """A 16-bit column, all rows selected, sums past 2^31: the planes
    carry it exactly, as in the reference."""
    rng = np.random.default_rng(5)
    codes = rng.integers(30000, 32768, 80_000)
    words = jscan.pack(codes, 16)
    mask = jscan.pack_mask(np.ones(len(codes), bool), 16)
    want = int(codes.astype(np.int64).sum())
    assert want > 2**31
    got = tops.aggregate(to_torch(words, "cpu"), to_torch(mask, "cpu"), 16)
    assert ints(got) == ints(jops.aggregate(words, mask, 16,
                                            mode="xla_ref"))
    assert tops.finalize(got)["sum"] == want


def test_plain_version_exact_where_reference_split_sum_is_not():
    """The plain version sums in int64: exact for any column, including a
    sum far past 2^31 (sum_hi stays int32 up to 2^47)."""
    vals = torch.full((3_000_000,), 32767, dtype=torch.int32)
    lo, hi = tops.split_sum(vals)
    assert (int(hi) << 16) + int(lo) == 3_000_000 * 32767
    assert 0 <= int(lo) < 1 << 16


@pytest.mark.parametrize("bits", BITS)
def test_slices_combine_exactly(bits, monkeypatch):
    rng = np.random.default_rng(11)
    words, mask = make(rng, bits, 301, "random")
    wt, mt = to_torch(words, "cpu"), to_torch(mask, "cpu")
    whole = ints(tref.aggregate_ref(wt, mt, bits))
    from repro_torch.kernels.scan_filter import ref as scan_ref
    monkeypatch.setattr(scan_ref, "SLICE_WORDS", 64)
    import repro_torch.kernels.aggregate.ref as agg_ref_mod
    monkeypatch.setattr(agg_ref_mod, "SLICE_WORDS", 64)
    assert ints(tref.aggregate_ref(wt, mt, bits)) == whole


@pytest.mark.parametrize("bits", BITS)
def test_sum_bound_block_rows_matches_reference(bits):
    assert tops.sum_bound_block_rows(bits) == \
        jops.sum_bound_block_rows(bits)


def test_finalize_reassembles_planes():
    d = tref.as_dict(torch.tensor([5, 70000, 9, 1, 7], dtype=torch.int32))
    assert list(d) == list(tref.FIELDS)
    assert tops.finalize(d) == jops.finalize(ints(d)) == {
        "sum": 70000 * 65536 + 5, "count": 9, "min": 1, "max": 7}


def test_kernel_wrapper_rejects_bad_operands():
    w = torch.zeros(8, dtype=torch.int32)
    before = tkernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.aggregate_packed(w, w, code_bits=8)
    with pytest.raises(ValueError, match="code_bits"):
        tkernel.aggregate_packed(w, w, code_bits=3)
    assert tkernel.LAUNCHES == before


def test_cuda_mode_on_cpu_tensor_raises():
    w = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="lies on the CPU"):
        tops.aggregate(w, w, 8, mode="cuda")


# --- batched (one launch over every chunk of a column group) ---------------

def ragged_planes(rng, bits, n_chunks, n_words):
    """(n_chunks, n_words) packed codes + masks; chunk k holds its own row
    count (0 included), the rest zero words with zero mask bits."""
    vmax = (1 << (bits - 1)) - 1
    cpw = 32 // bits
    words = np.zeros((n_chunks, n_words), np.uint32)
    mask = np.zeros((n_chunks, n_words), np.uint32)
    for k in range(n_chunks):
        rows = int(rng.integers(0, n_words * cpw + 1)) if k else 0
        words[k, :-(-rows // cpw)] = jscan.pack(
            rng.integers(0, vmax + 1, rows), bits)
        mask[k] = jscan.pack_mask(
            (np.arange(n_words * cpw) < rows)
            & (rng.random(n_words * cpw) < 0.6), bits)
    return words, mask


@pytest.mark.parametrize("bits", BITS)
def test_aggregate_batched_matches_reference(bits):
    rng = np.random.default_rng(40 + bits)
    for n_chunks, n_words in ((1, 1), (7, 131), (3, 4096)):
        words, mask = ragged_planes(rng, bits, n_chunks, n_words)
        want = np.asarray(jops.aggregate_batched(words, mask, bits,
                                                 mode="xla_ref"))
        np.testing.assert_array_equal(
            np.asarray(jops.aggregate_batched(words, mask, bits,
                                              mode="pallas")), want)
        wt, mt = to_torch(words, "cpu"), to_torch(mask, "cpu")
        for mode in ("auto", "torch_ref"):
            got = tops.aggregate_batched(wt, mt, bits, mode=mode)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
        for k in range(n_chunks):
            assert ints(tops.aggregate(wt[k], mt[k], bits)) == \
                dict(zip(tref.FIELDS, want[k].tolist()))


@pytest.mark.parametrize("shape", ((0, 5), (3, 0), (0, 0)))
def test_aggregate_batched_empty_is_identity(shape):
    w = np.zeros(shape, np.uint32)
    want = np.asarray(jops.aggregate_batched(w, w, 8, mode="pallas"))
    got = tops.aggregate_batched(to_torch(w, "cpu"), to_torch(w, "cpu"), 8)
    assert got.shape == (shape[0], 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_aggregate_batched_sum_at_the_chunk_bound():
    """A full 16-bit chunk (65536 rows, 32768 words) of the payload max,
    every row selected: 2147418112, just below 2^31."""
    words = np.tile(jscan.pack(np.full(65536, 32767), 16), (2, 1))
    mask = np.tile(jscan.pack_mask(np.ones(65536, bool), 16), (2, 1))
    want = np.asarray(jops.aggregate_batched(words, mask, 16,
                                             mode="xla_ref"))
    got = tops.aggregate_batched(to_torch(words, "cpu"),
                                 to_torch(mask, "cpu"), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tops.finalize(tref.as_dict(got[0]))["sum"] == 32767 * 65536


def test_to3d_words_matches_reference():
    rng = np.random.default_rng(8)
    words = rng.integers(0, 2**32, (3, 300), dtype=np.uint32)
    np.testing.assert_array_equal(
        tops.to3d_words(to_torch(words, "cpu")).numpy().view(np.uint32),
        np.asarray(jops.to3d_words(words)))


def test_batched_kernel_wrapper_rejects_bad_operands():
    w = torch.zeros((2, 8), dtype=torch.int32)
    before = tkernel.BATCHED_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.aggregate_batched_packed(w, w, code_bits=8)
    with pytest.raises(ValueError, match="code_bits"):
        tkernel.aggregate_batched_packed(w, w, code_bits=5)
    with pytest.raises(ValueError, match="lies on the CPU"):
        tops.aggregate_batched(w, w, 8, mode="cuda")
    assert tkernel.BATCHED_LAUNCHES == before
