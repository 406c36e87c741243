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
