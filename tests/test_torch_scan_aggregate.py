"""Parity of the port's fused scan+aggregate with the reference on the CPU.

The same seeded numpy words go through
repro.kernels.scan_aggregate.ops.scan_aggregate (jnp oracle over the whole
grid; the Pallas kernel in interpret mode at one constant per op and
width, since each constant compiles anew) and the port's op on CPU tensors
(the plain PyTorch version). Integer results: equal field for field.
"""
import numpy as np
import pytest
import torch

from repro.kernels.aggregate import ref as jagg_ref
from repro.kernels.scan_aggregate import ops as jops
from repro.kernels.scan_filter import ref as jscan
from repro_torch.kernels import dispatch
from repro_torch.kernels.aggregate import ops as tagg
from repro_torch.kernels.scan_aggregate import kernel as tkernel
from repro_torch.kernels.scan_aggregate import ops as tops
from repro_torch.kernels.scan_aggregate import ref as tref
from repro_torch.kernels.scan_filter.ref import to_torch

BITS = (2, 4, 8, 16)
N_WORDS = 1000


def ints(d):
    return {k: int(v) for k, v in d.items()}


def edge_constants(bits):
    vmax = (1 << (bits - 1)) - 1
    return sorted({0, 1, vmax // 2, vmax - 1, vmax})


def make(rng, bits, n_rows):
    """pred/agg words of n_rows codes (tail-padded) + validity mask."""
    vmax = (1 << (bits - 1)) - 1
    pred = jscan.pack(rng.integers(0, vmax + 1, n_rows), bits)
    agg = jscan.pack(rng.integers(0, vmax + 1, n_rows), bits)
    valid = jscan.pack_mask(np.arange(pred.size * (32 // bits)) < n_rows,
                            bits)
    return pred, agg, valid


@pytest.mark.parametrize("op", jscan.OPS)
@pytest.mark.parametrize("bits", BITS)
def test_scan_aggregate_matches_reference(bits, op):
    rng = np.random.default_rng(100 * bits + jscan.OPS.index(op))
    n_rows = N_WORDS * (32 // bits) - 1          # a ragged last word
    pred, agg, valid = make(rng, bits, n_rows)
    pt, at, vt = (to_torch(x, "cpu") for x in (pred, agg, valid))
    for c in edge_constants(bits):
        want = ints(jops.scan_aggregate(pred, agg, valid, c, op, bits,
                                        mode="xla_ref"))
        for mode in ("auto", "torch_ref"):
            got = tops.scan_aggregate(pt, at, vt, c, op, bits, mode=mode)
            assert ints(got) == want, (c, mode)
    c = edge_constants(bits)[len(edge_constants(bits)) // 2]
    assert ints(tops.scan_aggregate(pt, at, vt, c, op, bits)) == \
        ints(jops.scan_aggregate(pred, agg, valid, c, op, bits,
                                 mode="pallas"))


@pytest.mark.parametrize("bits", BITS)
def test_empty_input_is_the_identity(bits):
    empty = torch.zeros(0, dtype=torch.int32)
    got = tops.scan_aggregate(empty, empty, empty, 0, "lt", bits)
    assert ints(got) == ints(jagg_ref.identity(bits))


@pytest.mark.parametrize("bits", BITS)
def test_vmax_short_circuits_match_reference(bits):
    """gt at vmax selects nothing; le at vmax selects every valid row —
    tail padding included in neither."""
    vmax = (1 << (bits - 1)) - 1
    rng = np.random.default_rng(bits)
    pred, agg, valid = make(rng, bits, 997)
    pt, at, vt = (to_torch(x, "cpu") for x in (pred, agg, valid))
    for op in ("gt", "le"):
        want = ints(jops.scan_aggregate(pred, agg, valid, vmax, op, bits,
                                        mode="pallas"))
        assert ints(tops.scan_aggregate(pt, at, vt, vmax, op, bits)) == want
    assert ints(tops.scan_aggregate(pt, at, vt, vmax, "gt", bits)) == \
        ints(jagg_ref.identity(bits))
    assert tagg.finalize(tops.scan_aggregate(pt, at, vt, vmax, "le",
                                             bits))["count"] == 997


def test_sixteen_bit_sum_past_int32():
    rng = np.random.default_rng(3)
    n = 100_001
    pred, _, valid = make(rng, 16, n)
    codes = rng.integers(25000, 32768, n)
    agg = jscan.pack(codes, 16)
    pt, at, vt = (to_torch(x, "cpu") for x in (pred, agg, valid))
    got = tops.scan_aggregate(pt, at, vt, 0, "ge", 16)
    assert ints(got) == ints(jops.scan_aggregate(pred, agg, valid, 0, "ge",
                                                 16, mode="xla_ref"))
    assert tagg.finalize(got)["sum"] == int(codes.sum()) > 2**31


def test_slices_combine_exactly(monkeypatch):
    rng = np.random.default_rng(9)
    pred, agg, valid = make(rng, 4, 2411)
    args = [to_torch(x, "cpu") for x in (pred, agg, valid)]
    whole = ints(tref.scan_aggregate_ref(*args, 3, "lt", 4))
    import repro_torch.kernels.aggregate.ref as agg_ref_mod
    import repro_torch.kernels.scan_aggregate.ref as fused_ref_mod
    monkeypatch.setattr(fused_ref_mod, "SLICE_WORDS", 64)
    monkeypatch.setattr(agg_ref_mod, "SLICE_WORDS", 64)
    assert ints(tref.scan_aggregate_ref(*args, 3, "lt", 4)) == whole


def test_launch_counts_match_reference_per_call():
    """One count per public-op call, as the reference's dispatch counts;
    le at vmax on the plain path counts one scan_aggregate, as the
    reference's xla_ref path does."""
    from repro.kernels import dispatch as jdispatch
    rng = np.random.default_rng(0)
    pred, agg, valid = make(rng, 8, 500)
    pt, at, vt = (to_torch(x, "cpu") for x in (pred, agg, valid))
    for c, op in ((5, "lt"), (127, "le"), (127, "gt")):
        dispatch.reset_launch_counts()
        jdispatch.reset_launch_counts()
        tops.scan_aggregate(pt, at, vt, c, op, 8)
        jops.scan_aggregate(pred, agg, valid, c, op, 8, mode="xla_ref")
        assert dispatch.launch_counts() == jdispatch.launch_counts()


def test_kernel_wrapper_and_modes_reject_cpu_tensors():
    w = torch.zeros(8, dtype=torch.int32)
    before = tkernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.scan_aggregate_packed(w, w, w, constant=1, op="ge",
                                      invert=False, code_bits=8)
    with pytest.raises(ValueError, match="lies on the CPU"):
        tops.scan_aggregate(w, w, w, 1, "ge", 8, mode="cuda")
    with pytest.raises(ValueError, match="unknown predicate op"):
        tops.scan_aggregate(w, w, w, 1, "like", 8)
    assert tkernel.LAUNCHES == before
