"""Parity of the port's scan_filter family with the reference on the CPU.

The same seeded numpy words go through repro.kernels.scan_filter (its jnp
oracle and its Pallas kernel in interpret mode) and through
repro_torch.kernels.scan_filter on CPU tensors, which take the plain
PyTorch version. Every path is integer, so results must agree bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.kernels.scan_filter import ops as jops
from repro.kernels.scan_filter import ref as jref
from repro_torch.kernels import dispatch
from repro_torch.kernels.scan_filter import kernel as tkernel
from repro_torch.kernels.scan_filter import ops as tops
from repro_torch.kernels.scan_filter import ref as tref

BITS = (2, 4, 8, 16)
N_WORDS = 1000          # not a multiple of the reference's 128 lanes


def edge_constants(bits):
    vmax = (1 << (bits - 1)) - 1
    return sorted({0, 1, vmax // 2, vmax - 1, vmax})


def random_words(rng, bits, n_words=N_WORDS):
    vmax = (1 << (bits - 1)) - 1
    return jref.pack(rng.integers(0, vmax + 1, n_words * (32 // bits)), bits)


def as_np(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("bits", BITS)
def test_numpy_packers_match_reference(bits):
    rng = np.random.default_rng(bits)
    vmax = (1 << (bits - 1)) - 1
    codes = rng.integers(0, vmax + 1, 1001)
    sel = rng.random(1001) < 0.4
    np.testing.assert_array_equal(tref.pack(codes, bits),
                                  jref.pack(codes, bits))
    np.testing.assert_array_equal(tref.pack_mask(sel, bits),
                                  jref.pack_mask(sel, bits))
    assert tref.field_masks(bits) == jref.field_masks(bits)
    assert tref.codes_per_word(bits) == jref.codes_per_word(bits)
    assert tref.OPS == jref.OPS


@pytest.mark.parametrize("bits", BITS)
def test_unpack_and_unpack_mask_match_reference(bits):
    rng = np.random.default_rng(10 + bits)
    words = random_words(rng, bits)
    words_t = tref.to_torch(words, "cpu")
    np.testing.assert_array_equal(
        tref.unpack(words_t, bits).numpy().astype(np.uint32),
        np.asarray(jref.unpack(words, bits)))
    delim, _, _ = jref.field_masks(bits)
    mask = rng.integers(0, 2**32, N_WORDS, dtype=np.uint64).astype(
        np.uint32) & delim
    np.testing.assert_array_equal(
        tref.unpack_mask(tref.to_torch(mask, "cpu"), bits).numpy(),
        np.asarray(jref.unpack_mask(mask, bits)))
    # and pack_bits inverts unpack_mask, bit 31 included
    back = tref.pack_bits(tref.unpack_mask(tref.to_torch(mask, "cpu"), bits),
                          bits)
    np.testing.assert_array_equal(as_np(back), mask)


@pytest.mark.parametrize("op", jref.OPS)
@pytest.mark.parametrize("bits", BITS)
def test_scan_filter_matches_reference(bits, op):
    """All six ops x edge constants, against the reference's jnp oracle
    and its Pallas kernel (interpret mode), in the port's auto and
    torch_ref modes."""
    rng = np.random.default_rng(100 * bits + jref.OPS.index(op))
    words = random_words(rng, bits)
    words_t = tref.to_torch(words, "cpu")
    for c in edge_constants(bits):
        want = np.asarray(jops.scan_filter(words, c, op, bits,
                                           mode="xla_ref"))
        np.testing.assert_array_equal(
            np.asarray(jops.scan_filter(words, c, op, bits, mode="pallas")),
            want)
        for mode in ("auto", "torch_ref"):
            got = tops.scan_filter(words_t, c, op, bits, mode=mode)
            assert got.dtype == torch.int32 and got.shape == words_t.shape
            np.testing.assert_array_equal(as_np(got), want,
                                          err_msg=f"{op} {c} {mode}")


@pytest.mark.parametrize("bits", BITS)
def test_scan_ref_slices_like_one_pass(bits, monkeypatch):
    """The plain version walks words in slices; the slice edge must not
    show in the mask."""
    rng = np.random.default_rng(7)
    words_t = tref.to_torch(random_words(rng, bits, 301), "cpu")
    whole = tref.scan_ref(words_t, 1, "ge", bits)
    monkeypatch.setattr(tref, "SLICE_WORDS", 64)
    torch.testing.assert_close(tref.scan_ref(words_t, 1, "ge", bits), whole,
                               rtol=0, atol=0)


def test_empty_words_and_bad_op():
    empty = torch.zeros(0, dtype=torch.int32)
    assert tops.scan_filter(empty, 3, "lt", 8).shape == (0,)
    with pytest.raises(ValueError, match="unknown predicate op"):
        tops.scan_filter(empty, 3, "like", 8)


@pytest.mark.parametrize("op", jref.OPS)
@pytest.mark.parametrize("bits", BITS)
def test_canonical_pred_and_packed_triples_match_reference(bits, op):
    vmax = (1 << (bits - 1)) - 1
    consts = (-2, -1, 0, 1, vmax // 2, vmax - 1, vmax, vmax + 1, vmax + 5)
    triples = []
    for c in consts:
        t = tops.canonical_pred(op, c, bits)
        assert t == jops.canonical_pred(op, c, bits), (op, c)
        triples.append(t)
    for got, want in zip(tops.packed_triples(triples, bits),
                         jops.packed_triples(triples, bits)):
        np.testing.assert_array_equal(got, want)


def test_cuda_mode_on_cpu_tensor_raises():
    words_t = tref.to_torch(random_words(np.random.default_rng(0), 8), "cpu")
    with pytest.raises(ValueError, match="lies on the CPU"):
        tops.scan_filter(words_t, 3, "lt", 8, mode="cuda")
    with pytest.raises(ValueError):
        tops.scan_filter(words_t, 3, "lt", 8, mode="pallas")


def test_kernel_wrapper_rejects_cpu_tensors():
    """The wrapper never runs the plain version itself: a CPU tensor is an
    error there, before anything is built."""
    words_t = tref.to_torch(random_words(np.random.default_rng(0), 8), "cpu")
    before = tkernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.scan_packed(words_t, 3, op="ge", code_bits=8)
    with pytest.raises(ValueError, match="primitive"):
        tkernel.scan_packed(words_t, 3, op="lt", code_bits=8)
    assert tkernel.LAUNCHES == before


@pytest.mark.parametrize("bits", BITS)
def test_packed_constant_matches_reference_kernel(bits):
    vmax = (1 << (bits - 1)) - 1
    for c in edge_constants(bits):
        want = 0
        for i in range(32 // bits):
            want |= (c & vmax) << (i * bits)
        assert tkernel.packed_constant(c, bits) == want


def test_dispatch_resolve_and_launch_counts():
    cpu = torch.zeros(4, dtype=torch.int32)
    assert dispatch.resolve(None, cpu) is False
    assert dispatch.resolve("auto", cpu) is False
    assert dispatch.resolve("torch_ref", cpu) is False
    with pytest.raises(ValueError):
        dispatch.resolve("cuda", cpu)
    with pytest.raises(ValueError):
        dispatch.resolve("xla_ref", cpu)
    dispatch.reset_launch_counts()
    tops.scan_filter(cpu, 1, "ge", 8)
    tops.scan_filter(cpu, 1, "lt", 8, mode="torch_ref")
    assert dispatch.launch_counts() == {"scan_filter": 2}
    assert dispatch.total_launches() == 2
    dispatch.reset_launch_counts()
    assert dispatch.launch_counts() == {}


def test_registry_examples_match_refs():
    ops = dispatch.registered()
    assert set(ops) == {"scan_filter", "aggregate", "scan_aggregate",
                        "scan_compressed", "group_aggregate",
                        "flash_attention", "decode_attention", "ssd_chunk"}
    for name, op in ops.items():
        args, kwargs = op.example(np.random.default_rng(0))
        got, want = op.fn(*args, **kwargs), op.ref(*args, **kwargs)
        if isinstance(want, dict):
            assert {k: int(v) for k, v in got.items()} == \
                {k: int(v) for k, v in want.items()}, name
        elif isinstance(want, tuple):           # ssd_chunk: (y, state)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), name
        else:
            assert torch.equal(got, want), name


@pytest.mark.parametrize("bits", BITS)
def test_scan_filter_batched_matches_reference(bits):
    """Per-chunk canonical triples over (n_chunks, n_words) planes, all six
    ops at random constants (tautologies included); the plain torch op in
    every mode, one launch count, as the reference's jnp form."""
    from repro.kernels import dispatch as jdispatch
    rng = np.random.default_rng(60 + bits)
    vmax = (1 << (bits - 1)) - 1
    words = np.stack([random_words(rng, bits, 257) for _ in range(9)])
    triples = [jops.canonical_pred(jref.OPS[k % 6], int(c), bits)
               for k, c in enumerate(rng.integers(-2, vmax + 3, 9))]
    want = np.asarray(jops.scan_filter_batched(words, triples, bits,
                                               mode="xla_ref"))
    wt = tref.to_torch(words, "cpu")
    dispatch.reset_launch_counts()
    jdispatch.reset_launch_counts()
    for mode in ("auto", "torch_ref"):
        got = tops.scan_filter_batched(wt, triples, bits, mode=mode)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        jops.scan_filter_batched(words, triples, bits, mode="pallas")
    assert dispatch.launch_counts() == jdispatch.launch_counts() == \
        {"scan_filter": 2}
    np.testing.assert_array_equal(
        tops.mask_batched(wt, triples, bits).numpy().view(np.uint32),
        np.asarray(jops.mask_batched(words, triples, bits)))
    empty = torch.zeros((0, 4), dtype=torch.int32)
    assert tops.scan_filter_batched(empty, [], bits).shape == (0, 4)
