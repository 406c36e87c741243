"""Parity of the port's attention kernels (decode_attention, kernel 10;
flash_attention, kernel 11) with the reference, on the CPU.

The same numpy inputs go through the reference's ops (the Pallas kernels in
interpret mode, as tests/test_kernels.py runs them) and refs, and through
the port's ops (on CPU tensors: the plain PyTorch versions). Tolerances are
the reference tests' own: float32 2e-5; bfloat16 2e-2, compared in
float32 — the Pallas kernels round the softmax probabilities to bf16
before the PV product while both refs (and the port's kernels) keep them in
float32, and each output is rounded once to bf16. The CUDA kernels
themselves are held against the plain versions on the card by
chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jdec_ops
from repro.kernels.decode_attention import ref as jdec_ref
from repro.kernels.flash_attention import kernel as jflash_kernel
from repro.kernels.flash_attention import ops as jflash_ops
from repro.kernels.flash_attention import ref as jflash_ref
from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.models.attention import INF_POS

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def both(x, dtype_name):
    """float32 numpy -> (jax array, torch tensor) of one dtype; bf16 is
    rounded to nearest-even by both frameworks alike."""
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def normal(rng, shape):
    return rng.standard_normal(shape, dtype=np.float32)


# --------------------------------------------------------------------------
# kernel 11: flash attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,kvh,g,sq,skv,d", [
    (1, 1, 1, 128, 128, 128),
    (2, 2, 4, 128, 256, 128),     # GQA group 4, rectangular
    (1, 2, 1, 256, 256, 64),
    (2, 1, 2, 384, 384, 128),
])
def test_flash_matches_reference(dtype, b, kvh, g, sq, skv, d):
    rng = np.random.default_rng(100 + sq + skv + g)
    (jq, q), (jk, k), (jv, v) = (both(normal(rng, s), dtype) for s in (
        (b, kvh, g, sq, d), (b, kvh, skv, d), (b, kvh, skv, d)))
    want_kernel = jflash_kernel.flash_attention_fwd(jq, jk, jv,
                                                    interpret=True)
    want_ref = jflash_ref.attention_ref(jq, jk, jv)
    got_ref = flash_ref.attention_ref(q, k, v)
    got_op = flash_ops.flash5(q, k, v, 0)
    assert got_op.dtype == q.dtype and got_op.shape == q.shape
    for got in (got_ref, got_op):
        np.testing.assert_allclose(f32(got), f32(want_ref), **tol(dtype))
        np.testing.assert_allclose(f32(got), f32(want_kernel), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_head_dim_256_matches_reference(dtype, window):
    """recurrentgemma-2b's head dim (256) and group (G 10, one kv head),
    windowed as its attention layers are: against the Pallas kernel in
    interpret mode and the reference's ref."""
    b, kvh, g, sq, skv, d = 1, 1, 10, 256, 256, 256
    rng = np.random.default_rng(256 + window)
    (jq, q), (jk, k), (jv, v) = (both(normal(rng, s), dtype) for s in (
        (b, kvh, g, sq, d), (b, kvh, skv, d), (b, kvh, skv, d)))
    want_kernel = jflash_kernel.flash_attention_fwd(jq, jk, jv, window=window,
                                                    interpret=True)
    want_ref = jflash_ref.attention_ref(jq, jk, jv, window=window)
    got_ref = flash_ref.attention_ref(q, k, v, window=window)
    got_op = flash_ops.flash5(q, k, v, window)
    assert got_op.dtype == q.dtype and got_op.shape == q.shape
    for got in (got_ref, got_op):
        np.testing.assert_allclose(f32(got), f32(want_ref), **tol(dtype))
        np.testing.assert_allclose(f32(got), f32(want_kernel), **tol(dtype))


@pytest.mark.parametrize("window", [32, 128, 1024])
def test_flash_sliding_window_matches_reference(window):
    rng = np.random.default_rng(7)
    (jq, q), (jk, k), (jv, v) = (both(normal(rng, s), "float32") for s in (
        (1, 2, 2, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64)))
    want = jflash_kernel.flash_attention_fwd(jq, jk, jv, window=window,
                                             interpret=True)
    got = flash_ops.flash5(q, k, v, window)
    np.testing.assert_allclose(f32(got), f32(want), **tol("float32"))
    np.testing.assert_allclose(
        f32(got), f32(jflash_ref.attention_ref(jq, jk, jv, window=window)),
        **tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,window", [(100, 1000, 0), (100, 1000, 64),
                                           (37, 37, 0), (1, 300, 16)])
def test_flash_ragged_lengths_match_reference_ref(dtype, sq, skv, window):
    """Sq and Skv that no tile divides (the Pallas kernel asserts them
    away; the port's kernel masks the ragged edge): against the
    reference's ref."""
    rng = np.random.default_rng(sq + skv + window)
    (jq, q), (jk, k), (jv, v) = (both(normal(rng, s), dtype) for s in (
        (1, 2, 2, sq, 64), (1, 2, skv, 64), (1, 2, skv, 64)))
    want = jflash_ref.attention_ref(jq, jk, jv, window=window)
    got = flash_ops.flash5(q, k, v, window)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ragged_head_dim_256_matches_reference_ref(dtype):
    """A ragged prompt at head dim 256 and G 10, window 64: 37 query rows
    over 300 keys, which no 64-key tile divides."""
    rng = np.random.default_rng(37300)
    (jq, q), (jk, k), (jv, v) = (both(normal(rng, s), dtype) for s in (
        (1, 1, 10, 37, 256), (1, 1, 300, 256), (1, 1, 300, 256)))
    want = jflash_ref.attention_ref(jq, jk, jv, window=64)
    got = flash_ops.flash5(q, k, v, 64)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


def test_flash5_gradient_matches_jax_grad():
    """flash5's backward differentiates the plain version, as the
    reference's custom_vjp differentiates its ref: against jax.grad of the
    reference's flash5 (Pallas forward in interpret mode)."""
    rng = np.random.default_rng(3)
    xs = [normal(rng, s) for s in ((1, 1, 1, 128, 64), (1, 1, 128, 64),
                                   (1, 1, 128, 64))]

    def loss(q, k, v):
        return jnp.sum(jflash_ops.flash5(q, k, v, 0) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    (flash_ops.flash5(*ts, 0) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


def test_flash5_gradient_with_window_matches_ref_gradient():
    rng = np.random.default_rng(4)
    xs = [normal(rng, s) for s in ((1, 2, 2, 96, 32), (1, 2, 96, 32),
                                   (1, 2, 96, 32))]
    want = jax.grad(lambda q, k, v: jnp.sum(jflash_ref.attention_ref(
        q, k, v, window=40) ** 3), argnums=(0, 1, 2))(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    (flash_ops.flash5(*ts, 40) ** 3).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


def test_flash_model_layout_adapter_matches_reference():
    rng = np.random.default_rng(5)
    (jq, q), (jk, k), (jv, v) = (both(normal(rng, s), "float32") for s in (
        (2, 128, 2, 2, 32), (2, 128, 2, 32), (2, 128, 2, 32)))
    pos = np.broadcast_to(np.arange(128, dtype=np.int32), (2, 128))
    want = jflash_ops.flash_attention(jq, jk, jv, jnp.asarray(pos),
                                      jnp.asarray(pos), window=48)
    got = flash_ops.flash_attention(q, k, v, torch.from_numpy(pos.copy()),
                                    torch.from_numpy(pos.copy()), window=48)
    assert got.shape == q.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol("float32"))


# --------------------------------------------------------------------------
# kernel 10: decode attention
# --------------------------------------------------------------------------

def ring(b, s, fills, wrap_to=None):
    """(B, S) stored positions and (B,) query positions: row i filled with
    positions 0 .. fills[i] - 1 (rest never written) and querying at
    fills[i]; with wrap_to[i], holding the S positions ending at
    wrap_to[i] - 1 in ring order."""
    kv = np.full((b, s), INF_POS, np.int32)
    qp = np.zeros(b, np.int32)
    for i in range(b):
        if wrap_to is not None and wrap_to[i] is not None:
            pos = np.arange(wrap_to[i] - s, wrap_to[i])
            kv[i, pos % s] = pos
            qp[i] = wrap_to[i]
        else:
            kv[i, :fills[i]] = np.arange(fills[i])
            qp[i] = fills[i]
    return kv, qp


def run_decode(dtype, b, kvh, g, s, d, kv_pos, q_pos, window, seed):
    rng = np.random.default_rng(seed)
    (jq, q), (jk, k), (jv, v) = (both(normal(rng, sh), dtype) for sh in (
        (b, kvh, g, d), (b, kvh, s, d), (b, kvh, s, d)))
    jargs = (jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos))
    targs = (q, k, v, torch.from_numpy(q_pos), torch.from_numpy(kv_pos))
    want_kernel = jdec_ops.decode_attention(*jargs, window=window)
    want_ref = jdec_ref.decode_ref(*jargs, window=window)
    got_op = dec_ops.decode_attention(*targs, window=window)
    got_ref = dec_ref.decode_ref(*targs, window=window)
    assert got_op.dtype == q.dtype and got_op.shape == q.shape
    for got in (got_op, got_ref):
        np.testing.assert_allclose(f32(got), f32(want_ref), **tol(dtype))
        np.testing.assert_allclose(f32(got), f32(want_kernel), **tol(dtype))
    return got_op


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,kvh,g,s,d", [
    (2, 2, 2, 512, 128),
    (1, 1, 8, 1024, 64),
    (4, 2, 1, 2048, 128),
])
def test_decode_matches_reference(dtype, b, kvh, g, s, d):
    kv_pos, q_pos = ring(b, s, [int(0.75 * s)] * b)
    run_decode(dtype, b, kvh, g, s, d, kv_pos, q_pos, 0, seed=s + g)


@pytest.mark.parametrize("window", [64, 512])
def test_decode_wrapped_ring_with_window_matches_reference(window):
    """The ring holds positions 300..555 (wrapped); the window masks stale
    slots."""
    kv_pos, q_pos = ring(1, 256, [0], [556])
    run_decode("float32", 1, 1, 2, 256, 64, kv_pos, q_pos, window, seed=5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_all_masked_row_averages_v_uniformly(dtype):
    """Row 0 is an inactive serving slot (q_pos 0 over a ring that was
    never written): every slot is masked with the finite -1e30, so both
    packages average V uniformly instead of producing NaN; row 1 holds
    one written slot."""
    b, kvh, g, s, d = 2, 2, 2, 512, 64
    kv_pos, q_pos = ring(b, s, [0, 1])
    out = run_decode(dtype, b, kvh, g, s, d, kv_pos, q_pos, 0, seed=11)
    assert torch.isfinite(out.float()).all()


def test_decode_ragged_ring_and_group_sizes_match_reference_ref():
    """A ring length no block divides, G = 3: against the reference's ref
    (its Pallas kernel asserts S % bk == 0)."""
    kv_pos, q_pos = ring(3, 1000, [0, 999, 1000])
    rng = np.random.default_rng(12)
    (jq, q), (jk, k), (jv, v) = (both(normal(rng, sh), "float32")
                                 for sh in ((3, 2, 3, 64), (3, 2, 1000, 64),
                                            (3, 2, 1000, 64)))
    want = jdec_ref.decode_ref(jq, jk, jv, jnp.asarray(q_pos),
                               jnp.asarray(kv_pos), window=100)
    got = dec_ops.decode_attention(q, k, v, torch.from_numpy(q_pos),
                                   torch.from_numpy(kv_pos), window=100)
    np.testing.assert_allclose(f32(got), f32(want), **tol("float32"))


# --------------------------------------------------------------------------
# dispatch and the CUDA wrappers' checks (no card needed)
# --------------------------------------------------------------------------

def test_registered_in_the_reference_order():
    from repro.kernels import dispatch as jdispatch
    assert dispatch._OP_MODULES == jdispatch._OP_MODULES
    for name in ("flash_attention", "decode_attention"):
        op = dispatch.get(name)
        args, kwargs = op.example(np.random.default_rng(0))
        assert torch.equal(op.fn(*args, **kwargs), op.ref(*args, **kwargs))


def test_attention_ops_are_not_counted_as_launches():
    """As in the reference, the attention ops do not add to the dispatch
    launch counts (those count the query engine's per-chunk dispatches)."""
    args, _ = dispatch.get("decode_attention").example(
        np.random.default_rng(1))
    dispatch.reset_launch_counts()
    dec_ops.decode_attention(*args)
    flash_ops.flash5(*dispatch.get("flash_attention").example(
        np.random.default_rng(1))[0])
    assert dispatch.launch_counts() == {}


def test_mode_cuda_on_cpu_tensors_raises():
    args, _ = dispatch.get("decode_attention").example(
        np.random.default_rng(2))
    with pytest.raises(ValueError, match="lies on the CPU"):
        dec_ops.decode_attention(*args, mode="cuda")
    fargs, _ = dispatch.get("flash_attention").example(
        np.random.default_rng(2))
    with pytest.raises(ValueError, match="lies on the CPU"):
        flash_ops.flash5(*fargs, 0, "cuda")


def test_kernel_wrappers_refuse_cpu_tensors_before_launching():
    before = (dec_kernel.LAUNCHES, flash_kernel.LAUNCHES)
    args, _ = dispatch.get("decode_attention").example(
        np.random.default_rng(3))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        dec_kernel.decode_attention_fwd(*args)
    fargs, _ = dispatch.get("flash_attention").example(
        np.random.default_rng(3))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        flash_kernel.flash_attention_fwd(*fargs)
    assert (dec_kernel.LAUNCHES, flash_kernel.LAUNCHES) == before


# --------------------------------------------------------------------------
# kernel 10's work plan: the library's plan as the wrapper keeps it, the
# scratch, and the plain version of the plan each block makes on the card
# against brute force
# --------------------------------------------------------------------------

class PlanLib:
    """Stands in for the kernel library's decode_attention_plan: writes a
    plan of (splits, tile slots, rows, scratch words) that depends on the
    shape, or returns a CUDA error."""

    def __init__(self, err: int = 0):
        self.err = err
        self.asked = []

    def decode_attention_plan(self, dtype, b, kvh, g, s, d, out):
        self.asked.append((dtype, b, kvh, g, s, d))
        if self.err:
            return self.err
        out[0], out[1], out[2] = 6, 64, b * kvh
        out[3] = b * kvh * 6 * g * (d + 2) + b * kvh
        return 0

    def repro_error_string(self, err):
        return b"invalid argument"


def test_decode_plan_is_asked_once_per_device_dtype_and_shape(monkeypatch):
    monkeypatch.setattr(dec_kernel, "_PLANS", {})
    lib = PlanLib()
    key = (0, 1, 8, 8, 2, 8192, 128)
    want = (6, 64, 64, 64 * 6 * 2 * 130 + 64)
    assert dec_kernel.plan(lib, key) == want
    assert dec_kernel.plan(lib, key) == want
    assert lib.asked == [key[1:]]
    # another device, dtype or shape is planned anew
    for other in ((1, 1, 8, 8, 2, 8192, 128), (0, 0, 8, 8, 2, 8192, 128),
                  (0, 1, 8, 8, 2, 4096, 128)):
        dec_kernel.plan(lib, other)
    assert len(lib.asked) == 4


def test_decode_plan_error_raises_and_is_not_kept(monkeypatch):
    monkeypatch.setattr(dec_kernel, "_PLANS", {})
    lib = PlanLib(err=1)
    key = (0, 1, 1, 1, 1, 64, 96)
    with pytest.raises(RuntimeError, match="decode_attention.*CUDA error 1"):
        dec_kernel.plan(lib, key)
    assert dec_kernel._PLANS == {}


def test_decode_scratch_is_zeroed_once_per_device_stream_and_shape(
        monkeypatch):
    monkeypatch.setattr(dec_kernel, "_SCRATCH", {})
    dev = torch.device("cpu")
    key = (0, 1, 1, 2, 2, 512, 64)
    a = dec_kernel._scratch(dev, 7, key, 100, False)
    assert a.dtype == torch.float32 and a.numel() == 100 and not a.any()
    assert dec_kernel._scratch(dev, 7, key, 100, False) is a
    assert dec_kernel._scratch(dev, 8, key, 100, False) is not a
    assert dec_kernel._scratch(dev, 7, key[:-1] + (32,), 100, False) is not a


def test_decode_scratch_under_capture_is_its_own(monkeypatch):
    """A call being captured in a CUDA graph gets a fresh zeroed scratch,
    never the eager calls' one, and leaves the eager cache untouched."""
    monkeypatch.setattr(dec_kernel, "_SCRATCH", {})
    dev = torch.device("cpu")
    key = (0, 1, 1, 2, 2, 512, 64)
    eager = dec_kernel._scratch(dev, 7, key, 100, False)
    eager.fill_(1.0)
    a = dec_kernel._scratch(dev, 7, key, 100, True)
    b = dec_kernel._scratch(dev, 7, key, 100, True)
    assert a is not eager and b is not a
    assert a.numel() == 100 and not a.any() and not b.any()
    assert list(dec_kernel._SCRATCH.values()) == [eager]


def brute_plan(kv_pos, q_pos, window, tile, splits):
    """Per batch row, slot by slot: the valid slots; the tiles from the
    first valid slot's to the last's (every tile when none is valid) cut
    into `splits` runs of ceil(span / splits); a split reads the tiles of
    its run that hold a valid slot (every one when none is valid)."""
    b, s = kv_pos.shape
    n_tiles = -(-s // tile)
    reads = np.zeros((b, splits, n_tiles), bool)
    anys = np.zeros(b, bool)
    for i in range(b):
        valid = [j for j in range(s)
                 if 0 <= q_pos[i] - kv_pos[i, j]
                 and (not window or q_pos[i] - kv_pos[i, j] < window)]
        anys[i] = bool(valid)
        if valid:
            lo, hi = valid[0] // tile, valid[-1] // tile
            need = {j // tile for j in valid}
        else:
            lo, hi, need = 0, n_tiles - 1, set(range(n_tiles))
        per = -(-(hi - lo + 1) // splits)
        for sp in range(splits):
            for t in range(lo + sp * per, min(hi + 1, lo + (sp + 1) * per)):
                reads[i, sp, t] = t in need
    return reads, anys


def plan_rings(rng, s, tile):
    """Rings of one length S: filled, wrapped, windowed, all masked (an
    inactive slot: q_pos 0 over INF_POS), valid slots only in the last tile,
    one valid slot in each of a few scattered tiles, all valid slots inside
    one split's run. Returns [(label, kv_pos (B, S), q_pos (B,), window)]."""
    out = []
    fills = rng.integers(1, s + 1, 4)
    kv, qp = ring(4, s, list(fills))
    out.append(("filled", kv, qp, 0))
    kv, qp = ring(3, s, [0] * 3, [s + 1, 2 * s + 37, 5 * s - 3])
    out.append(("wrapped", kv, qp, 0))
    out.append(("wrapped, window across the wrap", kv, qp,
                int(rng.integers(2, s))))
    kv, qp = ring(2, s, [0, 0])
    out.append(("all masked", kv, qp, 0))
    kv = np.full((2, s), INF_POS, np.int32)
    kv[:, s - 3:] = np.arange(3)
    out.append(("only the last tile", kv, np.full(2, 3, np.int32), 0))
    kv = np.full((2, s), INF_POS, np.int32)
    slots = np.sort(rng.choice(s, 5, replace=False))
    kv[:, slots] = np.arange(5)
    out.append(("scattered single slots", kv, np.full(2, 5, np.int32), 0))
    kv = np.full((1, s), INF_POS, np.int32)
    a = int(rng.integers(0, s - tile))
    kv[0, a:a + tile // 2] = np.arange(tile // 2)
    out.append(("one split's run", kv, np.array([tile // 2], np.int32), 0))
    return out


@pytest.mark.parametrize("s,tile,splits", [
    (8192, 32, 6), (1000, 64, 16), (300, 16, 7), (512, 64, 1), (4100, 32, 3),
    (8192, 64, 6),      # the serving path's plan on an H100
    (1001, 64, 6),      # an odd ring: a last tile of 41 slots
    (130, 16, 200),     # more splits than tiles
    (96, 64, 4),        # two tiles, the second ragged
    (2048, 64, 33),     # splits that do not divide the tiles
])
def test_decode_tile_plan_matches_brute_force(s, tile, splits):
    rng = np.random.default_rng(s + tile + splits)
    for label, kv, qp, window in plan_rings(rng, s, tile):
        reads, anys = dec_kernel.tile_plan(
            torch.from_numpy(kv), torch.from_numpy(qp), window, tile, splits)
        want_reads, want_any = brute_plan(kv, qp, window, tile, splits)
        assert np.array_equal(anys.numpy(), want_any), label
        assert np.array_equal(reads.numpy(), want_reads), label
        # each tile a row needs is read by exactly one split; none else
        dp = qp[:, None].astype(np.int64) - kv
        ok = (dp >= 0) & ((dp < window) if window else True)
        n_tiles = -(-s // tile)
        pad = np.zeros((kv.shape[0], n_tiles * tile), bool)
        pad[:, :s] = ok
        need = pad.reshape(-1, n_tiles, tile).any(-1) | ~want_any[:, None]
        assert np.array_equal(reads.numpy().sum(1), need.astype(int)), label
