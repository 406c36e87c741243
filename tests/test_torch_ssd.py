"""Parity of the port's SSD chunk scan (kernel 12, repro_torch.kernels.
ssd_chunk) with the reference, on the CPU.

The same numpy inputs go through the reference's op (its Pallas kernel in
interpret mode, as tests/test_kernels_ssd.py runs it, and its chunk-loop
oracle `xla_ref`), the reference model's `ssm._ssd_chunked`, and the
port's op (on CPU tensors: the plain PyTorch version) and `_ssd_chunked`.
Tolerances are tests/test_kernels_ssd.py's: float32 2e-4 on y and 1e-3 on
the final state, bfloat16 3e-2 (compared in float32: the reference's
oracle and model round C . B^T to bf16, its kernel and the port do not,
and each y is rounded once to bf16). The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.ssd_chunk import ops as jops
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd_chunk import kernel as K
from repro_torch.kernels.ssd_chunk import ops, ref
from repro_torch.models import ssm

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(1, 64, 2, 64, 32, 32),           # tests/test_kernels_ssd.py:22-27
          (2, 128, 4, 64, 128, 64),
          (1, 256, 2, 128, 64, 128)]


def y_tol(name):
    return dict(rtol=3e-2, atol=3e-2) if name == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


H_TOL = dict(rtol=1e-3, atol=1e-3)


def make_inputs(seed, b, s, h, p, n, dtype_name="float32"):
    """tests/test_kernels_ssd.py::make_inputs from numpy: x, dt (post-
    softplus), a_log = log(linspace(1, 8, H)), B and C scaled by N^-1/2;
    returned as (jax arrays, torch tensors), x / B / C in the dtype (bf16
    rounded to nearest-even by both frameworks alike)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, h)).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) / n ** 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) / n ** 0.5).astype(np.float32)
    jd, td = DTYPES[dtype_name]
    cast = {0, 3, 4}
    arrays = (x, dt, a_log, bm, cm)
    jx = tuple(jnp.asarray(a).astype(jd) if i in cast else jnp.asarray(a)
               for i, a in enumerate(arrays))
    tx = tuple(torch.from_numpy(a).to(td) if i in cast else
               torch.from_numpy(a) for i, a in enumerate(arrays))
    return jx, tx


def f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32), np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def cfg_pair(chunk):
    return (jget_config("mamba2-1.3b").reduced(dtype="float32",
                                               ssm_chunk=chunk),
            get_config("mamba2-1.3b").reduced(dtype="float32",
                                              ssm_chunk=chunk))


# --------------------------------------------------------------------------
# the op against the reference's kernel, oracle and model scan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
@pytest.mark.parametrize("jmode", ["pallas", "xla_ref"])
def test_op_matches_reference_op(jmode, b, s, h, p, n, chunk, dtype):
    jx, tx = make_inputs(0, b, s, h, p, n, dtype)
    want_y, want_h = jops.ssd(*jx, chunk, mode=jmode)
    got_y, got_h = ops.ssd(*tx, chunk)
    assert got_y.dtype == DTYPES[dtype][1] and got_h.dtype == torch.float32
    assert tuple(got_h.shape) == (b, h, n, p)
    close(got_y, want_y, **y_tol(dtype))
    close(got_h, want_h, **H_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_model_scan_matches_reference_model_scan(b, s, h, p, n, chunk,
                                                 dtype):
    """ssm._ssd_chunked, port vs reference, at a config whose chunk is the
    shape's."""
    jcfg, cfg = cfg_pair(chunk)
    jx, tx = make_inputs(1, b, s, h, p, n, dtype)
    want_y, want_h = jssm._ssd_chunked(*jx, jcfg)
    got_y, got_h = ssm._ssd_chunked(*tx, cfg)
    close(got_y, want_y, **y_tol(dtype))
    close(got_h, want_h, **H_TOL)


def test_three_way_on_the_reduced_model():
    """tests/test_kernels_ssd.py::test_kernel_matches_model_ssd's shape:
    the port's op == the reference's model scan == the reference's kernel."""
    jcfg, cfg = cfg_pair(32)
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    jx, tx = make_inputs(2, 2, 128, h, p, n)
    model_y, model_h = jssm._ssd_chunked(*jx, jcfg)
    kern_y, kern_h = jops.ssd(*jx, jcfg.ssm_chunk, mode="pallas")
    got_y, got_h = ops.ssd(*tx, cfg.ssm_chunk)
    for want_y, want_h in ((model_y, model_h), (kern_y, kern_h)):
        close(got_y, want_y, rtol=5e-4, atol=5e-4)
        close(got_h, want_h, **H_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nonzero_init_state_matches_reference_model_scan(dtype):
    """The state entering the first chunk (the model's cache at a
    prefill that continues a segment): the reference's op takes none, its
    model scan does."""
    jcfg, cfg = cfg_pair(32)
    jx, tx = make_inputs(3, 2, 96, 3, 32, 16, dtype)
    h0 = np.random.default_rng(4).standard_normal((2, 3, 16, 32),
                                                  dtype=np.float32)
    want_y, want_h = jssm._ssd_chunked(*jx, jcfg,
                                       init_state=jnp.asarray(h0))
    got_y, got_h = ops.ssd(*tx, 32, init_state=torch.from_numpy(h0))
    close(got_y, want_y, **y_tol(dtype))
    close(got_h, want_h, **H_TOL)
    zero_y, _ = ops.ssd(*tx, 32)
    assert not np.allclose(f32(zero_y), f32(got_y), atol=1e-3)


def test_ragged_chunk_is_one_chunk_of_the_whole_sequence():
    """S = 100 under a 256-step chunk: one chunk of 100 (q = min(chunk,
    S)), as a 100-token prompt runs; the reference's kernel and model scan
    agree."""
    jcfg, cfg = cfg_pair(256)
    jx, tx = make_inputs(5, 1, 100, 2, 64, 32)
    want_y, want_h = jssm._ssd_chunked(*jx, jcfg)
    kern_y, kern_h = jops.ssd(*jx, 100, mode="pallas")
    got_y, got_h = ssm._ssd_chunked(*tx, cfg)
    for wy, wh in ((want_y, want_h), (kern_y, kern_h)):
        close(got_y, wy, **y_tol("float32"))
        close(got_h, wh, **H_TOL)


def test_chunk_independence():
    """Chunk size must not change the math (32 vs 128)."""
    _, tx = make_inputs(6, 1, 256, 2, 64, 32)
    y1, h1 = ops.ssd(*tx, 32)
    y2, h2 = ops.ssd(*tx, 128)
    close(y1, y2, rtol=2e-4, atol=2e-4)
    close(h1, h2, **H_TOL)


def test_a_sequence_that_is_no_whole_number_of_chunks_is_refused():
    """As the reference's _ssd_chunked asserts (models/ssm.py:71): 40 steps
    at chunk 32."""
    jcfg, cfg = cfg_pair(32)
    jx, tx = make_inputs(7, 1, 40, 2, 16, 8)
    with pytest.raises(AssertionError, match="40, 32"):
        jssm._ssd_chunked(*jx, jcfg)
    with pytest.raises(AssertionError, match="40, 32"):
        ssm._ssd_chunked(*tx, cfg)


def test_plain_versions_agree_with_each_other():
    """The vectorized chunked form and the chunk loop over the one-chunk
    oracle, with an inbound state."""
    _, tx = make_inputs(8, 2, 96, 2, 16, 8)
    h0 = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 2, 8, 16), dtype=np.float32))
    y1, h1 = ref.ssd_chunked_ref(*tx, 32, h0)
    y2, h2 = ref.ssd_loop_ref(*tx, 32, h0)
    close(y1, y2, rtol=1e-5, atol=1e-5)
    close(h1, h2, rtol=1e-5, atol=1e-5)


def test_masked_upper_triangle_stays_finite():
    """Steep decays (dt of 50 at A = -8) make exp(cum_i - cum_j) overflow
    above the diagonal; masking the argument keeps every output finite."""
    _, (x, dt, a_log, b, c) = make_inputs(10, 1, 64, 2, 16, 8)
    dt = torch.full_like(dt, 50.0)
    y, h = ops.ssd(x, dt, a_log, b, c, 64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())


# --------------------------------------------------------------------------
# dispatch and the CUDA wrapper's checks (no card needed)
# --------------------------------------------------------------------------

def test_registered_in_the_reference_order_and_ref_equals_fn():
    from repro.kernels import dispatch as jdispatch
    assert dispatch._OP_MODULES == jdispatch._OP_MODULES
    assert set(dispatch.registered()) == set(jdispatch.registered())
    op = dispatch.get("ssd_chunk")
    args, kwargs = op.example(np.random.default_rng(0))
    got, want = op.fn(*args, **kwargs), op.ref(*args, **kwargs)
    for g, w in zip(got, want):
        close(g, w, rtol=1e-5, atol=1e-5)


def test_mode_torch_ref_and_cuda_on_cpu_tensors():
    args, _ = dispatch.get("ssd_chunk").example(np.random.default_rng(1))
    y, h = ops.ssd(*args, mode="torch_ref")
    y2, h2 = ops.ssd(*args)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    with pytest.raises(ValueError, match="lies on the CPU"):
        ops.ssd(*args, mode="cuda")


def test_kernel_wrapper_refuses_cpu_tensors_before_launching():
    before = K.LAUNCHES
    args, _ = dispatch.get("ssd_chunk").example(np.random.default_rng(2))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        K.ssd_scan(*args)
    assert K.LAUNCHES == before


def test_op_is_not_counted_as_a_launch():
    """As in the reference, the SSD op does not add to the dispatch launch
    counts (those count the query engine's per-chunk dispatches)."""
    args, _ = dispatch.get("ssd_chunk").example(np.random.default_rng(3))
    dispatch.reset_launch_counts()
    ops.ssd(*args)
    assert dispatch.launch_counts() == {}


def test_reduced_config_fits_the_kernel():
    """The shapes the model hands the kernel, reduced and full: P and N at
    most 128, chunks of at most 256."""
    for cfg in (get_config("mamba2-1.3b"),
                get_config("mamba2-1.3b").reduced()):
        assert 1 <= cfg.ssm_head_dim <= K.MAX_HEAD_DIM
        assert 1 <= cfg.ssm_state <= K.MAX_STATE
        assert cfg.ssm_chunk <= K.MAX_CHUNK
