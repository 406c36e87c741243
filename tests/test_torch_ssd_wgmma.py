"""The SSD kernel's tensor-core route (kernel 12, `ssd_wgmma_kernel` in
csrc/ssd_chunk.cu) on the CPU: its operand rounding, its route choice and
the wrapper's refusals.

The route feeds each float32 operand of a bf16 wgmma product as bf16
terms, each the rounding of what the ones before leave: W = C . B^T
exp(cum_i - cum_j) dt_j in three, d2e_j B_j (the chunk state) and the
inbound state h in two; its bf16 inputs and sums in float32 are exact or
as in the plain version. `split_route_ref` runs that rounding through
ref.ssd_chunked_ref's algebra; it must stay within chip_smoke.py's
SSD_TOL (|a - b| <= rel |b| + row * rms of b's row) of the plain version
and of the reference's model scan, at reduced shapes and at one chunk of
mamba2-1.3b's widths with decay rates A up to 16, and move y far less
than the plain version's own spread between chunk sizes (what the serve
path's teacher-forced check bounds). The kernel itself is held to
SSD_TOL against the plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_chunk import kernel as K
from repro_torch.kernels.ssd_chunk import ref

# chip_smoke.py's limit for kernel 12: (rel, row) by output dtype
SSD_TOL = {torch.float32: (2.0 ** -20, 2.0 ** -8),
           torch.bfloat16: (2.0 ** -6, 2.0 ** -8)}
# (B, S, H, P, N, Q): tests/test_kernels_ssd.py's shapes, the reduced
# mamba2 config's (P 16, N 16, Q 32), and one chunk of mamba2-1.3b's
# widths (64 heads of 64, state 128, chunk 256)
SHAPES = [(1, 64, 2, 64, 32, 32), (2, 128, 4, 64, 128, 64),
          (1, 256, 2, 128, 64, 128), (2, 128, 8, 16, 16, 32)]
PATH_CHUNK = (1, 256, 64, 64, 128, 256)


def split(t: torch.Tensor, terms: int = 2) -> torch.Tensor:
    """t as the route feeds it to bf16 products: `terms` bf16 roundings,
    each of what the ones before leave, summed in float32."""
    out, rest = torch.zeros_like(t), t
    for _ in range(terms):
        term = rest.to(torch.bfloat16).float()
        out, rest = out + term, rest - term
    return out


def split_route_ref(x, dt, a_log, b, c, chunk: int, init_state=None,
                    w_terms: int = 3):
    """ref.ssd_chunked_ref with the tensor-core route's operand rounding:
    W in `w_terms` bf16 terms (the kernel's three), the weighted B of the
    chunk state and the inbound state in two, before their products."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q, nc = chunk, s // chunk
    la = dt.float() * -torch.exp(a_log.float())
    cum = torch.cumsum(la.reshape(bsz, nc, q, h), dim=2)      # (B,NC,Q,H)
    total = cum[:, :, -1]
    xc = x.float().reshape(bsz, nc, q, h, p)
    dtc = dt.float().reshape(bsz, nc, q, h)
    bc = b.float().reshape(bsz, nc, q, n)
    cc = c.float().reshape(bsz, nc, q, n)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    seg = torch.where(causal[None, None, :, :, None], seg, -torch.inf)
    cb = torch.einsum("bkin,bkjn->bkij", cc, bc)
    w = split(cb[..., None] * torch.exp(seg) * dtc[:, :, None, :, :],
              w_terms)
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", w, xc)
    d2e = torch.exp(total[:, :, None] - cum) * dtc              # (B,NC,Q,H)
    wb = split(d2e[..., None] * bc[:, :, :, None, :])          # (B,NC,Q,H,N)
    sk = torch.einsum("bkjhn,bkjhp->bkhnp", wb, xc)
    state = (torch.zeros((bsz, h, n, p)) if init_state is None
             else init_state.float())
    prev = []
    for k in range(nc):
        prev.append(state)
        state = state * torch.exp(total[:, k])[..., None, None] + sk[:, k]
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bkin,bkhnp->bkihp", cc, split(torch.stack(prev, dim=1)))
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y.to(x.dtype), state


def limit_ratio(got, want, dtype) -> float:
    """Largest |got - want| over the SSD_TOL limit for `dtype`."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel, row = SSD_TOL[dtype]
    rms = np.sqrt(np.mean(w ** 2, axis=-1, keepdims=True))
    return float((np.abs(g - w) / np.maximum(rel * np.abs(w) + row * rms,
                                             1e-30)).max())


def make_inputs(seed, b, s, h, p, n, dtype, a_max=16.0, init=False):
    """numpy inputs as tests/test_kernels_ssd.py draws them (a_log =
    log(linspace(1, a_max, H)), B / C scaled by N^-1/2), x / B / C rounded
    to `dtype`; torch tensors, and h_in or None."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, h, p),
                                             dtype=np.float32)).to(dtype)
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((b, s, h)),
                                       0.0).astype(np.float32))
    a_log = torch.from_numpy(np.log(np.linspace(1.0, a_max, h))
                             .astype(np.float32))
    bm = torch.from_numpy((rng.standard_normal((b, s, n)) / n ** 0.5)
                          .astype(np.float32)).to(dtype)
    cm = torch.from_numpy((rng.standard_normal((b, s, n)) / n ** 0.5)
                          .astype(np.float32)).to(dtype)
    h_in = (torch.from_numpy(rng.standard_normal((b, h, n, p),
                                                 dtype=np.float32))
            if init else None)
    return (x, dt, a_log, bm, cm), h_in


def f64(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32), np.float64)


# --------------------------------------------------------------------------
# the route's operand rounding against the plain version and the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES + [PATH_CHUNK])
def test_split_rounding_within_ssd_tol_of_the_plain_version(b, s, h, p, n,
                                                            chunk, dtype):
    args, h_in = make_inputs(11, b, s, h, p, n, dtype, init=b > 1)
    got_y, got_h = split_route_ref(*args, chunk, h_in)
    want_y, want_h = ref.ssd_chunked_ref(*args, chunk, h_in)
    assert got_y.dtype == dtype
    assert limit_ratio(f64(got_y), f64(want_y), dtype) <= 1.0
    assert limit_ratio(f64(got_h), f64(want_h), torch.float32) <= 1.0


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES + [PATH_CHUNK])
def test_split_rounding_within_ssd_tol_of_the_reference_model_scan(
        b, s, h, p, n, chunk):
    """bf16-valued inputs held in float32, so the reference's model scan
    (which forms C . B^T in its inputs' dtype) computes in float32 as the
    route does; an inbound state at batch 2."""
    (x, dt, a_log, bm, cm), h_in = make_inputs(12, b, s, h, p, n,
                                               torch.bfloat16, init=b > 1)
    args = (x.float(), dt, a_log, bm.float(), cm.float())
    jcfg = jget_config("mamba2-1.3b").reduced(dtype="float32",
                                              ssm_chunk=chunk)
    jargs = tuple(jnp.asarray(t.numpy()) for t in args)
    want_y, want_h = jssm._ssd_chunked(
        *jargs, jcfg, init_state=None if h_in is None
        else jnp.asarray(h_in.numpy()))
    got_y, got_h = split_route_ref(*args, chunk, h_in)
    assert limit_ratio(f64(got_y), f64(want_y), torch.float32) <= 1.0
    assert limit_ratio(f64(got_h), f64(want_h), torch.float32) <= 1.0


@pytest.mark.parametrize("terms,limit", [(1, 2.0 ** -8), (2, 2.0 ** -16),
                                         (3, 2.0 ** -24)])
def test_split_carries_eight_bits_a_term(terms, limit):
    t = torch.from_numpy(np.random.default_rng(13).standard_normal(
        4096).astype(np.float32)) * 1e3
    rel = float(((split(t, terms) - t).abs() / t.abs()).max())
    assert rel <= limit
    if terms < 3:
        assert rel > limit / 2 ** 8


def test_w_in_three_terms_moves_y_far_less_than_the_chunk_spread():
    """y in bf16 at mamba2-1.3b's widths (1024 steps, 64 heads, A up to
    16): W in two bf16 terms (2^-16) flips enough of y's bf16 roundings to
    move it further from the plain version than the plain version moves
    between chunks of 256 and 128; in three (the kernel's) it moves y
    under a tenth of that."""
    args, _ = make_inputs(16, 1, 1024, 64, 64, 128, torch.bfloat16)
    plain, _ = ref.ssd_chunked_ref(*args, 256)
    spread = rel_frobenius(ref.ssd_chunked_ref(*args, 128)[0], plain)
    two = rel_frobenius(split_route_ref(*args, 256, w_terms=2)[0], plain)
    kernel = rel_frobenius(split_route_ref(*args, 256)[0], plain)
    assert two > spread > 10 * kernel


def rel_frobenius(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


# --------------------------------------------------------------------------
# the route choice and the wrapper's refusals (no card needed)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,p,n,want", [
    (torch.bfloat16, 64, 128, "wgmma"),       # mamba2-1.3b: the serve path
    (torch.bfloat16, 16, 16, "wgmma"),        # the reduced config
    (torch.bfloat16, 48, 64, "wgmma"),
    (torch.bfloat16, 100, 128, "cuda_core"),  # 200-byte rows: no TMA box
    (torch.bfloat16, 64, 7, "cuda_core"),     # 14-byte rows
    (torch.bfloat16, 128, 128, "cuda_core"),  # x and y tiles of 64 columns
    (torch.float32, 64, 128, "cuda_core"),    # fp32 inputs: CUDA cores
    (torch.float32, 16, 8, "cuda_core"),
])
def test_route_choice(dtype, p, n, want):
    assert K.route(dtype, p, n) == want


@pytest.mark.parametrize("q", [1, 100, 255, 256])
def test_every_chunk_length_takes_the_route_of_its_widths(q):
    """A ragged chunk (a short prompt's one chunk, Q 255) and a one-step
    chunk take the shape checks and the tensor-core route at the path's
    widths: the route does not depend on Q."""
    args, _ = make_inputs(14, 1, 2 * q, 2, 64, 128, torch.bfloat16)
    K.check_shapes(*args, q, None)
    assert K.route(args[0].dtype, 64, 128) == "wgmma"


def test_the_serve_configs_shape_takes_the_tensor_core_route():
    cfg = get_config("mamba2-1.3b")
    assert cfg.dtype == "bfloat16"
    assert K.route(torch.bfloat16, cfg.ssm_head_dim,
                   cfg.ssm_state) == "wgmma"


@pytest.mark.parametrize("shape,chunk,match", [
    ((1, 512, 2, 64, 128), 512, "chunk 512"),
    ((1, 100, 2, 64, 128), 64, "a whole number of chunks"),
    ((1, 64, 2, 129, 128), 64, "head dim P = 129"),
    ((1, 64, 2, 64, 129), 64, "state size N = 129"),
])
def test_wrapper_refuses_out_of_limit_shapes_before_launching(shape, chunk,
                                                              match):
    b, s, h, p, n = shape
    before = K.LAUNCHES
    args, _ = make_inputs(15, b, s, h, p, n, torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        K.ssd_scan(*args, chunk)
    assert K.LAUNCHES == before


@pytest.mark.parametrize("dtype,p,way", [
    (torch.float32, 64, "wgmma"),     # fp32 takes only the CUDA cores
    (torch.bfloat16, 100, "wgmma"),   # a row of 200 bytes: no TMA box
    (torch.bfloat16, 64, "tf32"),     # no such route
])
def test_wrapper_refuses_a_route_the_shape_does_not_take(dtype, p, way):
    before = K.LAUNCHES
    args, _ = make_inputs(17, 1, 64, 2, p, 128, dtype)
    with pytest.raises(ValueError, match=f"route '{way}'"):
        K.ssd_scan(*args, 64, None, way)
    assert K.LAUNCHES == before
