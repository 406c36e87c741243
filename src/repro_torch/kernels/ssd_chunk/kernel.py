"""ctypes wrapper of the CUDA SSD chunk-scan kernel (csrc/ssd_chunk.cu),
counterpart of repro/kernels/ssd_chunk/kernel.py::ssd_scan."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0   # wrapper calls that launched the kernel (not op calls): one
               # ssd_wgmma_kernel launch on the tensor-core route, four on
               # the CUDA-core route (C . B^T, chunk states, state pass,
               # chunk outputs)

MAX_CHUNK = 256      # the longest chunk (Q) the kernel stages
MAX_STATE = 128      # the largest state size (N)
MAX_HEAD_DIM = 128   # the largest head dim (P)
WGMMA_MAX_HEAD_DIM = 64   # the tensor-core route keeps x and y tiles of 64
ROUTES = ("cuda_core", "wgmma")   # the launch's route code is the index


def route(dtype: torch.dtype, p: int, n: int) -> str:
    """The kernel's route for a shape within the limits: "wgmma" (one
    launch, every product on the tensor cores) for bfloat16 with P <= 64
    and P, N multiples of 8 (TMA copies rows of 16-byte multiples);
    otherwise "cuda_core" (four launches, fp32 products on the CUDA cores),
    which also takes float32, whose inputs are not exact in bf16. Every
    chunk length takes either route."""
    if dtype == torch.bfloat16 and p <= WGMMA_MAX_HEAD_DIM and p % 8 == 0 \
            and n % 8 == 0:
        return "wgmma"
    return "cuda_core"


def check_shapes(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, chunk: int,
                 h_in: torch.Tensor | None) -> None:
    """Raise ValueError for shapes the kernel does not take (before any
    device or dtype check)."""
    if x.dim() != 4 or b.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)} must be (B, S, H, P) and b "
                         f"{tuple(b.shape)} (B, S, N)")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if tuple(dt.shape) != (bsz, s, h) or tuple(a_log.shape) != (h,) or \
            tuple(b.shape[:2]) != (bsz, s) or c.shape != b.shape:
        raise ValueError(f"dt {tuple(dt.shape)}, a_log "
                         f"{tuple(a_log.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)} do not fit x {tuple(x.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"chunk {chunk}: the kernel takes 1 <= chunk <= "
                         f"{MAX_CHUNK} steps and S = {s} a whole number of "
                         f"chunks")
    if not 1 <= p <= MAX_HEAD_DIM:
        raise ValueError(f"head dim P = {p}; the kernel takes 1 .. "
                         f"{MAX_HEAD_DIM}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size N = {n}; the kernel takes 1 .. "
                         f"{MAX_STATE}")
    if h_in is not None and tuple(h_in.shape) != (bsz, h, n, p):
        raise ValueError(f"h_in {tuple(h_in.shape)} does not fit (B, H, N, "
                         f"P) = {(bsz, h, n, p)}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int,
             h_in: torch.Tensor | None = None, way: str | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P) float32 or bfloat16; dt (B, S, H) float32 (post-
    softplus); a_log (H,) float32; b / c (B, S, N) in x's dtype; h_in
    (B, H, N, P) float32 or None (zeros): contiguous CUDA tensors on one
    device; S a whole number of chunks of `chunk` <= 256 steps, P and N
    at most 128 -> (y (B, S, H, P) in x's dtype, h_out (B, H, N, P)
    float32). `way` None takes route(); "cuda_core" the CUDA-core kernels
    at any shape (for measurement). Launches on the current stream and
    does not synchronise."""
    global LAUNCHES
    check_shapes(x, dt, a_log, b, c, chunk, h_in)
    chosen = route(x.dtype, x.shape[-1], b.shape[-1])
    if way not in (None, chosen, "cuda_core"):
        raise ValueError(f"route {way!r}: this shape takes {chosen!r} or "
                         f"'cuda_core'")
    way = way or chosen
    dtypes = tuple(_build.FLOAT_DTYPES)
    f32 = (torch.float32,)
    _build.check_operand(x, "x", ndim=4, dtypes=dtypes)
    _build.check_operand(dt, "dt", ndim=3, dtypes=f32)
    _build.check_operand(a_log, "a_log", ndim=1, dtypes=f32)
    _build.check_operand(b, "b", ndim=3, dtypes=dtypes)
    _build.check_operand(c, "c", like=b, ndim=3, dtypes=dtypes)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if b.dtype != x.dtype or any(t.device != x.device
                                 for t in (dt, a_log, b)):
        raise ValueError(f"b/c {b.dtype} on {b.device}, dt and a_log must "
                         f"lie with x ({x.dtype} on {x.device}) and b/c "
                         f"take x's dtype")
    if h_in is not None:
        _build.check_operand(h_in, "h_in", ndim=4, dtypes=f32)
        if h_in.device != x.device:
            raise ValueError(f"h_in on {h_in.device}, x on {x.device}")
    y = torch.empty_like(x)
    h_out = torch.empty((bsz, h, n, p), dtype=torch.float32,
                        device=x.device)
    if bsz * s * h == 0:
        return y, h_out.zero_() if h_in is None else h_out.copy_(h_in)
    cb = states = total = None
    if way == "cuda_core":
        nc = s // chunk
        f32 = dict(dtype=torch.float32, device=x.device)
        cb = torch.empty((bsz, nc, chunk, chunk), **f32)       # C . B^T
        states = torch.empty((bsz, nc, h, n, p), **f32)        # chunk states
        total = torch.empty((bsz, nc, h), **f32)               # cum at end
    lib = _build.load("ssd_chunk")
    err = _build.call_on(
        x, lib.ssd_chunk_launch, x.data_ptr(), dt.data_ptr(),
        a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if h_in is None else h_in.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (cb, states, total)),
        y.data_ptr(), h_out.data_ptr(), _build.FLOAT_DTYPES[x.dtype],
        ROUTES.index(way), bsz, s, h, p, n, chunk, _build.stream_of(x))
    _build.check(lib, err, "ssd_chunk")
    LAUNCHES += 1
    return y, h_out
