"""ctypes wrapper of the CUDA SSD chunk-scan kernel (csrc/ssd_chunk.cu),
counterpart of repro/kernels/ssd_chunk/kernel.py::ssd_scan."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0   # wrapper calls that launched the kernel (four launches
               # each: C . B^T, chunk states, state pass, chunk outputs;
               # not op calls)

MAX_CHUNK = 256      # the longest chunk (Q) the kernel stages
MAX_STATE = 128      # the largest state size (N)
MAX_HEAD_DIM = 128   # the largest head dim (P)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int,
             h_in: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P) float32 or bfloat16; dt (B, S, H) float32 (post-
    softplus); a_log (H,) float32; b / c (B, S, N) in x's dtype; h_in
    (B, H, N, P) float32 or None (zeros): contiguous CUDA tensors on one
    device; S a whole number of chunks of `chunk` <= 256 steps, P and N
    at most 128 -> (y (B, S, H, P) in x's dtype, h_out (B, H, N, P)
    float32). Launches on the current stream and does not synchronise."""
    global LAUNCHES
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
    if tuple(dt.shape) != (bsz, s, h) or tuple(a_log.shape) != (h,) or \
            tuple(b.shape[:2]) != (bsz, s):
        raise ValueError(f"dt {tuple(dt.shape)}, a_log "
                         f"{tuple(a_log.shape)}, b {tuple(b.shape)} do not "
                         f"fit x {tuple(x.shape)}")
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
    if h_in is not None:
        _build.check_operand(h_in, "h_in", ndim=4, dtypes=f32)
        if tuple(h_in.shape) != (bsz, h, n, p) or h_in.device != x.device:
            raise ValueError(f"h_in {tuple(h_in.shape)} on {h_in.device} "
                             f"does not fit (B, H, N, P) = "
                             f"{(bsz, h, n, p)} on {x.device}")
    y = torch.empty_like(x)
    h_out = torch.empty((bsz, h, n, p), dtype=torch.float32,
                        device=x.device)
    if bsz * s * h == 0:
        return y, h_out.zero_() if h_in is None else h_out.copy_(h_in)
    nc = s // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    cb = torch.empty((bsz, nc, chunk, chunk), **f32)       # C . B^T
    states = torch.empty((bsz, nc, h, n, p), **f32)        # chunk states
    total = torch.empty((bsz, nc, h), **f32)               # cum at the end
    lib = _build.load("ssd_chunk")
    with torch.cuda.device(x.device):
        err = lib.ssd_chunk_launch(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), None if h_in is None else h_in.data_ptr(),
            cb.data_ptr(), states.data_ptr(), total.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), _build.FLOAT_DTYPES[x.dtype], bsz, s, h, p, n,
            chunk, _build.stream_of(x))
    _build.check(lib, err, "ssd_chunk")
    LAUNCHES += 1
    return y, h_out
