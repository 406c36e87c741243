"""ctypes wrapper of the CUDA flash attention kernel
(csrc/flash_attention.cu), counterpart of
repro/kernels/flash_attention/kernel.py::flash_attention_fwd."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0   # wrapper calls that launched the kernel (one launch each)

HEAD_DIMS = (32, 64, 128, 256)   # head dims the kernel is instantiated for
ROUTES = ("cuda_core", "wgmma")  # the launch's route code is the index


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel's route at head dim d (one of HEAD_DIMS): "wgmma"
    (flash_wgmma_kernel, TMA and the tensor cores) for bfloat16 at every
    head dim; "cuda_core" (flash_fwd_kernel) for float32, whose tolerance
    the tensor cores' bf16 or TF32 inputs would not meet."""
    return "wgmma" if dtype == torch.bfloat16 else "cuda_core"


def check_route(q: torch.Tensor, way: str | None) -> str:
    """The route a call takes: `way` None takes route(); "cuda_core"
    forces the CUDA-core kernel at any dtype (for measurement). Raise
    ValueError for a head dim the kernel is not built for or a way the
    dtype does not take (before any device check)."""
    if q.dim() != 5:
        raise ValueError(f"q {tuple(q.shape)} must be (B, KVH, G, Sq, D)")
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}; the kernel is built for "
                         f"{HEAD_DIMS}")
    chosen = route(q.dtype, d)
    if way not in (None, chosen, "cuda_core"):
        raise ValueError(f"route {way!r}: {q.dtype} at head dim {d} takes "
                         f"{chosen!r} or 'cuda_core'")
    return way or chosen


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, way: str | None = None
                        ) -> torch.Tensor:
    """q (B, KVH, G, Sq, D), k/v (B, KVH, Skv, D), contiguous float32 or
    bfloat16 CUDA tensors of one dtype, Sq <= Skv -> (B, KVH, G, Sq, D) in
    q's dtype: causal (optionally sliding-window) attention with the query
    rows aligned to the suffix of the context. `way` as check_route takes
    it. Launches on the current stream and does not synchronise."""
    global LAUNCHES
    way = check_route(q, way)
    dtypes = tuple(_build.FLOAT_DTYPES)
    _build.check_operand(q, "q", ndim=5, dtypes=dtypes)
    _build.check_operand(k, "k", ndim=4, dtypes=dtypes)
    _build.check_operand(v, "v", like=k, ndim=4, dtypes=dtypes)
    b, kvh, g, sq, d = q.shape
    skv = k.shape[2]
    if k.dtype != q.dtype or k.device != q.device or \
            tuple(k.shape) != (b, kvh, skv, d):
        raise ValueError(f"k {k.dtype} {tuple(k.shape)} does not fit q "
                         f"{q.dtype} {tuple(q.shape)}")
    if sq > skv:
        raise ValueError(f"Sq {sq} > Skv {skv}: prefill query rows are the "
                         f"last Sq of the context")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention")
    err = _build.call_on(
        q, lib.flash_attention_launch, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), _build.FLOAT_DTYPES[q.dtype], b, kvh,
        g, sq, skv, d, int(window), ROUTES.index(way), _build.stream_of(q))
    _build.check(lib, err, "flash_attention")
    LAUNCHES += 1
    return out
