"""ctypes wrapper of the CUDA flash attention kernel
(csrc/flash_attention.cu), counterpart of
repro/kernels/flash_attention/kernel.py::flash_attention_fwd."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0   # wrapper calls that launched the kernel (one launch each)

HEAD_DIMS = (32, 64, 128, 256)   # head dims the kernel is instantiated for


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0) -> torch.Tensor:
    """q (B, KVH, G, Sq, D), k/v (B, KVH, Skv, D), contiguous float32 or
    bfloat16 CUDA tensors of one dtype, Sq <= Skv -> (B, KVH, G, Sq, D) in
    q's dtype: causal (optionally sliding-window) attention with the query
    rows aligned to the suffix of the context. Launches on the current
    stream and does not synchronise."""
    global LAUNCHES
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
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}; the kernel is built for "
                         f"{HEAD_DIMS}")
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
        g, sq, skv, d, int(window), _build.stream_of(q))
    _build.check(lib, err, "flash_attention")
    LAUNCHES += 1
    return out
