"""ctypes wrapper of the CUDA split-K decode attention kernel
(csrc/decode_attention.cu), counterpart of
repro/kernels/decode_attention/kernel.py::decode_attention_fwd."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0   # wrapper calls that launched the kernel (a partial and a
               # combine launch each; not op calls)

HEAD_DIMS = (32, 64, 128, 256)   # head dims the kernel is instantiated for
BLOCKS_PER_SM = 4                # splits aim at this many blocks an SM
MIN_SPLIT = 64                   # ring slots a split covers at least


def heads_per_block(g: int) -> int:
    """The kernel's query heads a block (1, 2, 4 or 8; larger G takes
    several z-slices)."""
    return next(gm for gm in (1, 2, 4, 8) if g <= gm or gm == 8)


def n_splits(b: int, kvh: int, g: int, s: int, device) -> int:
    """Ring slices a (b, kv head) row is cut into: enough blocks to give
    every SM BLOCKS_PER_SM, each slice at least MIN_SPLIT slots."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = b * kvh * -(-g // heads_per_block(g))
    want = -(-BLOCKS_PER_SM * sms // rows)
    return max(1, min(want, -(-s // MIN_SPLIT)))


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                         window: int = 0) -> torch.Tensor:
    """q (B, KVH, G, D), k/v (B, KVH, S, D) contiguous float32 or bfloat16
    CUDA tensors of one dtype, q_pos (B,) and kv_pos (B, S) int32 ->
    (B, KVH, G, D) in q's dtype. Launches on the current stream and does
    not synchronise."""
    global LAUNCHES
    dtypes = tuple(_build.FLOAT_DTYPES)
    _build.check_operand(q, "q", ndim=4, dtypes=dtypes)
    _build.check_operand(k, "k", ndim=4, dtypes=dtypes)
    _build.check_operand(v, "v", like=k, ndim=4, dtypes=dtypes)
    _build.check_operand(q_pos, "q_pos")
    _build.check_operand(kv_pos, "kv_pos", ndim=2)
    b, kvh, g, d = q.shape
    s = k.shape[2]
    if k.dtype != q.dtype or k.device != q.device or \
            tuple(k.shape) != (b, kvh, s, d):
        raise ValueError(f"k {k.dtype} {tuple(k.shape)} does not fit q "
                         f"{q.dtype} {tuple(q.shape)}")
    if tuple(q_pos.shape) != (b,) or tuple(kv_pos.shape) != (b, s) or \
            q_pos.device != q.device or kv_pos.device != q.device:
        raise ValueError(f"q_pos {tuple(q_pos.shape)} / kv_pos "
                         f"{tuple(kv_pos.shape)} do not fit B={b}, S={s}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}; the kernel is built for "
                         f"{HEAD_DIMS}")
    if s == 0:
        raise ValueError("empty ring (S = 0)")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    splits = n_splits(b, kvh, g, s, q.device)
    part_ml = torch.empty((b * kvh, splits, g, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b * kvh, splits, g, d), dtype=torch.float32,
                           device=q.device)
    lib = _build.load("decode_attention")
    with torch.cuda.device(q.device):
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
            out.data_ptr(), _build.FLOAT_DTYPES[q.dtype], b, kvh, g, s, d,
            splits, int(window), _build.stream_of(q))
    _build.check(lib, err, "decode_attention")
    LAUNCHES += 1
    return out
