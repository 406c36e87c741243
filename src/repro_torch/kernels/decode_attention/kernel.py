"""ctypes wrapper of the CUDA split-K decode attention kernel
(csrc/decode_attention.cu), counterpart of
repro/kernels/decode_attention/kernel.py::decode_attention_fwd.

One launch a call. The kernel library plans the call (`plan`: the splits
of a row, from the card's SM count and the blocks an SM holds, the tile
size and the scratch's size), and each block plans its own tiles from the
positions (`tile_plan` is the plain version of that). The wrapper keeps
one zero-filled scratch per (device, stream, shape) for the partials and
the per-row tickets, which every call leaves zero again; a call captured
in a CUDA graph gets a scratch of its own."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0   # wrapper calls that launched the kernel (one launch each)

HEAD_DIMS = (32, 64, 128, 256)   # head dims the kernel is instantiated for

_PLANS: dict[tuple, tuple[int, int, int, int]] = {}
_SCRATCH: dict[tuple, torch.Tensor] = {}


def plan(lib, key: tuple) -> tuple[int, int, int, int]:
    """(splits of a row, ring slots a tile, rows, scratch fp32 words) of a
    call of key = (device index, dtype code, B, KVH, G, S, D), as the
    kernel library plans it on the current device (one row, and one
    ticket, a (b, kv head, group of query heads)); asked once a key."""
    got = _PLANS.get(key)
    if got is None:
        out = (ctypes.c_longlong * 4)()
        _build.check(lib, lib.decode_attention_plan(*key[1:], out),
                     "decode_attention (plan)")
        got = _PLANS[key] = tuple(int(x) for x in out)
    return got


def tile_plan(kv_pos: torch.Tensor, q_pos: torch.Tensor, window: int,
              tile: int, splits: int):
    """Plain version of the plan each block of the kernel makes: for each
    batch row, the ring tiles (of `tile` slots) that each split reads.
    The splits divide the tiles from the row's first to its last valid
    slot; a tile with no valid slot is not read. A row with no valid slot
    reads every tile (for V only: its output is the uniform average).
    Returns (reads (B, splits, n_tiles) bool, any (B,) bool)."""
    b, s = kv_pos.shape
    dp = q_pos.to(kv_pos.device)[:, None].long() - kv_pos.long()
    ok = dp >= 0
    if window:
        ok &= dp < window
    n_tiles = -(-s // tile)
    idx = torch.arange(s, device=kv_pos.device)
    any_ = ok.any(dim=1)
    first = torch.where(ok, idx, s).amin(dim=1)
    last = torch.where(ok, idx, -1).amax(dim=1)
    t_lo = torch.where(any_, first // tile, 0)
    t_hi = torch.where(any_, last // tile, n_tiles - 1)
    per = (t_hi - t_lo + splits) // splits
    lo = t_lo[:, None] + torch.arange(splits, device=kv_pos.device) \
        * per[:, None]
    hi = torch.minimum(t_hi[:, None] + 1, lo + per[:, None])
    t = torch.arange(n_tiles, device=kv_pos.device)
    mine = (t >= lo[..., None]) & (t < hi[..., None])
    padded = torch.zeros((b, n_tiles * tile), dtype=torch.bool,
                         device=kv_pos.device)
    padded[:, :s] = ok
    needed = padded.view(b, n_tiles, tile).any(dim=2) | ~any_[:, None]
    return mine & needed[:, None, :], any_


def _scratch(device, stream: int, key: tuple, floats: int,
             capturing: bool) -> torch.Tensor:
    """The zero-filled scratch of one (device, stream, shape): allocated at
    the first call; the kernel leaves its tickets zero. A call being
    captured in a CUDA graph gets a scratch of its own, zeroed by a fill
    captured with it: it comes from the graph's private memory pool, so no
    eager call shares its tickets, whatever stream a replay runs on, and
    every replay zeroes it again before the kernel."""
    if capturing:
        return torch.zeros(floats, dtype=torch.float32, device=device)
    full = (device, stream, key)
    buf = _SCRATCH.get(full)
    if buf is None:
        buf = _SCRATCH[full] = torch.zeros(floats, dtype=torch.float32,
                                           device=device)
    return buf


def ring_strides(k: torch.Tensor) -> int | None:
    """The elements between two batch rows of `k` (B, KVH, S, D) when the
    kernel reads it in place: each kv head's S * D elements contiguous and
    one after another, the batch rows 16-byte aligned apart, as a whole
    ring, or a kv-head range of one (a `narrow` along dim 1), lies. None
    for any other layout (the op makes such a tensor contiguous)."""
    b, kvh, s, d = k.shape
    if k.stride(3) != 1 or (s > 1 and k.stride(2) != d) or \
            (kvh > 1 and k.stride(1) != s * d):
        return None
    if b == 1:
        return kvh * s * d
    bs = k.stride(0)
    if bs < kvh * s * d or (bs * k.element_size()) % 16:
        return None
    return bs


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                         window: int = 0,
                         copied_bytes: torch.Tensor | None = None,
                         partial: bool = False):
    """q (B, KVH, G, D) contiguous, k/v (B, KVH, S, D) float32 or bfloat16
    CUDA tensors of one dtype, q_pos (B,) and kv_pos (B, S) int32 ->
    (B, KVH, G, D) in q's dtype. K and V are read in place where
    `ring_strides` gives their batch stride (a whole ring, or a kv-head
    range of one) and must have equal strides. With `partial`, returns
    (out fp32, m, l), m and l (B, KVH, G) fp32: each row's largest masked
    score and its sum of exp(score - m), the softmax partial of this ring
    (block) that ref.combine_ref folds with others. Launches once on the
    current stream and does not synchronise; calls may be captured in a
    CUDA graph. With `copied_bytes`, an int64 tensor of one element on
    q's device, the kernel adds to it the bytes of the K and V copies it
    issued."""
    global LAUNCHES
    dtypes = tuple(_build.FLOAT_DTYPES)
    _build.check_operand(q, "q", ndim=4, dtypes=dtypes)
    for name, t in (("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, "
                             f"got one on {t.device}")
        if t.dtype not in dtypes or t.dim() != 4:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}; expected "
                             f"a 4-D operand of one of {dtypes}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned (the kernels "
                             f"load 16 bytes at a time)")
    _build.check_operand(q_pos, "q_pos")
    _build.check_operand(kv_pos, "kv_pos", ndim=2)
    b, kvh, g, d = q.shape
    s = k.shape[2]
    if k.dtype != q.dtype or k.device != q.device or \
            tuple(k.shape) != (b, kvh, s, d):
        raise ValueError(f"k {k.dtype} {tuple(k.shape)} does not fit q "
                         f"{q.dtype} {tuple(q.shape)}")
    if v.dtype != k.dtype or v.device != k.device or v.shape != k.shape \
            or v.stride() != k.stride():
        raise ValueError(f"v {v.dtype} {tuple(v.shape)} {v.stride()} does "
                         f"not match k {k.dtype} {tuple(k.shape)} "
                         f"{k.stride()}")
    kv_bs = ring_strides(k)
    if kv_bs is None:
        raise ValueError(f"k/v strides {k.stride()} of {tuple(k.shape)}: "
                         f"the kernel reads a ring or a kv-head range of "
                         f"one")
    if tuple(q_pos.shape) != (b,) or tuple(kv_pos.shape) != (b, s) or \
            q_pos.device != q.device or kv_pos.device != q.device:
        raise ValueError(f"q_pos {tuple(q_pos.shape)} / kv_pos "
                         f"{tuple(kv_pos.shape)} do not fit B={b}, S={s}")
    if copied_bytes is not None and (
            copied_bytes.dtype != torch.int64 or copied_bytes.numel() != 1
            or copied_bytes.device != q.device):
        raise ValueError("copied_bytes must be one int64 on q's device")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}; the kernel is built for "
                         f"{HEAD_DIMS}")
    if s == 0:
        raise ValueError("empty ring (S = 0)")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if partial:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        l_ = torch.empty_like(m)
    else:
        out, m, l_ = torch.empty_like(q), None, None
    if out.numel() == 0:
        return (out, m, l_) if partial else out
    code = _build.FLOAT_DTYPES[q.dtype]
    lib = _build.load("decode_attention")
    key = (q.get_device(), code, b, kvh, g, s, d)
    splits, _, _, floats = _PLANS.get(key) or \
        _build.call_on(q, plan, lib, key)
    stream = _build.stream_of(q)
    scratch = _scratch(q.device, stream, key, floats,
                       torch.cuda.is_current_stream_capturing())
    err = _build.call_on(
        q, lib.decode_attention_launch, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        scratch.data_ptr(),
        None if copied_bytes is None else copied_bytes.data_ptr(),
        out.data_ptr(), None if m is None else m.data_ptr(),
        None if l_ is None else l_.data_ptr(), code, b, kvh, g, s, d,
        kv_bs, splits, int(window), stream)
    _build.check(lib, err, "decode_attention")
    LAUNCHES += 1
    return (out, m, l_) if partial else out
