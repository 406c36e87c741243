"""Public decode-attention API (inference only; no backward), dispatched
through repro_torch.kernels.dispatch (counterpart of
repro/kernels/decode_attention/ops.py). k/v arrive in the kernel-native
(B, KVH, S, D) cache layout, the whole ring or a kv-head range of it (a
`narrow` along dim 1), which the kernel reads in place: nothing of the
ring is copied on the decode hot path. `decode_attention_partial` gives
a ring block's softmax partial (ref.decode_partial_ref) for split-K
decode over ranks; it is not a dispatch family of its own. The reference's `bk` tunable has no counterpart: the CUDA
kernel library plans its ring slices for the card (kernel.plan)."""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.decode_attention import kernel as K
from repro_torch.kernels.decode_attention import ref


def decode_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                     mode=None):
    """q: (B, KVH, G, D); k/v: (B, KVH, S, D); q_pos (B,); kv_pos (B, S)."""
    if not dispatch.resolve(mode, q):
        return ref.decode_ref(q, k, v, q_pos, kv_pos, window=window)
    return K.decode_attention_fwd(*_operands(q, k, v, q_pos, kv_pos),
                                  window=window)


def decode_attention_partial(q, k, v, q_pos, kv_pos, *, window: int = 0,
                             mode=None):
    """decode_attention over this block of the ring, unfolded: (out fp32,
    m, l), as ref.decode_partial_ref; kernel 10 in one launch on a CUDA
    tensor."""
    if not dispatch.resolve(mode, q):
        return ref.decode_partial_ref(q, k, v, q_pos, kv_pos, window=window)
    return K.decode_attention_fwd(*_operands(q, k, v, q_pos, kv_pos),
                                  window=window, partial=True)


def _operands(q, k, v, q_pos, kv_pos):
    """The kernel's operands: k and v as they are where the kernel reads
    them in place (K.ring_strides), else contiguous copies."""
    if K.ring_strides(k) is None or v.stride() != k.stride():
        k, v = k.contiguous(), v.contiguous()
    return (q.contiguous(), k, v, q_pos.to(torch.int32).contiguous(),
            kv_pos.to(torch.int32).contiguous())


def _example(rng):
    b, kvh, g, s, d = 2, 2, 2, 512, 64
    q = torch.from_numpy(rng.standard_normal((b, kvh, g, d),
                                             dtype="float32"))
    k = torch.from_numpy(rng.standard_normal((b, kvh, s, d),
                                             dtype="float32"))
    v = torch.from_numpy(rng.standard_normal((b, kvh, s, d),
                                             dtype="float32"))
    fill = int(0.75 * s)
    kv_pos = torch.where(torch.arange(s) < fill, torch.arange(s),
                         1 << 30).to(torch.int32).expand(b, s).contiguous()
    q_pos = torch.full((b,), fill, dtype=torch.int32)
    return (q, k, v, q_pos, kv_pos), {}


dispatch.register("decode_attention", fn=decode_attention,
                  ref=ref.decode_ref, example=_example)
