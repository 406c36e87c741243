"""Plain PyTorch version of the split-K decode attention kernel
(counterpart of repro/kernels/decode_attention/ref.py).

One query token per row against a ring-buffer KV cache in the
kernel-native (B, KVH, S, D) layout with a stored-position plane
(repro_torch.models.attention's cache layout): slots whose position
violates causality (or the sliding window, or were never written, at
INF_POS) are masked with the finite NEG_INF, so a row whose every slot is
masked averages V uniformly. float32 math, output in q's dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_ref(q, k, v, q_pos, kv_pos, *, window: int = 0):
    """q: (B, KVH, G, D); k/v: (B, KVH, S, D); q_pos: (B,);
    kv_pos: (B, S). Returns (B, KVH, G, D)."""
    d = q.shape[-1]
    s = torch.einsum("bkgd,bksd->bkgs", q.float() * d ** -0.5, k.float())
    dp = q_pos[:, None] - kv_pos                     # (B, S)
    ok = dp >= 0
    if window:
        ok &= dp < window
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", p, v.float()).to(q.dtype)
