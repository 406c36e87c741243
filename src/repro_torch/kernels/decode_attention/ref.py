"""Plain PyTorch version of the split-K decode attention kernel
(counterpart of repro/kernels/decode_attention/ref.py).

One query token per row against a ring-buffer KV cache in the
kernel-native (B, KVH, S, D) layout with a stored-position plane
(repro_torch.models.attention's cache layout): slots whose position
violates causality (or the sliding window, or were never written, at
INF_POS) are masked with the finite NEG_INF, so a row whose every slot is
masked averages V uniformly. float32 math, output in q's dtype.

`decode_partial_ref` is the same softmax over a block of the ring (a
rank's, where the ring is split over ranks): the normalised fp32 output
and the partial (m, l), the block's largest masked score and its sum of
exp(score - m). `combine_ref` folds the blocks' partials into the whole
ring's output: each block weighs l * exp(m - max m), so a block with no
valid slot (m = NEG_INF) weighs nothing beside one with a valid slot,
and a row masked in every block averages V over the whole ring, as
decode_ref does.
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


def decode_partial_ref(q, k, v, q_pos, kv_pos, *, window: int = 0):
    """decode_ref's softmax over this block of the ring, unfolded: returns
    (out, m, l), out (B, KVH, G, D) fp32 normalised over the block, m and
    l (B, KVH, G) fp32."""
    d = q.shape[-1]
    s = torch.einsum("bkgd,bksd->bkgs", q.float() * d ** -0.5, k.float())
    dp = q_pos[:, None] - kv_pos
    ok = dp >= 0
    if window:
        ok &= dp < window
    s = torch.where(ok[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l_ = p.sum(dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, v.float()) / l_[..., None]
    return out, m, l_


def combine_ref(out, m, l_, dim: int = 0):
    """The whole ring's normalised output (fp32) from the blocks' partials
    stacked along `dim` (decode_partial_ref's, one a block)."""
    w = l_ * torch.exp(m - m.amax(dim=dim, keepdim=True))
    return (out * w[..., None]).sum(dim=dim) / \
        w.sum(dim=dim).clamp_min(1e-30)[..., None]
