"""Plain PyTorch version of the flash attention kernel (counterpart of
repro/kernels/flash_attention/ref.py).

Layout (kernel-native): q (B, KVH, G, Sq, D), k/v (B, KVH, Skv, D).
Positions are arange (prefill semantics), the Sq query rows aligned to the
suffix of the Skv context; the mask is causal with an optional sliding
window. Scores, softmax and the PV product run in float32; the output is
cast back to q's dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, window: int = 0):
    sq, d = q.shape[3], q.shape[4]
    skv = k.shape[2]
    s = torch.einsum("bkgqd,bktd->bkgqt", q.float() * d ** -0.5, k.float())
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    dpos = q_pos - kv_pos
    ok = dpos >= 0
    if window:
        ok &= dpos < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqt,bktd->bkgqd", p, v.float()).to(q.dtype)
