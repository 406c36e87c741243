"""GQA attention: full/causal, sliding-window, and KV-cache decode paths
(counterpart of repro/models/attention.py).

Three implementations share one math definition (the tests hold them to
the reference and to each other):
- "naive": materializes (B, KV, G, Sq, Skv) scores — small shapes.
- "blockwise": a loop over KV blocks with online softmax in plain torch.
- "flash": the CUDA kernels (repro_torch.kernels.flash_attention for
  prefill, .decode_attention for one-token decode); on CPU tensors their
  plain versions. "auto" picks naive or blockwise by size, never flash:
  only attn_impl="flash" reaches the kernels, as in the reference.

Decode caches are ring buffers {k, v, pos}: slot = position % size, with
the stored-position plane driving the causal/window mask (slots never
written hold pos = INF_POS and are therefore masked). K/V are stored in
the kernel-native (B, KVH, S, D) layout, so a decode step hands the ring to
the kernel as it is; only the new token is transposed on write. Unlike the
reference, which returns a new ring, `fill_cache` writes the ring in place
and returns the same dict: a copy of a multi-GiB ring every step is what
the reference's functional update leaves XLA to elide.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.common import Params, apply_rope, dense_init

NEG_INF = -1e30
INF_POS = 1 << 30    # "never written" marker in the pos plane


class Attention(Params):
    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def init(cfg, dtype, generator: torch.Generator) -> Attention:
    hd = cfg.resolved_head_dim
    return Attention(
        wq=dense_init((cfg.d_model, cfg.num_heads, hd), dtype, generator),
        wk=dense_init((cfg.d_model, cfg.num_kv_heads, hd), dtype, generator),
        wv=dense_init((cfg.d_model, cfg.num_kv_heads, hd), dtype, generator),
        wo=dense_init((cfg.num_heads, hd, cfg.d_model), dtype, generator,
                      scale=1.0 / (hd * cfg.num_heads) ** 0.5))


def _mask(q_pos, kv_pos, window: int):
    """(B, Sq, Skv) additive mask: causal, optionally sliding-window."""
    d = q_pos[:, :, None] - kv_pos[:, None, :]
    ok = d >= 0
    if window:
        ok &= d < window
    return torch.where(ok, 0.0, NEG_INF).float()


def _gqa_scores(q, k):
    """q: (B,Sq,Kv,G,H), k: (B,Skv,Kv,H) -> (B,Kv,G,Sq,Skv) fp32 scores."""
    return torch.einsum("bskgh,btkh->bkgst", q.float(), k.float())


def _naive(q, k, v, q_pos, kv_pos, window):
    scale = q.shape[-1] ** -0.5
    s = _gqa_scores(q * scale, k)
    s = s + _mask(q_pos, kv_pos, window)[:, None, None]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype), v)


def _blockwise(q, k, v, q_pos, kv_pos, window, block_kv: int = 1024):
    """Online softmax over KV blocks; O(Sq * block) live memory."""
    skv = k.shape[1]
    block_kv = min(block_kv, skv)
    assert skv % block_kv == 0, (skv, block_kv)
    qs = q * q.shape[-1] ** -0.5
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    for lo in range(0, skv, block_kv):
        kc, vc = k[:, lo:lo + block_kv], v[:, lo:lo + block_kv]
        pc = kv_pos[:, lo:lo + block_kv]
        s = _gqa_scores(qs, kc)                              # (B,Kv,G,Sq,Bk)
        s = s + _mask(q_pos, pc, window)[:, None, None]
        s = s.movedim(3, 1)                                  # (B,Sq,Kv,G,Bk)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        upd = torch.einsum("bskgt,btkh->bskgh", p.to(vc.dtype), vc)
        acc = acc * alpha[..., None] + upd.float()
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _run(q, k, v, q_pos, kv_pos, window, impl):
    sq, skv = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "naive" if sq * skv <= 1024 * 1024 else "blockwise"
    if impl == "flash":
        return flash_ops.flash_attention(q, k, v, q_pos, kv_pos,
                                         window=window)
    if impl == "blockwise":
        return _blockwise(q, k, v, q_pos, kv_pos, window)
    return _naive(q, k, v, q_pos, kv_pos, window)


def _project_out(params, o, b, sq, cfg, dtype):
    o = o.reshape(b, sq, cfg.num_heads, cfg.resolved_head_dim).to(dtype)
    return torch.einsum("bsnh,nhd->bsd", o, params["wo"])


def attend(params, x, positions, cfg, *, window: int = 0, impl: str = "auto",
           kv_cache=None):
    """Unified attention.

    - full/prefill: kv_cache None — self-attention over x; returns
      (out, (k, v)). With a cache and Sq > 1 (prefill into a cache) the
      segment attends over its own K/V and is written into the ring.
    - decode: kv_cache = ring buffer dict; positions (B, Sq) absolute.
      Returns (out, cache), the cache written in place.
    """
    b, sq, _ = x.shape
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    group = cfg.num_heads // kvh

    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"])
    k = torch.einsum("bsd,dnh->bsnh", x, params["wk"])
    v = torch.einsum("bsd,dnh->bsnh", x, params["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = q.reshape(b, sq, kvh, group, hd)

    if kv_cache is None or sq > 1:
        # train / prefill: attend over the segment's own K/V; the ring is
        # written out of band
        o = _run(q, k, v, positions, positions, window, impl)
        new_cache = (fill_cache(kv_cache, k, v, positions)
                     if kv_cache is not None else (k, v))
        return _project_out(params, o, b, sq, cfg, x.dtype), new_cache

    new_cache = fill_cache(kv_cache, k, v, positions)
    if impl == "flash":
        # one-token decode goes to the split-K kernel (ring-buffer aware
        # via the stored-pos plane); the ring is already in its layout
        o = dec_ops.decode_attention(
            q[:, 0], new_cache["k"], new_cache["v"], positions[:, 0],
            new_cache["pos"], window=window)[:, None]    # (B,1,KV,G,H)
        return _project_out(params, o, b, sq, cfg, x.dtype), new_cache
    o = _run(q, new_cache["k"].transpose(1, 2),
             new_cache["v"].transpose(1, 2), positions, new_cache["pos"],
             window, impl)
    return _project_out(params, o, b, sq, cfg, x.dtype), new_cache


def fill_cache(cache, k, v, positions):
    """Write K/V at ring slots position % size (the last `size` of the
    segment if it is longer than the ring), in place; returns `cache`.

    k/v arrive in model layout (B, Sq, KVH, D); only this segment is
    transposed into the ring's kernel-native (B, KVH, S, D) layout. The
    write is in place, so it refuses to run under autograd: training
    passes no caches."""
    if torch.is_grad_enabled() and (k.requires_grad or v.requires_grad):
        raise RuntimeError("fill_cache writes the ring in place; run "
                           "decode and cached prefill under "
                           "torch.no_grad() (training passes caches=None)")
    size = cache["k"].shape[2]
    if k.shape[1] > size:
        k, v, positions = k[:, -size:], v[:, -size:], positions[:, -size:]
    b, kvh = k.shape[0], k.shape[2]
    dev = cache["k"].device
    slots = (positions % size).long()                   # (B, Sq)
    bidx = torch.arange(b, device=dev)[:, None, None]   # (B, 1, 1)
    hidx = torch.arange(kvh, device=dev)[None, :, None]  # (1, KVH, 1)
    sidx = slots[:, None, :]                             # (B, 1, Sq)
    dt = cache["k"].dtype
    cache["k"][bidx, hidx, sidx] = k.transpose(1, 2).to(dt)
    cache["v"][bidx, hidx, sidx] = v.transpose(1, 2).to(dt)
    cache["pos"][torch.arange(b, device=dev)[:, None], slots] = \
        positions.to(cache["pos"].dtype)
    return cache


def init_cache(cfg, batch: int, size: int, dtype, device) -> dict:
    shape = (batch, cfg.num_kv_heads, size, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, size), INF_POS, dtype=torch.int32,
                              device=device)}
