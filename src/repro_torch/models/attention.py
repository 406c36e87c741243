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

Over ranks (a step of repro_torch.launch.specs on a RankMesh) a rank
holds its block of each weight and ring: its heads, kv heads, batch rows
and ring slots. It takes its head counts from the blocks, projects its
heads' output row-parallel and sums the partial products over the ranks
that split the heads (repro_torch.dist.sharding.reduce_over). Where the
heads are split but the kv heads are not (their count does not divide the
axis), a rank's q heads read the kv heads they group with, a kv-head
range of its ring that kernel 10 reads in place. Under autograd x enters
the q/k/v projections through sharding.enter_over, so its gradient is
summed over the ranks that split the heads; where the kv heads are
whole, wk and wv enter so too, as each rank's gradient of them holds
only the kv heads its q heads read.

Sequence splits over ranks (the steps name the caches' shardings,
use_rules(rings=)):
- split-K decode, a ring whose slots ("kv_seq") are split: `fill_cache`
  writes a token only on the rank whose block holds its slot, in each
  ring leaf by that leaf's own split (pos, which has no kv-head dim, may
  be split further than k and v; a rank then gathers the int32 pos
  entries of the slots its k holds). A decode step computes each head's
  softmax partial over the rank's block (kernel 10's partial entry under
  "flash", ref.decode_partial_ref otherwise) and combines them over the
  split's ranks (sharding.combine_over); where the heads are split over
  the same axes, a rank first gathers the token's q of every head and
  keeps its own heads' output. No rank gathers a K/V ring leaf.
- context parallelism, where the rules split q's "cp_seq" dim (the cp
  strategy, K/V whole on every rank: "kv_full"): a rank attends only its
  rows [r S/n, (r + 1) S/n) against the K/V prefix [0, (r + 1) S/n) (kernel
  11 aligns q to the end of K/V) and the output is gathered over those
  axes (gather_over; its adjoint is the slice). Under autograd x, wq, wk
  and wv enter through enter_over, as each rank's gradient holds only its
  rows' part.
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist import sharding as shlib
from repro_torch.dist.sharding import logical_constraint
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.common import Params, apply_rope, dense_init

NEG_INF = -1e30
INF_POS = 1 << 30    # "never written" marker in the pos plane


class Attention(Params):
    AXES = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}

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
    block_kv = min(block_kv, skv)          # the last block may be short
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
    """The heads' output through wo: over ranks that split the heads, this
    rank's heads' partial product summed over them."""
    wo = params["wo"]
    o = o.reshape(b, sq, wo.shape[0], cfg.resolved_head_dim).to(dtype)
    out = torch.einsum("bsnh,nhd->bsd", o, wo)
    return shlib.reduce_over(out, shlib.split_axes(wo, 0))


def _kv_heads_of(wq, wk, cfg) -> tuple:
    """(first, count) of the kv heads this rank's q heads group with,
    within the kv heads it holds: all of them unless the heads are split
    over ranks and the kv heads are not, when q heads [r Hl, (r + 1) Hl)
    read kv heads from r Hl / G, G = H / KVH."""
    nh, kvh = wq.shape[1], wk.shape[1]
    heads, kv = shlib.split_axes(wq, 1), shlib.split_axes(wk, 1)
    if kv and not heads:
        raise NotImplementedError(
            f"kv heads split over {kv} with the q heads whole")
    if not heads or kv:
        return 0, kvh
    g = cfg.num_heads // cfg.num_kv_heads
    if nh % g and g % nh:
        raise NotImplementedError(
            f"{nh} q heads a rank in groups of {g}: a rank's heads must "
            f"hold whole groups or lie in one")
    return shlib.block_start(wq, 1) // g, max(1, nh // g)


def _kv_slice(t, lo: int, n: int, dim: int):
    """kv heads [lo, lo + n) of `t` along `dim`; `t` itself when that is
    all of them, so the whole-heads path runs no extra op (the dry run's
    tracer and remat's policies see every op)."""
    return t if (lo, n) == (0, t.shape[dim]) else t.narrow(dim, lo, n)


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
    hd = cfg.resolved_head_dim
    wq, wk, wv = params["wq"], params["wk"], params["wv"]
    kv_lo, kvh = _kv_heads_of(wq, wk, cfg)     # this rank's heads
    group = wq.shape[1] // kvh
    heads = shlib.split_axes(wq, 1)
    h0, nh = shlib.block_start(wq, 1), wq.shape[1]
    # context parallelism: the axes that split q's rows (cp_seq)
    cp = shlib.constraint_axes((b, sq, kvh, group, hd), _Q_AXES, 1)
    if cp and heads:
        raise NotImplementedError(f"q's rows split over {cp} beside its "
                                  f"heads over {heads}")
    x = shlib.enter_over(x, heads + cp)
    if heads and not shlib.split_axes(wk, 1):
        wk, wv = shlib.enter_over(wk, heads), shlib.enter_over(wv, heads)
    if cp:
        wq, wk, wv = (shlib.enter_over(w, cp) for w in (wq, wk, wv))

    q = torch.einsum("bsd,dnh->bsnh", x, wq)
    k = torch.einsum("bsd,dnh->bsnh", x, wk)
    del wq, wk
    v = torch.einsum("bsd,dnh->bsnh", x, wv)
    del wv
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = q.reshape(b, sq, kvh, group, hd)
    # context-parallel hooks: "cp_seq"/"kv_full" are absent from the default
    # rules (no-ops); the cp strategy defines them so q stays seq-sharded
    # while K/V replicate over the model axis
    q = logical_constraint(q, _Q_AXES)
    k = logical_constraint(k, (None, "kv_full", None, None))
    v = logical_constraint(v, (None, "kv_full", None, None))

    if kv_cache is None or sq > 1:
        # train / prefill: attend over the segment's own K/V; the ring is
        # written out of band
        ks, vs = _kv_slice(k, kv_lo, kvh, 2), _kv_slice(v, kv_lo, kvh, 2)
        if cp:
            o = _attend_rows(q, ks, vs, positions, window, impl, cp)
        else:
            o = _run(q, ks, vs, positions, positions, window, impl)
        new_cache = (fill_cache(kv_cache, k, v, positions)
                     if kv_cache is not None else (k, v))
        return _project_out(params, o, b, sq, cfg, x.dtype), new_cache

    new_cache = fill_cache(kv_cache, k, v, positions)
    seq = shlib.split_axes(new_cache["k"], 2)
    pos = _ring_pos(new_cache)
    if seq:
        o = _split_k(q[:, 0], new_cache, positions[:, 0], pos, window, impl,
                     seq, heads, (kv_lo, kvh), (h0, nh))
        return _project_out(params, o[:, None], b, sq, cfg, x.dtype), \
            new_cache
    ring_k = _kv_slice(new_cache["k"], kv_lo, kvh, 1)
    ring_v = _kv_slice(new_cache["v"], kv_lo, kvh, 1)
    if impl == "flash":
        # one-token decode goes to the split-K kernel (ring-buffer aware
        # via the stored-pos plane); the ring is already in its layout
        o = dec_ops.decode_attention(
            q[:, 0], ring_k, ring_v, positions[:, 0], pos,
            window=window)[:, None]    # (B,1,KV,G,H)
        return _project_out(params, o, b, sq, cfg, x.dtype), new_cache
    o = _run(q, ring_k.transpose(1, 2), ring_v.transpose(1, 2), positions,
             pos, window, impl)
    return _project_out(params, o, b, sq, cfg, x.dtype), new_cache


_Q_AXES = (None, "cp_seq", None, None, None)


def _attend_rows(q, k, v, positions, window, impl, cp):
    """Context parallelism: this rank's block of q's rows [lo, hi) (its
    block over the `cp` axes) against the K/V prefix [0, hi), whose
    relative positions are the whole sequence's (kernel 11 aligns q to
    the end of K/V), gathered over `cp` to every row."""
    sq = q.shape[1]
    mesh = shlib.current_rules()[0]
    rows = sq // math.prod(mesh.shape[a] for a in cp)
    lo = mesh.block_index(cp) * rows
    hi = lo + rows
    o = _run(q[:, lo:hi], k[:, :hi], v[:, :hi], positions[:, lo:hi],
             positions[:, :hi], window, impl)
    return shlib.gather_over(o, 1, cp)


def _ring_pos(cache):
    """The pos entries of the ring slots this rank's k holds: the pos
    block itself, or, where pos is split over more axes than k (k's
    kv-head dim took an axis that pos, without one, gives to its slots),
    the pos blocks gathered over those axes. They travel as the bits of
    float32, as the ranks gather only float tensors."""
    pos = cache["pos"]
    extra = tuple(a for a in shlib.split_axes(pos, 1)
                  if a not in shlib.split_axes(cache["k"], 2))
    if not extra:
        return pos
    return shlib.gather_over(pos.view(torch.float32), 1, extra).view(
        pos.dtype)


def _split_k(q, cache, q_pos, pos, window, impl, seq, heads, kv, qh):
    """One-token decode over a ring whose slots are split over the mesh
    axes `seq`: each head's softmax partial over this rank's block,
    combined over `seq`. q (B, KVH', G', D) holds this rank's heads
    [h0, h0 + nh) (`qh`), grouped with kv heads [kv_lo, kv_lo + KVH')
    (`kv`) of the ring; where `heads` splits them over axes of `seq`, the
    token's q is gathered over those axes first and this rank keeps its
    own heads of the combined output. Returns (B, KVH', G', D) fp32."""
    b, _, _, d = q.shape
    ring_k, ring_v = cache["k"], cache["v"]
    shared = tuple(a for a in heads if a in seq)
    if shared:
        if shared != tuple(heads) or shlib.split_axes(ring_k, 1):
            raise NotImplementedError(
                f"heads split over {heads}, ring slots over {seq} and kv "
                f"heads over {shlib.split_axes(ring_k, 1)}")
        q = shlib.gather_over(q.reshape(b, -1, d), 1, shared)
        q = q.reshape(b, ring_k.shape[1], -1, d)
    else:
        ring_k = _kv_slice(ring_k, kv[0], kv[1], 1)
        ring_v = _kv_slice(ring_v, kv[0], kv[1], 1)
    if impl == "flash":
        o, m, l_ = dec_ops.decode_attention_partial(
            q, ring_k, ring_v, q_pos, pos, window=window)
    else:
        o, m, l_ = dec_ref.decode_partial_ref(q, ring_k, ring_v, q_pos, pos,
                                              window=window)
    o = shlib.combine_over(o, m, l_, seq)
    if shared:
        o = o.reshape(b, -1, d).narrow(1, qh[0], qh[1])
    return o


def _ring_block(t, dim: int):
    """(first global slot, slots) of this rank's block of ring leaf `t`
    along its kv_seq dim `dim`, and the ring's global size."""
    n = t.shape[dim]
    axes = shlib.split_axes(t, dim)
    if not axes:
        return 0, n, n
    mesh = shlib.ring_sharding(t).mesh
    return shlib.block_start(t, dim), n, \
        n * math.prod(mesh.shape[a] for a in axes)


def _write_slots(leaf, dim: int, slots, values):
    """Write `values` (B, Sq, ...) at the global ring slots `slots` (B,
    Sq; distinct within a row) of ring leaf `leaf`, whose slots lie along
    `dim`, in place; a rank whose block holds only some of the slots
    writes those. With one token a row the others rewrite their row's
    first local slot with itself, so no index leaves the device."""
    lo, n, size = _ring_block(leaf, dim)
    ring = leaf.movedim(dim, 1)                         # (B, n, ...)
    values = values.to(leaf.dtype)
    rows = torch.arange(slots.shape[0], device=slots.device)[:, None]
    rows = rows.expand_as(slots)
    local = slots - lo
    if n < size:
        keep = (local >= 0) & (local < n)
        if slots.shape[1] == 1:
            local = torch.where(keep, local, 0)
            keep = keep.view(keep.shape + (1,) * (values.dim() - 2))
            values = torch.where(keep, values, ring[rows, local])
        else:
            rows, local, values = rows[keep], local[keep], values[keep]
    ring[rows, local] = values


def fill_cache(cache, k, v, positions):
    """Write K/V at ring slots position % size (the last `size` of the
    segment if it is longer than the ring), in place; returns `cache`.

    k/v arrive in model layout (B, Sq, KVH, D); only this segment is
    transposed into the ring's kernel-native (B, KVH, S, D) layout. The
    write is in place, so it refuses to run under autograd: training
    passes no caches. Where a ring leaf's slots are split over ranks
    (use_rules(rings=)), each rank writes only the slots of its block of
    that leaf."""
    if torch.is_grad_enabled() and (k.requires_grad or v.requires_grad):
        raise RuntimeError("fill_cache writes the ring in place; run "
                           "decode and cached prefill under "
                           "torch.no_grad() (training passes caches=None)")
    size = _ring_block(cache["pos"], 1)[2]
    if k.shape[1] > size:
        k, v, positions = k[:, -size:], v[:, -size:], positions[:, -size:]
    slots = (positions % size).long()                   # (B, Sq)
    _write_slots(cache["k"], 2, slots, k)
    _write_slots(cache["v"], 2, slots, v)
    _write_slots(cache["pos"], 1, slots, positions)
    return cache


CACHE_AXES = {"k": ("batch", "kv_heads", "kv_seq", "head_dim"),
              "v": ("batch", "kv_heads", "kv_seq", "head_dim"),
              "pos": ("batch", "kv_seq")}
# what a fresh ring holds where not zero: every slot never written
CACHE_FILL = {"pos": INF_POS}


def init_cache(cfg, batch: int, size: int, dtype, device) -> dict:
    shape = (batch, cfg.num_kv_heads, size, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, size), CACHE_FILL["pos"],
                              dtype=torch.int32, device=device)}
