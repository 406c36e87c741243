"""Residual decoder blocks: norm -> mixer -> residual [-> norm -> ffn/moe]
(counterpart of repro/models/blocks.py).

Block kinds: "attn" (full causal), "swa" (sliding window), "ssd" (Mamba-2),
"rglru" (Griffin recurrent). SSD blocks have no separate FFN (the mixer is
the whole block); the others' feed-forward is SwiGLU, or a routed mixture
of experts when the config has experts.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, mlp, moe, rglru, ssm
from repro_torch.models.common import Params, rms_norm, zeros_init

KINDS = ("attn", "swa", "ssd", "rglru")


def has_ffn(cfg, kind: str) -> bool:
    return cfg.d_ff > 0 and kind != "ssd"


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


class Block(Params):
    """`ffn` (SwiGLU) or `moe` (routed experts), the reference's keys."""

    def __init__(self, kind: str, norm1, mixer, norm2=None, ffn=None,
                 moe=None):
        super().__init__()
        self.kind = kind
        self.norm1, self.mixer = norm1, mixer
        if ffn is not None or moe is not None:
            self.norm2 = norm2
        if ffn is not None:
            self.ffn = ffn
        if moe is not None:
            self.moe = moe


def block_init(cfg, kind: str, dtype, generator: torch.Generator) -> Block:
    _check_kind(kind)
    dev = generator.device
    norm1 = zeros_init((cfg.d_model,), torch.float32, dev)
    if kind == "ssd":
        mixer = ssm.init(cfg, dtype, generator)
    elif kind == "rglru":
        mixer = rglru.init(cfg, dtype, generator)
    else:
        mixer = attention.init(cfg, dtype, generator)
    if not has_ffn(cfg, kind):
        return Block(kind, norm1, mixer)
    norm2 = zeros_init((cfg.d_model,), torch.float32, dev)
    if cfg.num_experts:
        return Block(kind, norm1, mixer, norm2,
                     moe=moe.init(cfg, dtype, generator))
    return Block(kind, norm1, mixer, norm2, ffn=mlp.init(cfg, dtype,
                                                         generator))


def block_apply(params, x, positions, cfg, kind: str, *,
                cache=None, decode: bool = False):
    """Returns (x, new_cache, aux_loss). `decode` selects the recurrent
    blocks' one-step form; attention blocks tell prefill from decode by
    the segment length."""
    _check_kind(kind)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if kind == "ssd":
        fn = ssm.decode_step if decode else ssm.apply
        out, new_cache = fn(params["mixer"], h, cfg, cache)
    elif kind == "rglru":
        fn = rglru.decode_step if decode else rglru.apply
        out, new_cache = fn(params["mixer"], h, cfg, cache)
    else:
        window = cfg.window if kind == "swa" else 0
        out, new_cache = attention.attend(
            params["mixer"], h, positions, cfg, window=window,
            impl=getattr(cfg, "attn_impl", "auto"), kv_cache=cache)
    x = x + out
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    if has_ffn(cfg, kind):
        h = rms_norm(x, params["norm2"], cfg.norm_eps)
        if cfg.num_experts:
            out, aux = moe.apply(params["moe"], h, cfg)
            aux_loss = aux["aux_loss"]
        else:
            out = mlp.apply(params["ffn"], h)
        x = x + out
    return x, new_cache, aux_loss


def block_cache_init(cfg, kind: str, batch: int, max_len: int, dtype,
                     device) -> dict:
    """Decode cache for one block: a ring buffer of min(window, max_len)
    slots ("swa") or max_len ("attn") with a stored-position plane, the
    SSD block's {"ssm", "conv"} state ("ssd"), or the RG-LRU block's
    {"h", "conv"} state ("rglru")."""
    _check_kind(kind)
    if kind == "ssd":
        return ssm.init_state(cfg, batch, dtype, device)
    if kind == "rglru":
        return rglru.init_state(cfg, batch, dtype, device)
    size = min(cfg.window, max_len) if kind == "swa" else max_len
    return attention.init_cache(cfg, batch, size, dtype, device)
