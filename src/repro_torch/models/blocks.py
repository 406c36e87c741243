"""Residual decoder blocks: norm -> mixer -> residual [-> norm -> ffn]
(counterpart of repro/models/blocks.py).

Ported block kinds: "attn" (full causal) and "swa" (sliding window), each
with a SwiGLU FFN, and "ssd" (Mamba-2), whose mixer is the whole block.
"rglru" (Griffin) and MoE FFNs raise NotImplementedError until step 9 of
the port, after the kernel redesign work.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, mlp, ssm
from repro_torch.models.common import Params, rms_norm, zeros_init

_STEP9 = "is not ported yet: step 9 (rglru / moe blocks)"


def has_ffn(cfg, kind: str) -> bool:
    return cfg.d_ff > 0 and kind != "ssd"


def _check_kind(cfg, kind: str) -> None:
    if kind == "rglru":
        raise NotImplementedError(f"block kind {kind!r} {_STEP9}")
    if kind not in ("attn", "swa", "ssd"):
        raise ValueError(kind)
    if has_ffn(cfg, kind) and cfg.num_experts:
        raise NotImplementedError(f"the MoE feed-forward {_STEP9}")


class Block(Params):
    def __init__(self, kind: str, norm1, mixer, norm2=None, ffn=None):
        super().__init__()
        self.kind = kind
        self.norm1, self.mixer = norm1, mixer
        if ffn is not None:
            self.norm2, self.ffn = norm2, ffn


def block_init(cfg, kind: str, dtype, generator: torch.Generator) -> Block:
    _check_kind(cfg, kind)
    dev = generator.device
    mixer = (ssm.init(cfg, dtype, generator) if kind == "ssd"
             else attention.init(cfg, dtype, generator))
    if not has_ffn(cfg, kind):
        return Block(kind, zeros_init((cfg.d_model,), torch.float32, dev),
                     mixer)
    return Block(kind, zeros_init((cfg.d_model,), torch.float32, dev),
                 mixer, zeros_init((cfg.d_model,), torch.float32, dev),
                 mlp.init(cfg, dtype, generator))


def block_apply(params, x, positions, cfg, kind: str, *,
                cache=None, decode: bool = False):
    """Returns (x, new_cache, aux_loss). `decode` selects the SSD block's
    one-step recurrent form; attention blocks tell prefill from decode by
    the segment length."""
    _check_kind(cfg, kind)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if kind == "ssd":
        fn = ssm.decode_step if decode else ssm.apply
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
        x = x + mlp.apply(params["ffn"], h)
    return x, new_cache, aux_loss


def block_cache_init(cfg, kind: str, batch: int, max_len: int, dtype,
                     device) -> dict:
    """Decode cache for one block: a ring buffer of min(window, max_len)
    slots ("swa") or max_len ("attn") with a stored-position plane, or the
    SSD block's {"ssm", "conv"} state ("ssd")."""
    _check_kind(cfg, kind)
    if kind == "ssd":
        return ssm.init_state(cfg, batch, dtype, device)
    size = min(cfg.window, max_len) if kind == "swa" else max_len
    return attention.init_cache(cfg, batch, size, dtype, device)
