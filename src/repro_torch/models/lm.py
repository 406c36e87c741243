"""Causal LM assembly: embedding -> block stack -> final norm -> head
(counterpart of repro/models/lm.py).

The model is an nn.Module (`LM`): the embedding and head as parameters, the
blocks as an nn.ModuleList in execution order. The reference stacks its
blocks over layers for lax.scan (`params["groups"]`); here the stack is a
Python loop, and repro_torch.models.convert unstacks a reference pytree.
The functions keep the reference's names and arguments, with the module in
place of the params pytree, so the tests compare call for call. Caches are
a list with one dict per layer, of the layer's kind: attention layers'
{"k", "v", "pos"} rings in the kernel-native (B, KVH, S, D) layout,
written in place, and the recurrent layers' states, SSD's {"ssm", "conv"}
and RG-LRU's {"h", "conv"}, which each call returns anew as the reference
does. The aux loss is the sum of the MoE blocks' load-balance losses
(zero without experts). The head is the embedding's transpose when the
config ties them (mamba2-1.3b, recurrentgemma-2b).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import logical_constraint
from repro_torch.models import blocks
from repro_torch.models.common import (MetaDraws, Params, dense_init,
                                       dtype_of, map_axes_tree,
                                       param_axes_of, rms_norm, zeros_init)


class LM(Params):
    AXES = {"embed": ("vocab", "embed"), "lm_head": ("embed", "vocab"),
            "final_norm": ("embed",)}

    def __init__(self, cfg, *, embed=None, lm_head=None, final_norm=None,
                 layers=()):
        super().__init__()
        self.cfg = cfg
        if embed is not None:
            self.embed = embed
        if lm_head is not None:
            self.lm_head = lm_head
        self.final_norm = final_norm
        self.blocks = torch.nn.ModuleList(layers)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(cfg, generator: torch.Generator | None = None, *, seed: int = 0,
         device=None) -> LM:
    """Random weights drawn on `generator` (default: a generator seeded
    with `seed` on `device`, the card unless device="cpu"), in the order
    embedding, head, then each block. device="meta" draws nothing: every
    parameter is an empty meta tensor of its shape and dtype, the port's
    jax.eval_shape of the init."""
    if generator is None:
        device = resolve_device(device)
        generator = (MetaDraws() if device.type == "meta" else
                     torch.Generator(device).manual_seed(seed))
    dev = generator.device
    dtype = dtype_of(cfg.dtype)
    embed = lm_head = None
    if cfg.input_mode == "tokens":
        embed = dense_init((cfg.vocab_size, cfg.d_model), dtype, generator,
                           scale=0.02)
    if not cfg.tie_embeddings:
        lm_head = dense_init((cfg.d_model, cfg.vocab_size), dtype, generator)
    layers = [blocks.block_init(cfg, cfg.pattern_at(i), dtype, generator)
              for i in range(cfg.num_layers)]
    return LM(cfg, embed=embed, lm_head=lm_head,
              final_norm=zeros_init((cfg.d_model,), torch.float32, dev),
              layers=layers)


def param_axes(model_or_cfg) -> dict:
    """{parameter name: logical axes string} of an LM, or of the LM a
    config builds (made on the meta device): what the reference's init
    gives each leaf, without the "layers" axis it prepends to a stacked
    group (the port's blocks are not stacked; convert.leaf_map names
    each parameter's stacked reference leaf)."""
    model = (model_or_cfg if isinstance(model_or_cfg, LM)
             else init(model_or_cfg, device="meta"))
    return param_axes_of(model)


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def init_caches(cfg, batch: int, max_len: int, dtype=None,
                device=None) -> list[dict]:
    """One decode cache per layer, in execution order; on the card unless
    device="cpu"."""
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.dtype)
    return [blocks.block_cache_init(cfg, cfg.pattern_at(i), batch, max_len,
                                    dtype, device)
            for i in range(cfg.num_layers)]


def cache_axes(cfg) -> list[dict]:
    """Logical axes of init_caches' caches, layer by layer (without the
    reference's "layers" axis of a stacked group)."""
    return [map_axes_tree(blocks.block_cache_axes(cfg.pattern_at(i)))
            for i in range(cfg.num_layers)]


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def _stack_apply(params, cfg, x, positions, caches, decode):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = [] if caches is not None else None
    for i, blk in enumerate(params.blocks):
        x, nc, a = blocks.block_apply(
            blk, x, positions, cfg, blk.kind,
            cache=caches[i] if caches is not None else None, decode=decode)
        if caches is not None:
            new_caches.append(nc)
        aux = aux + a
    return x, new_caches, aux


def head_logits(params, cfg, x):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"])


def head_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def apply(params, cfg, inputs, positions, caches=None, decode=False,
          return_hidden=False):
    """inputs: (B, S) int tokens or (B, S, D) embeddings (per input_mode).

    Returns (logits_or_hidden, new_caches, aux_loss)."""
    if cfg.input_mode == "tokens":
        x = params["embed"][inputs.long()]
    else:
        x = inputs.to(dtype_of(cfg.dtype))
    x = logical_constraint(x, ("batch", "seq", "act_embed"))
    x, new_caches, aux = _stack_apply(params, cfg, x, positions, caches,
                                      decode)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x, new_caches, aux
    return head_logits(params, cfg, x), new_caches, aux


def decode_step(params, cfg, inputs, cache_len, caches):
    """One-token decode. inputs: (B, 1) tokens or (B, 1, D) embeddings;
    cache_len: (B,) tokens already in the cache."""
    positions = cache_len[:, None].to(torch.int32)
    return apply(params, cfg, inputs, positions, caches=caches, decode=True)


def prefill(params, cfg, inputs, caches, return_hidden=False):
    """Full-segment prefill that fills the decode caches."""
    b, s = inputs.shape[0], inputs.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=inputs.device).expand(b, s)
    return apply(params, cfg, inputs, positions, caches=caches, decode=False,
                 return_hidden=return_hidden)
