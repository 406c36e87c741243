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
(zero without experts). Under `cfg.remat` other than "none" a training
forward checkpoints every block, as the reference's jax.checkpoint does
(repro_torch.models.remat). The head is the embedding's transpose when the
config ties them (mamba2-1.3b, recurrentgemma-2b).

On a mesh of ranks (repro_torch.launch.mesh.RankMesh) `init` and
`init_caches` make this rank's blocks only, and a step over ranks
(repro_torch.launch.specs) computes on them: the embedding lookup on a
vocabulary split over ranks takes the tokens in the rank's rows and sums
over the ranks (one term nonzero, so exact; under autograd the sum's
adjoint is the identity, so each rank's table rows take their own
tokens' gradient), and the head's split logits are gathered whole
before anything reads them (x enters the head through
sharding.enter_over, so its gradient sums the ranks' vocabulary
blocks).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shlib
from repro_torch.dist.sharding import logical_constraint
from repro_torch.models import attention, blocks, remat
from repro_torch.models.common import (MetaDraws, Params, dense_init,
                                       drawn_by, dtype_of, map_axes_tree,
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
         device=None, mesh=None, rules=None) -> LM:
    """Random weights drawn on `generator` (default: a generator seeded
    with `seed` on `device`, the card unless device="cpu"), in the order
    embedding, head, then each block. device="meta" draws nothing: every
    parameter is an empty meta tensor of its shape and dtype, the port's
    jax.eval_shape of the init.

    With a rank `mesh` (and the cell's `rules`) every parameter is this
    rank's block under sharding_tree(..., rules), each leaf cut as it is
    drawn (on `device`, by default the mesh's): the values are those of
    the whole init, bit for bit, and a rank holds one whole leaf at most,
    for the time of its draw."""
    if getattr(mesh, "group", None) is not None:
        return _init_blocks(cfg, generator, seed,
                            mesh.device if device is None else device,
                            mesh, rules or {})
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


def _init_blocks(cfg, generator, seed, device, mesh, rules) -> LM:
    """init's rank form: the draw order and each draw's sharding come from
    the same init on the meta device; the real draws then keep the block
    of each leaf, and the leaves made whole without a draw (norms, zeros,
    the SSM's constants) are cut after."""
    drawn = []

    def record(w, dtype):
        drawn.append(torch.nn.Parameter(w.to(dtype), requires_grad=False))
        return drawn[-1]

    with drawn_by(record):
        meta = init(cfg, device="meta")
    sh = shlib.sharding_tree(meta, param_axes(meta), mesh, rules)
    name_of = {id(p): n for n, p in meta.named_parameters()}
    cuts = iter([sh[name_of[id(p)]] for p in drawn])
    del meta, drawn, name_of

    cut_ids = set()

    def cut(w, dtype):
        block = shlib.local_block(w, next(cuts))
        # a block is a copy of its own, so the whole leaf w is freed
        p = torch.nn.Parameter(block.to(dtype, copy=block is not w),
                               requires_grad=False)
        cut_ids.add(id(p))
        return p

    if generator is None:
        generator = torch.Generator(resolve_device(device)).manual_seed(seed)
    with drawn_by(cut):
        model = init(cfg, generator)
    for name, p in list(model.named_parameters()):
        block = p if id(p) in cut_ids else shlib.local_block(p, sh[name])
        if block is not p:
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner) if owner else model, leaf,
                    torch.nn.Parameter(block.clone(), requires_grad=False))
    return model


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
                device=None, *, mesh=None, rules=None) -> list[dict]:
    """One decode cache per layer, in execution order; on the card unless
    device="cpu". With a rank `mesh` (and the cell's `rules`), this
    rank's block of each leaf of the `batch`-row caches under
    sharding_tree(..., rules), on the mesh's device."""
    if getattr(mesh, "group", None) is not None:
        whole = init_caches(cfg, batch, max_len, dtype, "meta")
        sh = shlib.sharding_tree(whole, cache_axes(cfg), mesh, rules or {})
        return [{k: torch.full(sh[i][k].shard_shape(t.shape),
                               attention.CACHE_FILL.get(k, 0),
                               dtype=t.dtype, device=mesh.device)
                 for k, t in c.items()} for i, c in enumerate(whole)]
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

def _block_fn(cfg, kind, decode):
    """f(x, bp, c, positions) -> (x, new_cache, aux) of one block; under
    `cfg.remat` other than "none", outside decode and with grad enabled,
    checkpointed as the reference's jax.checkpoint of its block
    (repro_torch.models.remat: "dots" keeps the batch-free products,
    anything else only the block's inputs). Under torch.no_grad() nothing
    is checkpointed: serving, prefill and eval run as before."""
    def f(x, bp, c, positions):
        return blocks.block_apply(bp, x, positions, cfg, kind, cache=c,
                                  decode=decode)
    if cfg.remat != "none" and not decode and torch.is_grad_enabled():
        return lambda x, bp, c, positions: remat.checkpoint(
            f, cfg.remat, (cfg, kind), x, bp, c, positions)
    return f


def _stack_apply(params, cfg, x, positions, caches, decode):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = [] if caches is not None else None
    fns = {k: _block_fn(cfg, k, decode) for k in cfg.block_pattern}
    for i, blk in enumerate(params.blocks):
        x, nc, a = fns[blk.kind](
            x, blk, caches[i] if caches is not None else None, positions)
        if caches is not None:
            new_caches.append(nc)
        aux = aux + a
    return x, new_caches, aux


def head_logits(params, cfg, x):
    """(B, S, V) logits; over ranks whose head splits the vocabulary, each
    rank's columns gathered whole."""
    if cfg.tie_embeddings:
        w, vocab_dim = params["embed"], 0
    else:
        w, vocab_dim = params["lm_head"], 1
    axes = shlib.split_axes(w, vocab_dim)
    x = shlib.enter_over(x, axes)
    logits = (torch.einsum("bsd,vd->bsv", x, w) if cfg.tie_embeddings
              else torch.einsum("bsd,dv->bsv", x, w))
    return shlib.gather_over(logits, -1, axes)


def embed_lookup(table, tokens):
    """table[tokens]; over ranks that split the vocabulary, each rank
    looks up the tokens of its rows, zeros elsewhere, summed over the
    ranks: one term of each sum is nonzero, so the result is exact."""
    axes = shlib.split_axes(table, 0)
    if not axes:
        return table[tokens.long()]
    local = tokens.long() - shlib.block_start(table, 0)
    inside = (local >= 0) & (local < table.shape[0])
    x = torch.where(inside[..., None],
                    table[local.clamp(0, table.shape[0] - 1)], 0.0)
    return shlib.reduce_over(x, axes)


def head_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def apply(params, cfg, inputs, positions, caches=None, decode=False,
          return_hidden=False):
    """inputs: (B, S) int tokens or (B, S, D) embeddings (per input_mode).

    Returns (logits_or_hidden, new_caches, aux_loss)."""
    if cfg.input_mode == "tokens":
        x = embed_lookup(params["embed"], inputs)
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
