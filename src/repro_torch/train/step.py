"""Train and eval steps: loss, gradients, accumulation, the MoE bias hook
(counterpart of repro/train/step.py).

The state is the reference's {"params", "opt", "step"}, with the LM
module (its parameters trainable) as "params" and the optimizer's trees
keyed by parameter name (repro_torch.train.optim). Gradients come from
torch.autograd over the same forward the server runs: with
attn_impl="flash" every attention layer's forward is kernel 11 and every
SSD layer's forward is kernel 12 on a CUDA tensor; their backward
differentiates the plain versions (flash_attention.ops._Flash5,
ssd_chunk.ops._SSD), as the reference's custom_vjp does. Under the
config's remat (the reference's default, "block") every block's forward
runs again in the backward, kernels 11 and 12 included
(repro_torch.models.remat). The step updates the module and the
optimizer state in place and returns the state dict.

On a mesh of ranks (repro_torch.launch.mesh.RankMesh) the state is
split: `init_state(..., mesh=, rules=)` keeps this rank's block of every
parameter and so of m, v and master (repro_torch.dist.sharding), and
`make_rank_train_step`'s step gathers every parameter whole, takes the
loss and gradients of this rank's rows, all-reduces each gradient in
fp32 over the mesh axes that split the batch (the mean of the ranks'
means), clips by the norm of the whole reduced gradients and updates
this rank's blocks. Ranks along an axis that does not split the batch
compute the same rows: the compute is replicated there, as the
reference's GSPMD step's arithmetic is (its tensor-parallel layout over
"model" is ROADMAP.md's item 5d-train; the serve step on ranks computes
tensor-parallel, repro_torch.launch.specs).
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist import sharding as shlib
from repro_torch.models import convert, lm, moe
from repro_torch.models.common import (chunked_cross_entropy,
                                       softmax_cross_entropy)
from repro_torch.train import optim

AUX_LOSS_WEIGHT = 0.01


def loss_fn(params, cfg, batch):
    """batch: {'inputs': (B, S) or (B, S, D), 'labels': (B, S)}. No decode
    caches: the in-place ring writes never run under autograd."""
    inputs, labels = batch["inputs"], batch["labels"]
    b, s = labels.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=labels.device).expand(b, s)
    if cfg.fused_ce:
        hidden, _, aux = lm.apply(params, cfg, inputs, positions,
                                  return_hidden=True)
        ce = chunked_cross_entropy(hidden, lm.head_weight(params, cfg),
                                   labels)
    else:
        logits, _, aux = lm.apply(params, cfg, inputs, positions)
        ce = softmax_cross_entropy(logits, labels)
    loss = ce + AUX_LOSS_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def value_and_grad(params, cfg, batch):
    """(loss, parts, grads): grads maps every parameter name to its
    gradient in the parameter's dtype, or None where the loss does not
    depend on the parameter (an aux-free router's selection bias, which
    enters only the top-k)."""
    named = list(params.named_parameters())
    loss, parts = loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            {n: g for (n, _), g in zip(named, grads)})


def _microbatch(tree, idx, n):
    return {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[idx]
            for k, x in tree.items()}


def _grad_fn(cfg, num_microbatches: int):
    """(params, batch) -> (loss, parts, grads), every gradient a tensor.
    With num_microbatches > 1 the gradients are the fp32 mean over the
    microbatches and the parts (ce, aux) the last microbatch's, as the
    reference's scan gives them."""

    def single(params, batch):
        loss, parts, grads = value_and_grad(params, cfg, batch)
        named = dict(params.named_parameters())
        # the reference's gradient of an unused leaf is zeros
        return loss, parts, {n: torch.zeros_like(named[n]) if g is None
                             else g for n, g in grads.items()}

    def accumulated(params, batch):
        loss_acc = 0.0
        grads_acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.named_parameters()}
        for idx in range(num_microbatches):
            mb = _microbatch(batch, idx, num_microbatches)
            loss, parts, grads = single(params, mb)
            for n, g in grads.items():
                grads_acc[n].add_(g)
            loss_acc = loss_acc + loss
            del grads        # not held through the next backward
        inv = 1.0 / num_microbatches
        for g in grads_acc.values():
            g.mul_(inv)
        return loss_acc * inv, parts, grads_acc

    return accumulated if num_microbatches > 1 else single


def make_train_step(cfg, opt_cfg: optim.AdamWConfig,
                    num_microbatches: int = 1):
    """Returns step(state, batch) -> (state, metrics); see _grad_fn for
    num_microbatches."""
    grad_fn = _grad_fn(cfg, num_microbatches)

    def step(state, batch):
        params = state["params"]
        loss, parts, grads = grad_fn(params, batch)
        _, new_opt, om = optim.apply_updates(params, grads, state["opt"],
                                             opt_cfg)
        if cfg.num_experts and cfg.aux_free_bias:
            _moe_bias_update(params, grads)
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **parts, **om}

    return step


def _set_param(model: torch.nn.Module, name: str, param) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(owner) if owner else model, leaf, param)


@torch.no_grad()
def place_blocks(params: torch.nn.Module, shardings: dict):
    """Replace every parameter of `params` by this rank's block of it
    under `shardings` ({parameter name: NamedSharding} over a rank mesh),
    a copy of its own, so the whole leaf can be freed. Returns
    `params`."""
    for name, p in list(params.named_parameters()):
        block = shlib.local_block(p.detach(), shardings[name])
        if block is not p:
            _set_param(params, name, torch.nn.Parameter(
                block.clone(), requires_grad=p.requires_grad))
    return params


@torch.no_grad()
def gathered(blocks: torch.nn.Module, shardings: dict, cfg):
    """An LM of `cfg` whose parameters are the whole leaves gathered from
    every rank's `blocks` (a parameter unsplit is the block's own
    storage), each a fresh leaf that requires grad."""
    full = lm.init(cfg, device="meta")
    for name, p in blocks.named_parameters():
        whole = shlib.gather(p.detach(), shardings[name])
        _set_param(full, name, torch.nn.Parameter(whole, requires_grad=True))
    return full


def make_rank_train_step(cfg, opt_cfg: optim.AdamWConfig, mesh,
                         shardings: dict, batch_axes: tuple = (),
                         num_microbatches: int = 1):
    """step(state, batch) -> (state, metrics) on a rank mesh. `state`
    holds this rank's blocks under `shardings` ({parameter name:
    NamedSharding}, m, v and master alike), `batch` this rank's rows of a
    global batch split over `batch_axes` (mesh axes; () where the batch
    is whole on every rank). Loss and metrics are the same on every rank.

    The gradients are all-reduced in fp32 and divided by the number of
    batch blocks: the global mean where the blocks are equal. Nothing is
    reduced where the batch is whole, and on a one-rank mesh the step is
    make_train_step's, bit for bit. MoE routing over split rows (its
    capacity and load-balance loss are the global batch's in the
    reference) is not ported, so MoE configs raise on a mesh of more
    than one rank."""
    import torch.distributed as dist
    if cfg.num_experts and mesh.size > 1:
        raise NotImplementedError(
            f"the MoE train step over {mesh.size} ranks: routing "
            f"capacity and the load-balance loss over a batch split "
            f"across ranks, with expert-parallel compute, are ROADMAP.md's "
            f"item 5d-train")
    grad_fn = _grad_fn(cfg, num_microbatches)
    groups = [mesh.axis_group(a) for a in batch_axes if mesh.shape[a] > 1]
    blocks_n = math.prod(mesh.shape[a] for a in batch_axes)

    def reduced(t: torch.Tensor) -> torch.Tensor:
        # contiguous, as _grad_fn's fp32 accumulators are: autograd may
        # hand back a transposed gradient (the tied embedding's), and a
        # CUDA sum follows the memory order, so the norm would differ
        t = t.to(torch.float32, memory_format=torch.contiguous_format)
        for group in groups:
            dist.all_reduce(t, group=group)
        return t.div_(blocks_n)

    def step(state, batch):
        params = state["params"]
        loss, parts, grads = grad_fn(gathered(params, shardings, cfg), batch)
        squares, blocks = [], {}
        for name in list(grads):
            g = grads.pop(name)
            if groups:
                g = reduced(g)
            squares.append(g.float().square().sum())
            block = shlib.local_block(g, shardings[name])
            blocks[name] = block if block is g else block.clone()
            del g, block
        # optim.global_norm's arithmetic, over the whole reduced gradients
        norm = torch.sqrt(torch.stack(squares).sum())
        _, new_opt, om = optim.apply_updates(params, blocks, state["opt"],
                                             opt_cfg, norm=norm)
        if cfg.num_experts and cfg.aux_free_bias:
            _moe_bias_update(params, blocks)
        if groups:
            keys = list(parts)
            both = reduced(torch.stack([loss.float()] + [
                parts[k].float() for k in keys]))
            loss, parts = both[0], dict(zip(keys, both[1:]))
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **parts, **om}

    return step


@torch.no_grad()
def _moe_bias_update(params, grads):
    """Aux-loss-free router balancing: the raw (unclipped) router
    gradient's per-expert magnitude is a live proxy for expert load; nudge
    each selection bias against heavy experts, outside the optimizer. The
    reference updates a stacked leaf at once, so the mean load it compares
    with is over every group of that pattern slot: blocks are grouped by
    their reference leaf here too."""
    stacks: dict = {}
    for name, (path, _) in convert.leaf_map(params).items():
        if path[-1] == "router_bias":
            stacks.setdefault(path, []).append(name)
    named = dict(params.named_parameters())
    for names in stacks.values():
        load = torch.stack([
            grads[n[:-len("router_bias")] + "router"].float().abs()
            .sum(dim=-2) for n in names])
        new = moe.bias_update(torch.stack([named[n] for n in names]), load)
        for n, b in zip(names, new):
            named[n].copy_(b)


def make_eval_step(cfg):
    @torch.no_grad()
    def step(params, batch):
        loss, parts = loss_fn(params, cfg, batch)
        return {"loss": loss, **parts}
    return step


def init_state(seed: int, cfg, opt_cfg: optim.AdamWConfig, device=None, *,
               mesh=None, rules=None):
    """Returns (state, axes): random weights drawn from a generator seeded
    with `seed` on `device` (the card unless device="cpu"), made
    trainable; device="meta" gives the abstract state, no draw and no
    arithmetic (the port's jax.eval_shape of the reference's init_state).
    `axes` mirrors the state: each parameter's logical axes as the
    reference's init gives them (lm.param_axes, keyed by parameter name),
    the optimizer's trees the same (optim.opt_axes). With a rank `mesh`
    (and the cell's `rules`) every rank draws the weights leaf by leaf
    on its device and keeps its block of each (lm.init's rank form), and
    the optimizer state is made from the blocks."""
    params = lm.init(cfg, seed=seed, device=device, mesh=mesh, rules=rules)
    params.requires_grad_(True)
    opt = optim.init(params, opt_cfg)
    state = {"params": params, "opt": opt,
             "step": torch.zeros((), dtype=torch.int32,
                                 device=opt["count"].device)}
    axes = lm.param_axes(params)
    state_axes = {"params": axes, "opt": optim.opt_axes(axes, opt_cfg),
                  "step": "_scalar_"}
    return state, state_axes
