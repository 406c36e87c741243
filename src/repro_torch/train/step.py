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
`make_rank_train_step`'s step computes on the blocks as the serve step
does: tensor-parallel over "model" (heads, mlp, vocabulary), expert-
parallel where the expert count divides it, each parameter gathered
over "data"/"pod" at its use (sharding.at_use), with the collectives'
adjoints in the backward. It takes the loss and gradients of this
rank's rows, all-reduces each gradient in fp32 over the mesh axes that
split the batch (the mean of the ranks' means), clips by the norm of the
whole reduced gradients and updates this rank's blocks. MoE routing
statistics are the global batch's (models.moe), and a rank's
microbatch i is its block of the global microbatch i, as in the
reference.
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
        if shlib.reads_blocks():        # the head's blocks, chunk by chunk
            ce = chunked_cross_entropy(hidden, None, labels, logits_of=(
                lambda h: lm.head_logits(params, cfg, h)))
        else:
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


def value_and_grad_at_use(params, cfg, batch):
    """value_and_grad over ranks, with the parameters read through
    sharding.at_use: each gradient is the one its uses left
    (sharding.use_grad), this rank's "model" block whole over the axes
    at_use gathered, from this rank's rows; None where the loss does not
    depend on the parameter."""
    loss, parts = loss_fn(params, cfg, batch)
    torch.autograd.backward(loss)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            {n: shlib.use_grad(p) for n, p in params.named_parameters()})


def _microbatch(tree, idx, n):
    return {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[idx]
            for k, x in tree.items()}


def _grad_fn(cfg, num_microbatches: int, vg=value_and_grad,
             shape_of=None, microbatch=_microbatch):
    """(params, batch) -> (loss, parts, grads), every gradient a tensor
    (`vg` computes them; an unused leaf's is zeros of `shape_of(name)`,
    by default the parameter's shape). With num_microbatches > 1 the
    gradients are the fp32 mean over the microbatches (`microbatch(batch,
    idx, n)` cuts the rows of microbatch idx) and the parts (ce, aux) the
    last microbatch's, as the reference's scan gives them."""

    def shape(name, p):
        return tuple(p.shape) if shape_of is None else shape_of(name)

    def single(params, batch):
        loss, parts, grads = vg(params, cfg, batch)
        named = dict(params.named_parameters())
        # the reference's gradient of an unused leaf is zeros
        return loss, parts, {n: named[n].new_zeros(shape(n, named[n]))
                             if g is None else g for n, g in grads.items()}

    def accumulated(params, batch):
        loss_acc = 0.0
        grads_acc = {n: torch.zeros(shape(n, p), dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.named_parameters()}
        for idx in range(num_microbatches):
            mb = microbatch(batch, idx, num_microbatches)
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
    """step(state, batch) -> (state, metrics) on a rank mesh, run under
    the cell's use_rules (launch.specs.build_train names the parameters'
    shardings there, `leaves`). `state` holds this rank's blocks under
    `shardings` ({parameter name: NamedSharding}, m, v and master
    alike), `batch` this rank's rows of a global batch split over
    `batch_axes` (mesh axes; () where the batch is whole on every rank).
    Loss and metrics are the same on every rank.

    The step computes on the blocks, each parameter read through
    sharding.at_use; its gradient (value_and_grad_at_use) is this rank's
    "model" block whole over "data"/"pod", from this rank's rows. Each
    gradient is all-reduced in fp32 over the batch's axes and divided by
    the number of batch blocks (the global mean where the blocks are
    equal), then cut to this rank's block. The clip norm sums the squares
    of the leaves split over "model" over every rank's block (an
    all-reduce over those axes) and counts a leaf the "model" ranks hold
    alike once, so it is the whole reduced gradients' norm on every rank.
    The aux-free bias update reads each router gradient reduced and whole
    over "embed". Under the cp strategy each "model" rank attends only
    its block of q's rows (models.attention: context parallelism), and
    x, wq, wk and wv enter attention through enter_over, so their
    gradients are summed over those ranks before they reach the
    parameters: no "model" rank's gradient is partial here either. With
    num_microbatches > 1 a rank's microbatch i is its
    block of the global microbatch i (the batch is gathered over its axes
    first). On a one-rank mesh the step is make_train_step's, bit for
    bit."""
    import torch.distributed as dist
    groups = [mesh.axis_group(a) for a in batch_axes if mesh.shape[a] > 1]
    blocks_n = math.prod(mesh.shape[a] for a in batch_axes)
    model = [a for a in shlib.COMPUTE_AXES if mesh.shape.get(a, 1) > 1]
    # the axes at_use gathers a leaf over, and whether "model" splits it
    fsdp = {n: tuple(a for _, e in sh.splits() for a in e
                     if a not in shlib.COMPUTE_AXES)
            for n, sh in shardings.items()}
    split = {n: any(a in model for _, e in sh.splits() for a in e)
             for n, sh in shardings.items()}
    rows = shlib.NamedSharding(mesh, shlib.PartitionSpec(tuple(batch_axes)))

    def rank_microbatch(batch, idx, n):
        return {k: shlib.local_block(x, rows)
                for k, x in _microbatch(batch, idx, n).items()}

    if mesh.size == 1:
        grad_fn = _grad_fn(cfg, num_microbatches)
    else:
        grad_fn = _grad_fn(
            cfg, num_microbatches, value_and_grad_at_use,
            lambda n: shardings[n].without(fsdp[n]).shard_shape(
                shardings[n].global_shape),
            rank_microbatch if groups else _microbatch)

    def reduced(t: torch.Tensor) -> torch.Tensor:
        # contiguous, as _grad_fn's fp32 accumulators are: autograd may
        # hand back a transposed gradient (the tied embedding's), and a
        # CUDA sum follows the memory order, so the norm would differ
        t = t.to(torch.float32, memory_format=torch.contiguous_format)
        for group in groups:
            dist.all_reduce(t, group=group)
        return t.div_(blocks_n)

    def step(state, batch):
        if mesh.size > 1 and not shlib.reads_blocks():
            raise ValueError("the train step over ranks reads the "
                             "parameters as blocks: run it under "
                             "use_rules(..., leaves=) (build_train)")
        params = state["params"]
        if groups and num_microbatches > 1:
            batch = {k: _whole_rows(x, rows) for k, x in batch.items()}
        loss, parts, grads = grad_fn(params, batch)
        squares = {True: [], False: []}
        blocks, loads = {}, {}
        for name in list(grads):
            g = grads.pop(name)
            if groups:
                g = reduced(g)
            squares[split[name]].append(g.float().square().sum())
            if name.endswith(".router") and cfg.aux_free_bias:
                loads[name] = g.float().abs().sum(dim=-2)
            block = shlib.local_block(g, shardings[name], axes=fsdp[name])
            blocks[name] = block if block is g else block.clone()
            del g, block
        # optim.global_norm's arithmetic, over the whole reduced gradients
        total = torch.stack(squares[False]).sum()
        if squares[True]:
            over = torch.stack(squares[True]).sum()
            for a in model:
                dist.all_reduce(over, group=mesh.axis_group(a))
            total = over + total
        norm = torch.sqrt(total)
        _, new_opt, om = optim.apply_updates(params, blocks, state["opt"],
                                             opt_cfg, norm=norm)
        if cfg.num_experts and cfg.aux_free_bias:
            _moe_bias_update(params, loads, shardings)
        if groups:
            keys = list(parts)
            both = reduced(torch.stack([loss.float()] + [
                parts[k].float() for k in keys]))
            loss, parts = both[0], dict(zip(keys, both[1:]))
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **parts, **om}

    return step


def _whole_rows(x: torch.Tensor, rows) -> torch.Tensor:
    """The global batch from every rank's rows `x` under `rows` (the
    batch's sharding); integer tokens travel as the bits of a float32
    tensor, as only float leaves are gathered over ranks."""
    if x.is_floating_point():
        return shlib.gather(x, rows)
    return shlib.gather(x.view(torch.float32), rows).view(x.dtype)


@torch.no_grad()
def _moe_bias_update(params, grads, shardings=None):
    """Aux-loss-free router balancing: the raw (unclipped) router
    gradient's per-expert magnitude is a live proxy for expert load; nudge
    each selection bias against heavy experts, outside the optimizer. The
    reference updates a stacked leaf at once, so the mean load it compares
    with is over every group of that pattern slot: blocks are grouped by
    their reference leaf here too. On ranks (`shardings`), `grads` maps
    each router to its load proxy, read from the gradient reduced over
    the batch and whole over "embed"; the proxies and the biases are
    gathered over the experts' axes before bias_update's mean over the
    experts, and each rank keeps its block of the new bias."""
    stacks: dict = {}
    for name, (path, _) in convert.leaf_map(params).items():
        if path[-1] == "router_bias":
            stacks.setdefault(path, []).append(name)
    named = dict(params.named_parameters())
    for names in stacks.values():
        routers = [n[:-len("router_bias")] + "router" for n in names]
        if shardings is None:
            load = torch.stack([grads[r].float().abs().sum(dim=-2)
                                for r in routers])
            bias = torch.stack([named[n] for n in names])
        else:       # a bias's sharding is its router's over the experts
            load = torch.stack([shlib.gather(grads[r], shardings[n])
                                for r, n in zip(routers, names)])
            bias = torch.stack([shlib.gather(named[n], shardings[n])
                                for n in names])
        new = moe.bias_update(bias, load)
        for n, b in zip(names, new):
            named[n].copy_(b if shardings is None
                           else shlib.local_block(b, shardings[n]))


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
