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
"""
from __future__ import annotations

import torch

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


def make_train_step(cfg, opt_cfg: optim.AdamWConfig,
                    num_microbatches: int = 1):
    """Returns step(state, batch) -> (state, metrics). With
    num_microbatches > 1 the gradients are the fp32 mean over the
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

    def step(state, batch):
        params = state["params"]
        if num_microbatches > 1:
            loss, parts, grads = accumulated(params, batch)
        else:
            loss, parts, grads = single(params, batch)
        _, new_opt, om = optim.apply_updates(params, grads, state["opt"],
                                             opt_cfg)
        if cfg.num_experts and cfg.aux_free_bias:
            _moe_bias_update(params, grads)
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


def init_state(seed: int, cfg, opt_cfg: optim.AdamWConfig, device=None):
    """Returns (state, axes): random weights drawn from a generator seeded
    with `seed` on `device` (the card unless device="cpu"), made
    trainable; device="meta" gives the abstract state, no draw and no
    arithmetic (the port's jax.eval_shape of the reference's init_state).
    `axes` mirrors the state: each parameter's logical axes as the
    reference's init gives them (lm.param_axes, keyed by parameter name),
    the optimizer's trees the same (optim.opt_axes)."""
    params = lm.init(cfg, seed=seed, device=device)
    params.requires_grad_(True)
    opt = optim.init(params, opt_cfg)
    state = {"params": params, "opt": opt,
             "step": torch.zeros((), dtype=torch.int32,
                                 device=opt["count"].device)}
    axes = lm.param_axes(params)
    state_axes = {"params": axes, "opt": optim.opt_axes(axes, opt_cfg),
                  "step": "_scalar_"}
    return state, state_axes
