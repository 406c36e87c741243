"""AdamW with fp32 master weights and a cosine schedule (counterpart of
repro/train/optim.py).

State layout, every tensor fp32 and keyed by the LM's parameter names
(`named_parameters()`):
  m, v        — Adam moments
  master      — fp32 master copy of (possibly bf16) params
  count       — step counter (int32 scalar)

`apply_updates` keeps the reference's order of operations (cast the
gradients to fp32, clip by the global norm, count + 1, the schedule in
fp32, bias corrections 1 - b ** count with an fp32 count, moments, the
decoupled decay on the fp32 weights, the cast to the parameter's dtype),
but updates m, v, master and the parameters in place, leaf by leaf, under
torch.no_grad(), so the card never holds a second copy of the fp32 state
or an fp32 copy of every gradient at once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    use_master: bool = True


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * lr, in fp32."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def init(params: torch.nn.Module, cfg: AdamWConfig) -> dict:
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
             for n, p in named.items()}
    state = {"m": zeros,
             "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
             "count": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.use_master:
        state["master"] = {n: p.detach().to(torch.float32, copy=True)
                           for n, p in named.items()}
    return state


def opt_axes(params_axes, cfg: AdamWConfig) -> dict:
    """Logical axes for the optimizer state (mirror the params)."""
    ax = {"m": params_axes, "v": params_axes, "count": "_scalar_"}
    if cfg.use_master:
        ax["master"] = params_axes
    return ax


def global_norm(grads: dict) -> torch.Tensor:
    leaves = [g.float().square().sum() for g in grads.values()]
    return torch.sqrt(torch.stack(leaves).sum())


def clip_by_global_norm(grads: dict, max_norm: float):
    """(the gradients scaled to a global norm of at most max_norm, the
    norm before scaling)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g * scale for n, g in grads.items()}, norm


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a true division: `max_norm / tensor` would multiply by a reciprocal
    ratio = torch.full_like(norm, max_norm) / torch.clamp_min(norm, 1e-9)
    return torch.clamp_max(ratio, 1.0)


@torch.no_grad()
def apply_updates(params: torch.nn.Module, grads: dict, state: dict,
                  cfg: AdamWConfig, norm: torch.Tensor | None = None):
    """One AdamW step, in place: `grads` maps every parameter name to its
    gradient (any float dtype; read, never written). Returns (params,
    new_state, metrics); new_state holds the same m / v / master tensors,
    updated, and the next count. `norm` is the gradients' global norm
    where `grads` (and `params`, m, v, master) are one rank's blocks: the
    caller computes it over the whole reduced gradients, as global_norm
    does, since a block's own norm would clip wrongly. None: global_norm
    of `grads`."""
    gnorm = global_norm(grads) if norm is None else norm
    scale = _clip_scale(gnorm, cfg.grad_clip)
    count = state["count"] + 1
    lr = schedule(cfg, count)
    c = count.float()
    bc1 = 1.0 - cfg.b1 ** c
    bc2 = 1.0 - cfg.b2 ** c
    masters = state.get("master")
    for name, p in params.named_parameters():
        g = grads[name].float() * scale
        m, v = state["m"][name], state["v"][name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = masters[name] if masters is not None else p.float()
        new = p32 - lr * (step + cfg.weight_decay * p32)
        if masters is not None:
            p32.copy_(new)
        p.copy_(new)
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    if masters is not None:
        new_state["master"] = masters
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
