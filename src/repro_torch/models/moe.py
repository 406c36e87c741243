"""Top-k routed mixture-of-experts FFN, GShard-style fixed capacity
(counterpart of repro/models/moe.py).

Dispatch is index-based (gather -> expert products -> combine), so no
(tokens, experts, capacity) dispatch tensor is ever made; capacity
overflow drops a token's choice (it passes through the residual only),
underflow pads with zero-weight slots that hold token 0.

Routing modes:
- softmax top-k with renormalisation (Mixtral) and a Switch-style aux loss;
- aux-loss-free: sigmoid scores plus a selection-only bias nudged outside
  the gradient from expert load (DeepSeek-V3 / Moonlight style), see
  `bias_update`.

Where the reference vmaps one batch row at a time, `apply` routes all
(B, S) tokens at once, ranks each row's slots by its own cumsum, and runs
each expert's products as one bmm over the B x C rows of all batch rows.
Capacity, drops, and each token's sum over its experts in ascending
expert id (in x's dtype, as the reference's scatter-add adds in its
flattened (E, C) order) are the reference's; the combine gathers each
token's slots and adds them in that order, so it is deterministic where
an index_add_ on the card would add by atomics.

Over ranks (a step of repro_torch.launch.specs on a RankMesh) the router
and its bias are split over "experts": the fp32 router logits and the
bias are gathered whole before the softmax or sigmoid, so routing,
capacity and drops are the reference's. Under expert parallelism (the
experts split) a rank computes its experts' slots only, and a token's
choices of other ranks' experts add zeros; under the expert-TP fallback
(the expert hidden dim split) a rank's w_down product is partial. Either
way the outputs are summed over the ranks, in fp32 for half types, so
the ascending-id order of a token's sum in x's dtype holds within a rank
only: across ranks the sum differs from the reference's in rounding.
Under autograd x enters the router's and the experts' split products,
and the slot weights the experts' (sharding.enter_over), so their
gradients sum over the ranks. The load and importance that the aux
loss reads are means over the global batch: each rank's rows' means,
averaged over the batch's ranks (sharding.mean_over), since the
reference takes them over every row; routing and capacity stay per row.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as shlib
from repro_torch.models.common import Params, dense_init, zeros_init

# the block's leaves, in the reference's names (router_bias only with
# cfg.aux_free_bias)
LEAVES = ("router", "w_gate", "w_up", "w_down")


class MoE(Params):
    AXES = {"router": ("embed", "experts"),
            "w_gate": ("experts", "embed", "expert_mlp"),
            "w_up": ("experts", "embed", "expert_mlp"),
            "w_down": ("experts", "expert_mlp", "embed"),
            "router_bias": ("experts",)}

    def __init__(self, router, w_gate, w_up, w_down, router_bias=None):
        super().__init__()
        self.router = router
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down
        if router_bias is not None:
            self.router_bias = router_bias


def init(cfg, dtype, generator: torch.Generator) -> MoE:
    """Random weights drawn on `generator` in the reference's order
    (router in float32, then w_gate, w_up, w_down); the selection bias
    starts at zero."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    router = dense_init((d, e), torch.float32, generator)
    w_gate = dense_init((e, d, f), dtype, generator)
    w_up = dense_init((e, d, f), dtype, generator)
    w_down = dense_init((e, f, d), dtype, generator)
    bias = (zeros_init((e,), torch.float32, generator.device)
            if cfg.aux_free_bias else None)
    return MoE(router, w_gate, w_up, w_down, router_bias=bias)


def capacity(cfg, seq_len: int) -> int:
    c = math.ceil(seq_len * cfg.experts_per_token / cfg.num_experts
                  * cfg.moe_capacity_factor)
    return max(cfg.experts_per_token, min(c, seq_len))


def _top_k(values, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values, as jax.lax.top_k gives them (a stable
    descending sort; torch.topk promises no order of ties)."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _route(params, x, cfg):
    """x: (..., S, D) -> top-k (idx (..., S, k) int64, weights (..., S, k)
    fp32, probs (..., S, E)); the router runs in fp32."""
    router = params["router"]
    axes = shlib.split_axes(router, 1)
    logits = shlib.gather_over(torch.einsum(
        "...d,de->...e", shlib.enter_over(x.float(), axes), router), -1,
        axes)
    k = cfg.experts_per_token
    if cfg.aux_free_bias:
        scores = torch.sigmoid(logits)
        bias = params["router_bias"]
        bias = shlib.gather_over(bias, 0, shlib.split_axes(bias, 0))
        _, idx = _top_k(scores + bias, k)
        w = torch.gather(scores, -1, idx)
        w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
        probs = scores / torch.clamp_min(scores.sum(dim=-1, keepdim=True),
                                         1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = _top_k(probs, k)
        w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    return idx, w, probs


def _one_hot(idx, num_experts: int):
    """F.one_hot without its range check, which reads the ids back to the
    host (a device sync in every MoE layer of a decode step)."""
    return (idx[..., None] == torch.arange(num_experts, device=idx.device)
            ).long()


def _dispatch(idx, w, num_experts: int, cap: int):
    """_dispatch_indices' (token_for, weight_for), and each (token,
    choice)'s place in its expert's C slots over the flattened (..., S * k)
    choices: (slot e * cap + rank, kept), the rank being the number of
    earlier choices of the same expert in the row."""
    s, k = idx.shape[-2:]
    lead = idx.shape[:-2]
    flat_e = idx.reshape(*lead, s * k)
    rank = torch.gather(torch.cumsum(_one_hot(flat_e, num_experts), dim=-2)
                        - 1, -1, flat_e[..., None])[..., 0]
    keep = rank < cap
    slot = flat_e * cap + rank
    dest = torch.where(keep, slot, num_experts * cap)
    flat_t = torch.arange(s, dtype=torch.int32,
                          device=idx.device).repeat_interleave(k)
    n = num_experts * cap + 1
    token_for = torch.zeros((*lead, n), dtype=torch.int32,
                            device=idx.device).scatter_(
        -1, dest, flat_t.expand(*lead, s * k))
    weight_for = torch.zeros((*lead, n), dtype=torch.float32,
                             device=idx.device).scatter_(
        -1, dest, torch.where(keep, w.reshape(*lead, s * k), 0.0))
    return (token_for[..., :-1].reshape(*lead, num_experts, cap),
            weight_for[..., :-1].reshape(*lead, num_experts, cap), slot, keep)


def _dispatch_indices(idx, w, num_experts: int, cap: int):
    """Build (E, C) token indices + weights from per-token top-k choices.

    idx/w: (..., S, k), any leading batch axes. Returns token_for
    (..., E, C) int32 (0 where empty), weight_for (..., E, C) fp32 (0
    where empty/dropped). A dropped choice is written to an extra
    (E * C)-th slot that is then cut off, as the reference's out-of-range
    write with mode="drop" discards it."""
    return _dispatch(idx, w, num_experts, cap)[:2]


def _experts(params, x, idx, token_for, weight_for, slot, keep):
    """x (B, S, D), the dispatch of every row -> (B, S, D): gather each
    expert's C slots of every row, one bmm a projection over experts with
    B * C rows each, weight each slot's output in x's dtype, then sum
    each token's kept choices in ascending expert id in x's dtype. Over
    ranks that split the experts, only this rank's experts' slots (the
    other choices add zeros); the sum over the ranks closes it."""
    b, s, d = x.shape
    cap = token_for.shape[-1]
    k = idx.shape[-1]
    w_gate = params["w_gate"]
    e = w_gate.shape[0]
    e_axes = shlib.split_axes(w_gate, 0)
    split = e_axes + shlib.split_axes(w_gate, 2)    # experts, expert_mlp
    x = shlib.enter_over(x, split)
    weight_for = shlib.enter_over(weight_for, split)
    if e_axes:                      # expert parallel: this rank's experts
        lo = shlib.block_start(w_gate, 0)
        token_for = token_for[..., lo:lo + e, :]
        weight_for = weight_for[..., lo:lo + e, :]
        slot = slot - lo * cap
        keep = keep & (slot >= 0) & (slot < e * cap)
    xe = torch.gather(x, 1, token_for.reshape(b, e * cap, 1).long()
                      .expand(-1, -1, d))                    # (B, E*C, D)
    xe = xe.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    g = torch.bmm(xe, w_gate)
    del w_gate
    u = torch.bmm(xe, params["w_up"])
    w_down = params["w_down"]
    y = torch.bmm(F.silu(g) * u, w_down)                    # (E, B*C, D)
    del w_down
    y = y.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)
    y = y * weight_for.reshape(b, e * cap, 1).to(y.dtype)
    # each (token, choice)'s slot output (exactly 0 where dropped), its
    # choices in ascending expert id
    pos = torch.where(keep, slot, 0)                         # (B, S*k)
    per = torch.gather(y, 1, pos[..., None].expand(-1, -1, d))
    per = torch.where(keep[..., None], per, 0.0).reshape(b, s, k, d)
    order = torch.argsort(idx, dim=-1)
    per = torch.gather(per, 2, order[..., None].expand(-1, -1, -1, d))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + per[:, :, j]
    return shlib.reduce_over(out, split)


def _apply_row(params, x, cfg, cap):
    """x: (S, D) single batch row -> (out, (load, importance))."""
    out, load, imp = _apply_rows(params, x[None], cfg, cap)
    return out[0], (load[0], imp[0])


def _apply_rows(params, x, cfg, cap):
    idx, w, probs = _route(params, x, cfg)
    token_for, weight_for, slot, keep = _dispatch(idx, w, cfg.num_experts,
                                                  cap)
    out = _experts(params, x, idx, token_for, weight_for, slot, keep)
    # routing stats for aux loss / bias update, per row
    load = _one_hot(idx, cfg.num_experts).float().mean(dim=(1, 2))
    importance = probs.mean(dim=1)
    return out, load, importance


def apply(params, x, cfg):
    """x: (B, S, D) -> (out, aux) with aux = dict(load, importance,
    aux_loss); over ranks that split the batch, load and importance are
    the global batch's (mean_over the batch's axes)."""
    cap = capacity(cfg, x.shape[1])
    out, load, imp = _apply_rows(params, x, cfg, cap)
    load, imp = shlib.mean_over(torch.stack([load.mean(dim=0),
                                             imp.mean(dim=0)]),
                                shlib.split_of("batch"))
    # Switch-style load-balance loss: E * sum(load * importance)
    aux_loss = cfg.num_experts * torch.sum(load * imp)
    return out, {"load": load, "importance": imp, "aux_loss": aux_loss}


def bias_update(router_bias, load, rate: float = 1e-3):
    """Aux-loss-free balancing: nudge selection bias against overloaded
    experts (applied outside the gradient)."""
    err = torch.mean(load) - load         # positive for underloaded experts
    return router_bias + rate * torch.sign(err)
