"""Griffin recurrent block: gated branch x (conv -> RG-LRU) branch
(arXiv:2402.19427, RecurrentGemma; counterpart of repro/models/rglru.py).

The RG-LRU recurrence h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t) with
a_t = sigma(Lambda)^(c * r_t) is evaluated in log-space: for prefill by a
doubling (Hillis-Steele) scan of log2(S) elementwise passes over the whole
segment, with the reference's associative combine; for decode as the O(1)
update. `_scan_ref` is the plain sequential recurrence beside it. Like the
reference these return new state tensors instead of writing the cache.

The gate projections (W_r, W_i) are full dense, as in the reference,
rather than RecurrentGemma's block-diagonal.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init, uniform, zeros_init

C_EXP = 8.0

# the mixer's leaves, in the reference's names
LEAVES = ("proj_x", "proj_gate", "w_r", "b_r", "w_i", "b_i", "lam",
          "conv_w", "out_proj")


class RGLRU(Params):
    AXES = {"proj_x": ("embed", "lru"), "proj_gate": ("embed", "lru"),
            "w_r": ("lru", "lru_gate"), "b_r": ("lru_gate",),
            "w_i": ("lru", "lru_gate"), "b_i": ("lru_gate",),
            "lam": ("lru",), "conv_w": ("conv_k", "lru"),
            "out_proj": ("lru", "embed")}

    def __init__(self, proj_x, proj_gate, w_r, b_r, w_i, b_i, lam, conv_w,
                 out_proj):
        super().__init__()
        self.proj_x, self.proj_gate = proj_x, proj_gate
        self.w_r, self.b_r, self.w_i, self.b_i = w_r, b_r, w_i, b_i
        self.lam, self.conv_w, self.out_proj = lam, conv_w, out_proj


def init(cfg, dtype, generator: torch.Generator) -> RGLRU:
    """Random weights drawn on `generator` in the reference's order
    (proj_x, proj_gate, w_r, w_i, Lambda, conv_w, out_proj); Lambda =
    log(u^2 / (1 - u^2)) / 2 with u ~ U[0.9, 0.999] (the Griffin
    appendix's region), the gate biases zeros, all three float32."""
    w = cfg.resolved_lru_width
    dev = generator.device
    proj_x = dense_init((cfg.d_model, w), dtype, generator)
    proj_gate = dense_init((cfg.d_model, w), dtype, generator)
    w_r = dense_init((w, w), dtype, generator)
    w_i = dense_init((w, w), dtype, generator)
    u = uniform((w,), 0.9, 0.999, generator)
    lam = torch.log(u ** 2 / (1 - u ** 2)) / 2.0
    conv_w = dense_init((cfg.ssm_conv, w), dtype, generator, scale=0.5)
    out_proj = dense_init((w, cfg.d_model), dtype, generator)
    return RGLRU(proj_x=proj_x, proj_gate=proj_gate,
                 w_r=w_r, b_r=zeros_init((w,), torch.float32, dev),
                 w_i=w_i, b_i=zeros_init((w,), torch.float32, dev),
                 lam=torch.nn.Parameter(lam, requires_grad=False),
                 conv_w=conv_w, out_proj=out_proj)


def _causal_conv(x, w, tail=None):
    """Depthwise causal conv, no activation. x: (B, S, W), w: (K, W);
    tail: (B, K-1, W) carried state. The K shifted products are summed left
    to right in x's dtype. Returns (y, new_tail)."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return y, xp[:, -(k - 1):].clone()


def _gates(params, x):
    """log_a (B,S,W) fp32, gated input (B,S,W) fp32; in fp32 on fp32
    copies of W_r and W_i."""
    xf = x.float()
    r = torch.sigmoid(torch.einsum("bsw,wv->bsv", xf, params["w_r"].float())
                      + params["b_r"])
    i = torch.sigmoid(torch.einsum("bsw,wv->bsv", xf, params["w_i"].float())
                      + params["b_i"])
    log_a = -C_EXP * r * F.softplus(params["lam"])   # log sigma(lam)^(c r)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, beta * i * xf


def _scan(log_a, b, h0=None):
    """Inclusive scan of h_t = exp(log_a_t) h_{t-1} + b_t along axis 1 by
    doubling: pass d combines each step with the one d before it by the
    reference's combine (la + lb, ba * exp(lb) + bb), d = 1, 2, 4, ...
    exp only sees sums of log_a <= 0, so it cannot overflow."""
    if h0 is not None:
        # fold the initial state into the first step, as the reference does
        b = torch.cat([(b[:, 0] + torch.exp(log_a[:, 0]) * h0)[:, None],
                       b[:, 1:]], dim=1)
    la, h = log_a, b
    s = h.shape[1]
    for p in range(math.ceil(math.log2(s)) if s > 1 else 0):
        d = 1 << p
        h = torch.cat([h[:, :d], h[:, :-d] * torch.exp(la[:, d:])
                       + h[:, d:]], dim=1)
        if 2 * d < s:
            la = torch.cat([la[:, :d], la[:, :-d] + la[:, d:]], dim=1)
    return h


def _scan_ref(log_a, b, h0=None):
    """The plain version of _scan: the sequential recurrence, one step at
    a time from h0 (zero when None)."""
    h = (torch.zeros_like(b[:, 0]) if h0 is None else h0)
    out = []
    for t in range(b.shape[1]):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def apply(params, x, cfg, state=None):
    """Griffin recurrent block. x: (B, S, D) -> (out, new_state)."""
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, params["proj_gate"]),
                  approximate="tanh")
    u = torch.einsum("bsd,dw->bsw", x, params["proj_x"])
    tail = state["conv"] if state is not None else None
    u, new_tail = _causal_conv(u, params["conv_w"], tail)
    log_a, b = _gates(params, u)
    h0 = state["h"] if state is not None else None
    h = _scan(log_a, b, h0)
    y = h.to(x.dtype) * gate
    out = torch.einsum("bsw,wd->bsd", y, params["out_proj"])
    return out, {"h": h[:, -1].clone(), "conv": new_tail}


def decode_step(params, x, cfg, state):
    """Single-token recurrent update. x: (B, 1, D). h is rounded to x's
    dtype before the gate, as in the reference."""
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, params["proj_gate"]),
                  approximate="tanh")
    u = torch.einsum("bsd,dw->bsw", x, params["proj_x"])
    u, new_tail = _causal_conv(u, params["conv_w"], state["conv"])
    log_a, b = _gates(params, u)
    h = torch.exp(log_a[:, 0]) * state["h"] + b[:, 0]
    y = h[:, None].to(x.dtype) * gate
    out = torch.einsum("bsw,wd->bsd", y, params["out_proj"])
    return out, {"h": h, "conv": new_tail}


STATE_AXES = {"h": ("batch", "lru"), "conv": ("batch", "conv_k", "lru")}


def init_state(cfg, batch: int, dtype, device) -> dict:
    w = cfg.resolved_lru_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, w), dtype=dtype,
                                device=device)}
