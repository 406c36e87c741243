"""Mamba-2 SSD mixer (state-space duality, arXiv:2405.21060; counterpart
of repro/models/ssm.py).

Prefill runs the chunked dual form: block-diagonal (intra-chunk)
attention-like products plus a low-rank state recurrence from chunk to
chunk, in one call of repro_torch.kernels.ssd_chunk.ops.ssd (the CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor). Decode is the
O(1) recurrent update, plain tensor work as in the reference. Like the
reference these return new state tensors instead of writing the cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.models.common import Params, dense_init, rms_norm

# the mixer's leaves, in the reference's names
LEAVES = ("in_proj", "conv_w", "A_log", "dt_bias", "D", "gate_norm",
          "out_proj")


class SSM(Params):
    def __init__(self, in_proj, conv_w, A_log, dt_bias, D, gate_norm,
                 out_proj):
        super().__init__()
        self.in_proj, self.conv_w = in_proj, conv_w
        self.A_log, self.dt_bias, self.D = A_log, dt_bias, D
        self.gate_norm, self.out_proj = gate_norm, out_proj


def _dims(cfg):
    din = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    conv_dim = din + 2 * n          # x, B, C go through the conv (groups=1)
    return din, n, h, conv_dim


def _param(t: torch.Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(t, requires_grad=False)


def init(cfg, dtype, generator: torch.Generator) -> SSM:
    """Random weights drawn on `generator` in the reference's order
    (in_proj, conv_w, out_proj); A_log is log(linspace(1, 16, H)), dt_bias
    and gate_norm zeros, D ones, all float32."""
    din, n, h, conv_dim = _dims(cfg)
    dev = generator.device
    d_in_proj = 2 * din + 2 * n + h
    in_proj = dense_init((cfg.d_model, d_in_proj), dtype, generator)
    conv_w = dense_init((cfg.ssm_conv, conv_dim), dtype, generator,
                        scale=0.5)
    out_proj = dense_init((din, cfg.d_model), dtype, generator)
    f32 = dict(dtype=torch.float32, device=dev)
    return SSM(in_proj=in_proj, conv_w=conv_w,
               A_log=_param(torch.log(torch.linspace(1.0, 16.0, h, **f32))),
               dt_bias=_param(torch.zeros((h,), **f32)),
               D=_param(torch.ones((h,), **f32)),
               gate_norm=_param(torch.zeros((din,), **f32)),
               out_proj=out_proj)


def _causal_conv(x, w, tail=None):
    """Depthwise causal conv. x: (B, S, C), w: (K, C). tail: (B, K-1, C)
    carried state for decode. Returns (y, new_tail)."""
    k = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return F.silu(y), xp[:, -(k - 1):]


def _split_proj(zxbcdt, cfg):
    din, n, h, _ = _dims(cfg)
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:2 * din + 2 * n]
    dt = zxbcdt[..., 2 * din + 2 * n:]
    return z, xbc, dt


def _ssd_chunked(xh, dt, a_log, bm, cm, cfg, init_state=None, mode=None):
    """Chunked SSD scan.

    xh: (B, S, H, P) inputs; dt: (B, S, H) fp32 post-softplus;
    bm/cm: (B, S, N); returns (y (B,S,H,P), final_state (B,H,N,P)). A
    sequence shorter than a chunk is one chunk; a longer one must be a
    whole number of chunks, as in the reference."""
    s = xh.shape[1]
    q = min(cfg.ssm_chunk, s)
    assert s % q == 0, (s, q)
    return ssd_ops.ssd(xh, dt, a_log, bm, cm, q, init_state=init_state,
                       mode=mode)


def apply(params, x, cfg, state=None, mode=None):
    """Full-sequence SSD block. x: (B, S, D). state: optional dict from a
    previous segment (chunk-streaming / decode handoff). `mode` selects
    the scan's dispatch (repro_torch.kernels.dispatch).
    Returns (out, new_state)."""
    din, n, h, _ = _dims(cfg)
    p = cfg.ssm_head_dim
    zxbcdt = torch.einsum("bsd,de->bse", x, params["in_proj"])
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    conv_tail = state["conv"] if state is not None else None
    xbc, new_tail = _causal_conv(xbc, params["conv_w"], conv_tail)
    xs = xbc[..., :din]
    bm = xbc[..., din:din + n]
    cm = xbc[..., din + n:]
    dt = F.softplus(dt.float() + params["dt_bias"])
    xh = xs.reshape(*xs.shape[:-1], h, p)
    init_state = state["ssm"] if state is not None else None
    y, final = _ssd_chunked(xh, dt, params["A_log"], bm, cm, cfg,
                            init_state, mode=mode)
    y = y + (params["D"][:, None] * xh.float()).to(y.dtype)
    y = y.reshape(*x.shape[:-1], din)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["gate_norm"],
                 cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"])
    return out, {"ssm": final, "conv": new_tail}


def decode_step(params, x, cfg, state):
    """Single-token recurrent update. x: (B, 1, D)."""
    din, n, h, _ = _dims(cfg)
    p = cfg.ssm_head_dim
    zxbcdt = torch.einsum("bsd,de->bse", x, params["in_proj"])
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc, new_tail = _causal_conv(xbc, params["conv_w"], state["conv"])
    xs, bm, cm = (xbc[..., :din], xbc[..., din:din + n], xbc[..., din + n:])
    dt = F.softplus(dt.float() + params["dt_bias"])[:, 0]
    a = torch.exp(dt * -torch.exp(params["A_log"]))            # (B,H)
    xh = xs[:, 0].reshape(-1, h, p).float()                     # (B,H,P)
    bx = torch.einsum("bn,bhp->bhnp", bm[:, 0].float(), xh * dt[..., None])
    new = state["ssm"] * a[..., None, None] + bx
    y = torch.einsum("bn,bhnp->bhp", cm[:, 0].float(), new)
    y = y + params["D"][:, None] * xh
    y = y.reshape(-1, 1, din).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["gate_norm"],
                 cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"])
    return out, {"ssm": new, "conv": new_tail}


def init_state(cfg, batch: int, dtype, device) -> dict:
    din, n, h, conv_dim = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, h, n, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }
