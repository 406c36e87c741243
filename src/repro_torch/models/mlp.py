"""SwiGLU feed-forward block, LLaMA-style (counterpart of
repro/models/mlp.py). Over ranks that split the hidden dim ("mlp"),
w_gate and w_up are column-parallel and w_down row-parallel: a rank's
partial product is summed over those ranks, and under autograd the
gradient of x (sharding.enter_over) too."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as shlib
from repro_torch.models.common import Params, dense_init


class MLP(Params):
    AXES = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}

    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down


def init(cfg, dtype, generator: torch.Generator) -> MLP:
    return MLP(w_gate=dense_init((cfg.d_model, cfg.d_ff), dtype, generator),
               w_up=dense_init((cfg.d_model, cfg.d_ff), dtype, generator),
               w_down=dense_init((cfg.d_ff, cfg.d_model), dtype, generator))


def apply(params, x):
    w_gate = params["w_gate"]
    x = shlib.enter_over(x, shlib.split_axes(w_gate, 1))
    g = torch.einsum("bsd,df->bsf", x, w_gate)
    del w_gate
    u = torch.einsum("bsd,df->bsf", x, params["w_up"])
    w_down = params["w_down"]
    out = torch.einsum("bsf,fd->bsd", F.silu(g) * u, w_down)
    return shlib.reduce_over(out, shlib.split_axes(w_down, 0))
