"""SwiGLU feed-forward block, LLaMA-style (counterpart of
repro/models/mlp.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init


class MLP(Params):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down


def init(cfg, dtype, generator: torch.Generator) -> MLP:
    return MLP(w_gate=dense_init((cfg.d_model, cfg.d_ff), dtype, generator),
               w_up=dense_init((cfg.d_model, cfg.d_ff), dtype, generator),
               w_down=dense_init((cfg.d_ff, cfg.d_model), dtype, generator))


def apply(params, x):
    g = torch.einsum("bsd,df->bsf", x, params["w_gate"])
    u = torch.einsum("bsd,df->bsf", x, params["w_up"])
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, params["w_down"])
