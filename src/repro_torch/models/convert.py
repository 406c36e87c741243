"""Weights of a reference model (repro.models.lm.init's params pytree,
as numpy arrays) -> the port's LM module.

The reference stacks same-kind blocks over layers (`params["groups"][i]`
holds pattern slot i of every pattern group, leading axis = group) and
keeps a tail of unstacked blocks; the port's blocks are a list in
execution order: group 0's pattern, group 1's, ..., then the tail. An
"ssd" block carries its mixer's seven leaves and no ffn, an "rglru"
block its mixer's nine; a feed-forward is "ffn" (SwiGLU) or "moe" (the
router, the three expert stacks and, aux-free, the router bias); a tied
config has no "lm_head". bf16 arrays (ml_dtypes.bfloat16, which
torch.from_numpy rejects) go through float32, which holds them exactly.
This module imports no JAX: the caller hands it numpy arrays
(`jax.tree.map(np.asarray, params)`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention, blocks, lm, mlp, moe, rglru, ssm


def _tensor(a, device) -> torch.nn.Parameter:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))       # a writable copy
    return torch.nn.Parameter(t.to(device), requires_grad=False)


def _block(tree, g, kind: str, cfg, device) -> blocks.Block:
    blocks._check_kind(kind)

    def take(a):
        return _tensor(a if g is None else np.asarray(a)[g], device)

    mix = tree["mixer"]
    if kind == "ssd":
        mixer = ssm.SSM(*(take(mix[n]) for n in ssm.LEAVES))
    elif kind == "rglru":
        mixer = rglru.RGLRU(*(take(mix[n]) for n in rglru.LEAVES))
    else:
        mixer = attention.Attention(*(take(mix[n])
                                      for n in ("wq", "wk", "wv", "wo")))
    if "moe" in tree:
        m = tree["moe"]
        bias = take(m["router_bias"]) if "router_bias" in m else None
        return blocks.Block(kind, take(tree["norm1"]), mixer,
                            take(tree["norm2"]),
                            moe=moe.MoE(*(take(m[n]) for n in moe.LEAVES),
                                        router_bias=bias))
    if "ffn" in tree:
        ffn = mlp.MLP(*(take(tree["ffn"][n])
                        for n in ("w_gate", "w_up", "w_down")))
        return blocks.Block(kind, take(tree["norm1"]), mixer,
                            take(tree["norm2"]), ffn=ffn)
    return blocks.Block(kind, take(tree["norm1"]), mixer)


def params_from_reference(params_np, cfg, device=None) -> lm.LM:
    """The reference pytree `params_np` (numpy leaves) of config `cfg` as
    an LM on `device` (the card unless device="cpu")."""
    device = resolve_device(device)
    p = len(cfg.block_pattern)
    n_groups, tail = divmod(cfg.num_layers, p)
    layers = [_block(params_np["groups"][i], g, kind, cfg, device)
              for g in range(n_groups)
              for i, kind in enumerate(cfg.block_pattern)]
    layers += [_block(params_np["tail"][j], None, cfg.block_pattern[j], cfg,
                      device) for j in range(tail)]
    return lm.LM(
        cfg,
        embed=(_tensor(params_np["embed"], device)
               if "embed" in params_np else None),
        lm_head=(_tensor(params_np["lm_head"], device)
                 if "lm_head" in params_np else None),
        final_norm=_tensor(params_np["final_norm"], device), layers=layers)
