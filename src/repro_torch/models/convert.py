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

Training carries trees both ways leaf for leaf: `leaf_map` gives each
port parameter's reference path and group index, `from_reference` takes
a reference-shaped tree (parameters, gradients, the optimizer's m, v and
master) to a dict by port name, `to_reference` stacks such a dict back
into the reference's layout, and `state_from_reference` builds a
trainable train state (repro_torch.train.step's layout) from a
reference one. Checkpoints cross over in place: `state_to_reference`
gives a port state in the reference's layout as tensors, and
`load_reference_state` writes such a tree, as read from disk, back into
an existing port state; neither goes through numpy's bfloat16.
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


# --------------------------------------------------------------------------
# leaf for leaf, both ways
# --------------------------------------------------------------------------

def leaf_map(model: lm.LM) -> dict:
    """Each parameter name of `model` -> (its path in the reference's
    params pytree, the group index into that leaf's leading axis or None
    for an unstacked leaf): "blocks.5.mixer.wq" of a one-block pattern is
    (("groups", 0, "mixer", "wq"), 5); a tail block's leaf is
    (("tail", j, ...), None)."""
    cfg = model.cfg
    p = len(cfg.block_pattern)
    stacked = cfg.num_layers // p * p
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "blocks":
            out[name] = (tuple(parts), None)
            continue
        i, rest = int(parts[1]), tuple(parts[2:])
        if i < stacked:
            g, slot = divmod(i, p)
            out[name] = (("groups", slot) + rest, g)
        else:
            out[name] = (("tail", i - stacked) + rest, None)
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def from_reference(tree_np, leaves: dict, device=None) -> dict:
    """A reference-shaped tree of numpy arrays -> {port name: tensor} on
    `device` (the card unless device="cpu"); `leaves` is leaf_map's."""
    device = resolve_device(device)
    out = {}
    for name, (path, g) in leaves.items():
        a = np.asarray(_at(tree_np, path))
        out[name] = _tensor(a if g is None else a[g], device).data
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def to_reference(named: dict, leaves: dict):
    """{port name: tensor} -> the reference's pytree of numpy arrays (the
    inverse of from_reference): group leaves stacked over the groups,
    dicts and tuples as lm.init makes them."""
    return _assemble({n: _numpy(t) for n, t in named.items()}, leaves,
                     np.stack)


def _assemble(named: dict, leaves: dict, stack):
    """{port name: leaf} -> the reference's pytree, group leaves joined by
    `stack` in group order."""
    stacks: dict = {}
    for name, (path, g) in leaves.items():
        stacks.setdefault(path, {})[g] = named[name]
    root: dict = {}
    for path, by_g in stacks.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (by_g[None] if None in by_g else
                          stack([by_g[g] for g in sorted(by_g)]))

    def tuples(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return tuple(tuples(node[i]) for i in range(len(node)))
        return {k: tuples(v) for k, v in node.items()}

    root = tuples(root)
    root.setdefault("groups", ())
    root.setdefault("tail", ())
    return root


def state_from_reference(state_np, cfg, device=None) -> dict:
    """A reference train state ({"params", "opt": {"m", "v", "count",
    "master"?}, "step"}, numpy leaves) -> the port's, trainable: the LM
    with requires_grad set, m / v / master as {port name: fp32 tensor}."""
    device = resolve_device(device)
    model = params_from_reference(state_np["params"], cfg, device)
    model.requires_grad_(True)
    leaves = leaf_map(model)
    ref_opt = state_np["opt"]
    opt = {k: from_reference(ref_opt[k], leaves, device)
           for k in ("m", "v", "master") if k in ref_opt}
    opt["count"] = torch.tensor(int(np.asarray(ref_opt["count"])),
                                dtype=torch.int32, device=device)
    step = torch.tensor(int(np.asarray(state_np["step"])),
                        dtype=torch.int32, device=device)
    return {"params": model, "opt": opt, "step": step}


def state_to_reference(state: dict, device=None) -> dict:
    """The port's train state as the reference's tree of tensors,
    {"params", "opt": {"m", "v", "count", "master"?}, "step"}, on `device`
    (by default where the state lives): each group leaf stacked over its
    groups as leaf_map says (a copy), every other leaf the state's own
    tensor, detached, when it already lives there. This is the layout the
    reference checkpoints, so a CheckpointManager writes the reference's
    files from it."""
    model = state["params"]
    leaves = leaf_map(model)
    dev = state["step"].device if device is None else torch.device(device)

    def tree(named):
        return _assemble({n: t.detach().to(dev) for n, t in named.items()},
                         leaves, torch.stack)

    opt = state["opt"]
    ref_opt = {k: tree(opt[k]) for k in ("m", "v", "master") if k in opt}
    ref_opt["count"] = opt["count"].detach().to(dev)
    return {"params": tree(dict(model.named_parameters())), "opt": ref_opt,
            "step": state["step"].detach().to(dev)}


def shardings_to_reference(state: dict, shardings: dict) -> dict:
    """The shardings of state_to_reference(state)'s leaves, from the
    state's own (dist.sharding.sharding_tree over it): a stacked group
    leaf takes its layers' sharding with an unsplit leading dim, so on a
    rank mesh the stack of this rank's blocks is its block of the
    stacked leaf."""
    leaves = leaf_map(state["params"])

    def tree(named):
        return _assemble(dict(named), leaves,
                         lambda shs: shs[0].stacked(len(shs)))

    opt = shardings["opt"]
    ref_opt = {k: tree(opt[k]) for k in ("m", "v", "master") if k in opt}
    ref_opt["count"] = opt["count"]
    return {"params": tree(shardings["params"]), "opt": ref_opt,
            "step": shardings["step"]}


@torch.no_grad()
def load_reference_state(state: dict, tree) -> dict:
    """Write a reference-shaped train state of tensors (as
    CheckpointManager.restore reads it from disk) into the port's `state`
    in place: every parameter and its m, v and master slice, the count and
    the step. Returns `state`."""
    model = state["params"]
    opt = state["opt"]
    named = dict(model.named_parameters())
    for name, (path, g) in leaf_map(model).items():
        for dst, src in [(named[name], tree["params"])] + [
                (opt[k][name], tree["opt"][k]) for k in ("m", "v", "master")
                if k in opt]:
            leaf = _at(src, path)
            dst.copy_(leaf if g is None else leaf[g])
    opt["count"].copy_(tree["opt"]["count"])
    state["step"].copy_(tree["step"])
    return state
