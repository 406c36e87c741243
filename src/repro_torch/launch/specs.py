"""Abstract input specs + shardings for every step kind (counterpart of
repro/launch/specs.py).

This is the no-allocation layer: every model input, train state and
decode cache is described by tensors on the meta device (the port's
jax.eval_shape: shapes and dtypes, no storage, no draw) and mapped to
NamedShardings through the logical-axis rules.

The step builders return (fn, abstract args). On one card every position
of the mesh lives on one device, so `fn` does what the reference's
in_shardings and donation do there: it checks each argument against its
sharding (on `mesh.device`, each spec dividing the tensor's shape), runs
the port's step under `use_rules(mesh, rules)`, and updates the train
state or the caches in place where the reference donates them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.dist import sharding as shlib
from repro_torch.models import lm
from repro_torch.models.common import dtype_of
from repro_torch.serve import engine
from repro_torch.train import optim, step as train_step_lib

META = torch.device("meta")


def rules_for(cfg: ArchConfig, shape: ShapeSpec,
              extra: dict | None = None) -> dict:
    """Per-cell logical-axis rule overrides.

    `extra` (a strategy's overrides, repro_torch.dist.strategies) wins
    last.
    """
    rules: dict = {}
    # FSDP over data (+pod when present) — needed to fit >=100B optimizer
    # state; harmless elsewhere.
    rules["embed"] = ("data", "pod")
    if shape.name == "long_500k":
        # batch=1: the data axis is useless for batch; use it for split-K
        # over the KV ring / sequence instead.
        rules["batch"] = None
        rules["kv_seq"] = ("data", "model")
    rules.update(extra or {})
    return rules


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec):
    """Training batch abstract values + logical axes."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.input_mode == "tokens":
        inputs = _abstract((b, s), torch.int32)
        in_axes = "batch seq"
    else:
        inputs = _abstract((b, s, cfg.d_model), dtype_of(cfg.dtype))
        in_axes = "batch seq act_embed"
    return ({"inputs": inputs, "labels": _abstract((b, s), torch.int32)},
            {"inputs": in_axes, "labels": "batch seq"})


def state_specs(cfg: ArchConfig, opt_cfg: optim.AdamWConfig):
    """The train state on the meta device and its axes."""
    return train_step_lib.init_state(0, cfg, opt_cfg, device=META)


def params_specs(cfg: ArchConfig):
    params = lm.init(cfg, device=META)
    return params, lm.param_axes(params)


def cache_specs(cfg: ArchConfig, batch: int, max_len: int):
    caches = lm.init_caches(cfg, batch, max_len, dtype_of(cfg.dtype),
                            device=META)
    return caches, lm.cache_axes(cfg)


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec):
    b = shape.global_batch
    if cfg.input_mode == "tokens":
        return _abstract((b, 1), torch.int32), "batch seq"
    return (_abstract((b, 1, cfg.d_model), dtype_of(cfg.dtype)),
            "batch seq act_embed")


def shardings(tree, axes, mesh, rules):
    return shlib.sharding_tree(tree, axes, mesh, rules)


def replicated(mesh):
    return shlib.NamedSharding(mesh, shlib.PartitionSpec())


def _refill(caches: list, new: list) -> list:
    """The reference donates the caches: put each layer's new cache into
    the caller's list (attention rings are already written in place)."""
    caches[:] = new
    return caches


# --------------------------------------------------------------------------
# step builders used by the train and serve launchers
# --------------------------------------------------------------------------

def build_train(cfg, shape, mesh, opt_cfg=None, num_microbatches: int = 1,
                rules_extra: dict | None = None):
    """Returns (fn, abstract_args) for train_step(state, batch); fn
    updates `state` in place and returns (state, metrics)."""
    opt_cfg = opt_cfg or optim.AdamWConfig()
    rules = rules_for(cfg, shape, rules_extra)
    state, state_axes = state_specs(cfg, opt_cfg)
    batch, batch_axes = batch_specs(cfg, shape)
    state_sh = shardings(state, state_axes, mesh, rules)
    batch_sh = shardings(batch, batch_axes, mesh, rules)
    step = train_step_lib.make_train_step(cfg, opt_cfg, num_microbatches)

    def fn(state, batch):
        shlib.check_placed(state, state_sh)
        shlib.check_placed(batch, batch_sh)
        with shlib.use_rules(mesh, rules):
            new, metrics = step(state, batch)
        state.update(new)
        return state, metrics

    return fn, (state, batch)


def build_prefill(cfg, shape, mesh, rules_extra: dict | None = None):
    """prefill_step(params, inputs, caches) -> (last logits, caches)."""
    rules = rules_for(cfg, shape, rules_extra)
    b, s = shape.global_batch, shape.seq_len
    params, p_axes = params_specs(cfg)
    caches, c_axes = cache_specs(cfg, b, s)
    batch, batch_axes = batch_specs(cfg, shape)
    p_sh = shardings(params, p_axes, mesh, rules)
    c_sh = shardings(caches, c_axes, mesh, rules)
    in_sh = shardings(batch["inputs"], batch_axes["inputs"], mesh, rules)
    step = engine.make_prefill_step(cfg)

    def fn(params, inputs, caches):
        shlib.check_placed(params, p_sh)
        shlib.check_placed(inputs, in_sh)
        shlib.check_placed(caches, c_sh)
        with shlib.use_rules(mesh, rules):
            logits, new = step(params, inputs, caches)
        return logits, _refill(caches, new)

    return fn, (params, batch["inputs"], caches)


def build_serve(cfg, shape, mesh, rules_extra: dict | None = None):
    """serve_step(params, inputs, cache_len, caches, key) -> (next token,
    logits, caches). `key` is the reference's (2,) uint32 key slot: a
    torch.Generator, or a tensor of that shape (greedy decoding draws
    nothing)."""
    rules = rules_for(cfg, shape, rules_extra)
    b, s = shape.global_batch, shape.seq_len
    params, p_axes = params_specs(cfg)
    caches, c_axes = cache_specs(cfg, b, s)
    inputs, in_axes = decode_input_specs(cfg, shape)
    cache_len = _abstract((b,), torch.int32)
    key = _abstract((2,), torch.uint32)
    p_sh = shardings(params, p_axes, mesh, rules)
    c_sh = shardings(caches, c_axes, mesh, rules)
    in_sh = shardings(inputs, in_axes, mesh, rules)
    len_sh = shardings(cache_len, "batch", mesh, rules)
    step = engine.make_serve_step(cfg)

    def fn(params, inputs, cache_len, caches, key):
        shlib.check_placed(params, p_sh)
        shlib.check_placed(inputs, in_sh)
        shlib.check_placed(cache_len, len_sh)
        shlib.check_placed(caches, c_sh)
        if isinstance(key, torch.Tensor):
            shlib.check_placed(key, replicated(mesh))
            key = None
        with shlib.use_rules(mesh, rules):
            nxt, logits, new = step(params, inputs, cache_len, caches, key)
        return nxt, logits, _refill(caches, new)

    return fn, (params, inputs, cache_len, caches, key)


def build_step(cfg, shape, mesh, rules_extra: dict | None = None, **kw):
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, rules_extra=rules_extra, **kw)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, rules_extra=rules_extra)
    return build_serve(cfg, shape, mesh, rules_extra=rules_extra)
