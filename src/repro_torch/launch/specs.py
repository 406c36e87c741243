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
state or the caches in place where the reference donates them. `fn`
carries the reference's jit arguments as attributes: `in_shardings` (one
sharding tree an argument) and `donate_argnums` (the arguments updated in
place), which the dry run (repro_torch.launch.dryrun) reads.

On a mesh of ranks (launch.mesh.RankMesh) the arguments are this rank's
blocks (lm.init / lm.init_caches / train.step.init_state with `mesh=`,
or train.step.place_blocks of whole leaves), checked against the
shardings' global shapes. Every step then computes tensor- and
expert-parallel over "model" as the reference's layout implies
(repro_torch.dist.sharding: at_use, reduce_over, gather_over,
enter_over, mean_over), on a rank's rows of a batch split over the
batch's axes: the serve steps under torch.no_grad(), every rank
returning the global tokens and logits (a prompt may be shorter than
the cell's seq_len, the caches' length), and the train step with the
collectives' adjoints (train.step.make_rank_train_step). The serve
steps name the caches' shardings too (use_rules(rings=)), so a ring
split over its slots ("kv_seq": 2d_splitcache, long_500k) decodes
split-K and rows of q split over "cp_seq" (the cp strategy) attend as
context parallelism (models.attention); no rank gathers a K/V ring leaf.
A rule that splits the "seq" dim itself over ranks (no strategy sets
one) raises NotImplementedError, and so does a batch split over an axis
that also splits a parameter.
"""
from __future__ import annotations

import contextlib

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


def replicated(mesh, shape=None):
    return shlib.NamedSharding(mesh, shlib.PartitionSpec(), shape)


def _split_on_ranks(mesh, rules, p_sh, in_sh, kind="serve") -> dict | None:
    """A `kind` step's `use_rules(split=)` on a rank mesh (the batch's
    axes, from the inputs' sharding), or None on a virtual mesh. Raises
    NotImplementedError for rules that split the "seq" dim over ranks
    (the ring's and q's sequence dims, "kv_seq" and "cp_seq", split;
    "kv_full" only ever replicates K/V, whole on every rank), and for a
    batch split over an axis that also splits a parameter."""
    if mesh.group is None:
        return None
    rule = dict(shlib.DEFAULT_RULES, **rules).get("seq")
    axes = () if rule is None else (rule,) if isinstance(rule, str) \
        else tuple(rule)
    split = [a for a in axes if mesh.shape.get(a, 1) > 1]
    if split:
        raise NotImplementedError(
            f"the {kind} step on ranks with 'seq' split over {split}: the "
            f"rank steps split a sequence as 'kv_seq' (the ring) or "
            f"'cp_seq' (q's rows)")
    batch = in_sh.dim_axes(0)
    clash = sorted({a for sh in p_sh.values() for _, axes in sh.splits()
                    for a in axes} & set(batch) & set(shlib.COMPUTE_AXES))
    if clash:
        raise NotImplementedError(
            f"the batch and parameters both split over {clash}")
    return {"batch": batch} if batch else None


def _refill(caches: list, new: list) -> list:
    """The reference donates the caches: put each layer's new cache into
    the caller's list (attention rings are already written in place)."""
    caches[:] = new
    return caches


@contextlib.contextmanager
def _serving(mesh, rules, split, params, p_sh, caches, c_sh):
    """The serve steps' context: use_rules(mesh, rules) on a virtual mesh;
    on ranks also the batch's `split`, the parameters' shardings (at_use)
    and the caches' (`rings`: each leaf's split, read by attention),
    under torch.no_grad()."""
    if mesh.group is None:
        with shlib.use_rules(mesh, rules):
            yield
        return
    leaves = {id(p): p_sh[n] for n, p in params.named_parameters()}
    rings = {id(t): sh[k] for c, sh in zip(caches, c_sh)
             for k, t in c.items()}
    with torch.no_grad(), shlib.use_rules(mesh, rules, split, leaves,
                                          rings):
        yield


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
    split = _split_on_ranks(mesh, rules, state_sh["params"],
                            batch_sh["labels"], "train")
    if mesh.group is None:
        step = train_step_lib.make_train_step(cfg, opt_cfg, num_microbatches)
    else:
        step = train_step_lib.make_rank_train_step(
            cfg, opt_cfg, mesh, state_sh["params"],
            batch_sh["labels"].dim_axes(0), num_microbatches)

    def fn(state, batch):
        shlib.check_placed(state, state_sh)
        shlib.check_placed(batch, batch_sh)
        # on ranks the parameters are read as blocks (at_use); one rank
        # holds every leaf whole and computes as one position
        leaves = None if mesh.group is None or mesh.size == 1 else {
            id(p): state_sh["params"][n]
            for n, p in state["params"].named_parameters()}
        with shlib.use_rules(mesh, rules, split, leaves):
            new, metrics = step(state, batch)
        state.update(new)
        return state, metrics

    fn.in_shardings, fn.donate_argnums = (state_sh, batch_sh), (0,)
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
    split = _split_on_ranks(mesh, rules, p_sh, in_sh)
    step = engine.make_prefill_step(cfg)

    def fn(params, inputs, caches):
        shlib.check_placed(params, p_sh)
        if mesh.group is None:
            shlib.check_placed(inputs, in_sh)
        else:                       # a prompt of any length up to s
            shlib.check_placed(inputs, shlib.NamedSharding(
                mesh, in_sh.spec, (b,) + tuple(inputs.shape[1:])))
        shlib.check_placed(caches, c_sh)
        with _serving(mesh, rules, split, params, p_sh, caches, c_sh):
            logits, new = step(params, inputs, caches)
        return logits, _refill(caches, new)

    fn.in_shardings, fn.donate_argnums = (p_sh, in_sh, c_sh), (2,)
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
    key_sh = replicated(mesh, tuple(key.shape))
    split = _split_on_ranks(mesh, rules, p_sh, in_sh)
    step = engine.make_serve_step(cfg)

    def fn(params, inputs, cache_len, caches, key):
        shlib.check_placed(params, p_sh)
        shlib.check_placed(inputs, in_sh)
        shlib.check_placed(cache_len, len_sh)
        shlib.check_placed(caches, c_sh)
        if isinstance(key, torch.Tensor):
            shlib.check_placed(key, key_sh)
            key = None
        with _serving(mesh, rules, split, params, p_sh, caches, c_sh):
            nxt, logits, new = step(params, inputs, cache_len, caches, key)
        return nxt, logits, _refill(caches, new)

    fn.in_shardings = (p_sh, in_sh, len_sh, c_sh, key_sh)
    fn.donate_argnums = (3,)
    return fn, (params, inputs, cache_len, caches, key)


def build_step(cfg, shape, mesh, rules_extra: dict | None = None, **kw):
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, rules_extra=rules_extra, **kw)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, rules_extra=rules_extra)
    return build_serve(cfg, shape, mesh, rules_extra=rules_extra)
