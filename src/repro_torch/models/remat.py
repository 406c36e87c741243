"""Activation rematerialisation of one block (counterpart of the
jax.checkpoint in repro/models/lm.py::_block_fn).

`checkpoint(fn, mode, *args)` runs `fn(*args)` under
torch.utils.checkpoint's non-reentrant checkpoint. Its backward runs the
block's forward again (the recompute) to rebuild what the forward did not
keep:

- "dots": the reference's `dots_with_no_batch_dims_saveable`. The outputs
  of products without batch dimensions are kept (a selective checkpoint,
  `create_selective_checkpoint_contexts`); everything else is recomputed.
- any other mode: only the block's inputs are kept (the reference's
  `jax.checkpoint` without a policy).

How a product is classified. JAX reads a dot_general's batch dimensions
from its dimension numbers; at the aten level they are gone
(`einsum("bsd,df->bsf")` and an attention product at batch x heads = 1
both lower to a batch-1 `bmm`). So the classification is made where the
dimensions are still named:

- `torch.einsum` is read from its equation (`_Products`, a function mode
  active while the block runs under "dots"): a label in every operand and
  in the output is a batch dimension, as in a dot_general;
- an `mm` / `addmm` (2-D operands) has none; a `bmm` / `baddbmm` issued
  by anything but a batch-free einsum (MoE's expert products over E) has
  one;
- an op run with grad mode off is never kept: that is a kernel op's
  forward (`_Flash5`, `_SSD`), which the reference sees as one
  pallas_call, not a dot. The recompute therefore launches kernels 11
  and 12 again under both modes.

Which kept products. JAX keeps a saveable value only where the backward,
or the recompute of a value the backward reads, needs it (the MLP's down
projection, whose output only joins the residual stream, is not kept). A
selective checkpoint keeps every product its policy names, so the policy
names only the needed ones: `needed_products` runs the block once on the
meta device (nothing computed, no kernel, no count) with a saved-tensor
hook and a recorder of every op's inputs and outputs, and walks back from
each tensor autograd saved to the saveable products it is made from. The
answer, ordinals among the block's saveable products, is cached per
(config, input geometry, dtypes).

Counting. The reference traces a checkpointed block once, so its
trace-time counters see each op once a step. The recompute therefore runs
under `kernels.dispatch.muted()` and `dist.sharding.uncounted()`; the
kernel modules' own LAUNCHES count the real second launch. It re-enters
the sharding rules that were active in the block's forward (on CUDA the
backward runs on autograd's device thread, where the thread-local rules
of the forward are not active), so its constraints resolve, check
placement and run the constraint hooks (the dry run's tracer) on every
device.

The blocks draw no random numbers, so checkpoint's RNG stash is off
(`preserve_rng_state=False`): with it on, every checkpointed block reads
and restores the device's generator state, a host cost a layer on the
host-bound mamba2 step.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import threading

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint as
                                    _checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.dist import sharding
from repro_torch.kernels import dispatch

aten = torch.ops.aten

# products whose operands are 2-D: no batch dimension
_PLAIN_DOTS = frozenset({aten.mm.default, aten.addmm.default,
                         aten.mv.default, aten.dot.default})
# products with a leading batch dimension, unless a batch-free einsum
# issued them
_BATCH_DOTS = frozenset({aten.bmm.default, aten.baddbmm.default})

_STATE = threading.local()


def einsum_has_batch(equation: str) -> bool:
    """True if a label (or the ellipsis) appears in every operand and in
    the output: a batch dimension of the dot_general JAX would emit."""
    lhs, _, out = equation.replace(" ", "").partition("->")
    ops = lhs.split(",")

    def labels(s):
        return set(s.replace("...", "")) | ({"..."} if "..." in s else set())

    common = set.intersection(*(labels(o) for o in ops))
    return bool(common & labels(out))


class _Products(TorchFunctionMode):
    """Marks the aten products of a batch-free torch.einsum as such."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.einsum or not args or not isinstance(args[0],
                                                                 str):
            return func(*args, **kwargs)
        prev = getattr(_STATE, "batch_free", False)
        _STATE.batch_free = not einsum_has_batch(args[0])
        try:
            return func(*args, **kwargs)
        finally:
            _STATE.batch_free = prev


def saveable(func) -> bool:
    """Whether `func`'s output is a product without batch dimensions
    (dots_with_no_batch_dims_saveable's rule); see the module docstring."""
    if not torch.is_grad_enabled():
        return False
    if func in _PLAIN_DOTS:
        return True
    return func in _BATCH_DOTS and getattr(_STATE, "batch_free", False)


# --------------------------------------------------------------------------
# which saveable products the backward needs
# --------------------------------------------------------------------------

def _key(t) -> tuple:
    return (t.untyped_storage()._cdata, tuple(t.shape), t.stride(),
            t.storage_offset())


def _tensors(tree) -> list:
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


class _Recorder(TorchDispatchMode):
    """Each op's tensor inputs and outputs, by storage and geometry; keeps
    every tensor alive so no key is reused while it runs."""

    def __init__(self):
        super().__init__()
        self.producer = {}      # key -> node index
        self.nodes = []         # (saveable ordinal or None, [input nodes])
        self.n_saveable = 0
        self.keep = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [self.producer.get(_key(t)) for t in _tensors((args, kwargs))]
        ordinal = None
        if saveable(func):
            ordinal = self.n_saveable
            self.n_saveable += 1
        self.nodes.append((ordinal, [i for i in ins if i is not None]))
        for t in _tensors(out):
            self.producer[_key(t)] = len(self.nodes) - 1
            self.keep.append(t)
        return out


def _meta_like(x):
    if isinstance(x, (list, tuple)):
        return type(x)(_meta_like(v) for v in x)
    if isinstance(x, dict):
        return {k: _meta_like(v) for k, v in x.items()}
    if isinstance(x, torch.nn.Module):
        memo = {}
        for t in list(x.parameters()) + list(x.buffers()):
            m = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                    device="meta")
            memo[id(t)] = (torch.nn.Parameter(m, t.requires_grad)
                           if isinstance(t, torch.nn.Parameter) else m)
        return copy.deepcopy(x, memo)
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta").requires_grad_(
            x.requires_grad)
    return x


def _signature(x) -> tuple:
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, torch.nn.Module):
        return tuple((n, tuple(p.shape), p.dtype, p.requires_grad)
                     for n, p in x.named_parameters())
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.requires_grad)
    return x


_NEEDED: dict = {}


def _probe(fn, args) -> frozenset:
    """Ordinals of the saveable products that the backward needs (see the
    module docstring), from one forward on the meta device."""
    margs = [_meta_like(a) for a in args]
    rec = _Recorder()
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with dispatch.muted(), _Products(), rec, \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*margs)
    arg_keys = {_key(t) for t in _tensors(margs)} | {
        _key(p) for a in margs if isinstance(a, torch.nn.Module)
        for p in a.parameters()}
    needed, seen = set(), set()
    stack = [rec.producer.get(_key(t)) for t in saved
             if _key(t) not in arg_keys]
    while stack:
        i = stack.pop()
        if i is None or i in seen:
            continue
        seen.add(i)
        ordinal, ins = rec.nodes[i]
        if ordinal is not None:
            needed.add(ordinal)
        else:
            stack.extend(ins)
    return frozenset(needed)


def needed_products(fn, key, args) -> frozenset:
    """`_probe`'s answer for `fn` on `args`, cached under `key` and the
    arguments' geometry. The probe runs on a thread of its own, so that no
    mode of the caller (the dry run's cost tracer, a selective
    checkpoint) sees its ops and no sharding rule counts its
    constraints."""
    full = (key, tuple(_signature(a) for a in args))
    got = _NEEDED.get(full)
    if got is None:
        box = {}

        def run():
            try:
                box["out"] = _probe(fn, args)
            except BaseException as e:      # re-raised on the caller
                box["err"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if "err" in box:
            raise box["err"]
        got = _NEEDED[full] = box["out"]
    return got


# --------------------------------------------------------------------------
# the checkpoint
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _recomputing(rules):
    """The recompute: muted and uncounted, under the sharding rules that
    were active in the forward. Those live in a thread-local stack, and
    on CUDA autograd runs the backward, so the recompute, on a device
    thread of its own."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(dispatch.muted())
        stack.enter_context(sharding.uncounted())
        if rules is not None:
            stack.enter_context(sharding.use_rules(*rules))
        yield


def _contexts(mode, needed):
    rules = sharding.current_rules()
    if mode != "dots":
        return contextlib.nullcontext(), _recomputing(rules)
    count = {False: 0, True: 0}

    def policy(ctx, func, *args, **kwargs):
        if not saveable(func):
            return CheckpointPolicy.PREFER_RECOMPUTE
        i = count[ctx.is_recompute]
        count[ctx.is_recompute] += 1
        return (CheckpointPolicy.MUST_SAVE if i in needed
                else CheckpointPolicy.PREFER_RECOMPUTE)

    fwd, rec = create_selective_checkpoint_contexts(policy)

    @contextlib.contextmanager
    def forward():
        with _Products(), fwd:
            yield

    @contextlib.contextmanager
    def recompute():
        with _recomputing(rules), _Products(), rec:
            yield

    return forward(), recompute()


def checkpoint(fn, mode: str, key, *args):
    """`fn(*args)` under the checkpoint of `mode` ("dots", or anything
    else for the whole block); `key` names `fn` for the cache of
    needed products (hashable, e.g. the config and the block kind)."""
    needed = needed_products(fn, key, args) if mode == "dots" else None
    return _checkpoint(fn, *args, use_reentrant=False,
                       preserve_rng_state=False,
                       context_fn=functools.partial(_contexts, mode, needed))
