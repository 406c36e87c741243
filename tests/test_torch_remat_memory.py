"""What a checkpointed block of the port keeps, and what its recompute
counts (repro_torch.models.remat), against the reference, on the CPU.

- Residuals: the storages one checkpointed block's forward leaves alive
  beyond its inputs and outputs, as a multiset of (element count, dtype),
  equal to `jax._src.ad_checkpoint.saved_residuals` of the reference's
  `_block_fn` under "dots" and under "block", for every block kind of the
  train families and a B = KVH = G = 1 attention block (where an
  attention product and a projection both lower to a batch-1 bmm).
  JAX's residuals "from a constant" are left out: they are the
  closed-over positions, which the port passes as an argument, and
  rope's numpy tables, which the port keeps in a cache.
- Counting: dispatch.launch_counts() and logical_constraint calls of a
  step equal across modes and equal to the reference's trace-time counts;
  the recompute is muted, and the constraint hooks still see it, under
  the forward's rules also where the backward runs on another thread.
- No checkpoint under torch.no_grad(): prefill and eval.
- The dry run on meta tensors: a reduced cell's temp peak falls under
  "block", its flops grow by exactly one recompute of every block, and
  the dp_noremat strategy restores the "none" peak.
"""
import collections
import gc
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels import dispatch as jdispatch
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.dist import sharding
from repro_torch.kernels import dispatch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm, remat
from repro_torch.train import step

from test_torch_dryrun import recompute_flops
from test_torch_train import (batch_np, cfgs, reference_params, to_torch,
                              trainable)

# (family, batch, config overrides): every block kind of the train
# families, and one attention block with a single batch row, kv head and
# query head
RESIDUAL_CASES = {
    "dense": ("dense", 2, {}),
    "flash": ("flash", 2, {}),
    "ssm": ("ssm", 2, {}),
    "hybrid": ("hybrid", 2, {}),
    "moe": ("moe", 2, {}),
    "moe_aux_free": ("moe_aux_free", 2, {}),
    "b1_kvh1_g1": ("dense", 1, dict(num_heads=1, num_kv_heads=1)),
}
S = 64


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


class _Made(TorchDispatchMode):
    """Every storage an op makes while active: (weak reference, dtype)."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self.made.append((weakref.ref(t.untyped_storage()), t.dtype))
        return out


def port_residuals(fn, args) -> list:
    """Sorted (element count, dtype) of the storages that `fn(*args)`
    makes and leaves alive beyond its arguments and outputs."""
    fn(*args)                      # rope's cached table, the probe's cache
    with _Made() as made:
        out = fn(*args)
    gc.collect()
    skip = {t.untyped_storage()._cdata for t in _tensors(out)}
    skip |= {t.untyped_storage()._cdata for t in _tensors(args)}
    skip |= {p.untyped_storage()._cdata for a in args
             if isinstance(a, torch.nn.Module) for p in a.parameters()}
    alive = {}
    for ref, dtype in made.made:
        st = ref()
        if st is not None and st._cdata not in skip:
            alive[st._cdata] = (st.nbytes() // dtype.itemsize,
                                str(dtype).removeprefix("torch."))
    return sorted(alive.values())


def jax_residuals(fn, args) -> list:
    """Sorted (element count, dtype) of saved_residuals(fn, *args) that
    are neither arguments nor constants."""
    return sorted((int(np.prod(a.shape)), str(a.dtype))
                  for a, why in saved_residuals(fn, *args)
                  if "argument" not in why and "constant" not in why)


@pytest.mark.parametrize("mode", ["dots", "block"])
@pytest.mark.parametrize("case", list(RESIDUAL_CASES))
def test_one_blocks_residuals_equal_jax_saved_residuals(case, mode):
    family, b, over = RESIDUAL_CASES[case]
    jcfg, cfg = cfgs(family, remat=mode, **over)
    params = reference_params(jcfg)
    model = trainable(params, cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, S, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (b, S))
    tx = torch.from_numpy(x).requires_grad_()
    tpos = torch.from_numpy(pos.copy())
    for i, kind in enumerate(cfg.block_pattern):
        bp = jax.tree.map(lambda a: jnp.asarray(a[0]), params["groups"][i])
        f = jlm._block_fn(jcfg, kind, jnp.asarray(pos), False)

        def jfn(x, bp):
            y, _, a = f(x, bp, None)
            return jnp.sum(y) + a

        want = jax_residuals(jfn, (jnp.asarray(x), bp))
        tf = lm._block_fn(cfg, kind, False)
        got = port_residuals(
            lambda x, blk, pos: tf(x, blk, None, pos)[::2],
            (tx, model.blocks[i], tpos))
        assert got == want, (case, kind, mode)
        if mode == "block":
            assert got == []


def _count_reference_constraints(monkeypatch):
    calls = collections.Counter()
    for mod in (jblocks, jattention, jlm):
        real = mod.logical_constraint

        def counted(x, names, _real=real):
            calls["n"] += 1
            return _real(x, names)
        monkeypatch.setattr(mod, "logical_constraint", counted)
    return calls


@pytest.mark.parametrize("family", ["dense", "flash", "ssm", "moe"])
def test_launch_and_constraint_counts_equal_across_modes_and_reference(
        family, monkeypatch):
    """Each mode's step, under rules on a one-position CPU mesh: the same
    dispatch counts and logical_constraint calls, equal to what the
    reference's loop-free variant (scan_layers=False) counts when it
    traces its step once, layer by layer (remat "none"). Under
    jax.checkpoint the reference also reuses one block's trace for every
    layer of the same function and shapes, so its count there is the
    embedding's call and one block's; the port counts every layer's
    forward once in every mode, and its recompute adds nothing."""
    calls = _count_reference_constraints(monkeypatch)
    jcfg, _ = cfgs(family, scan_layers=False)
    params = reference_params(jcfg)
    batch = batch_np(jcfg)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    ref, seen = {}, {}
    for mode in ("none", "block", "dots"):
        jcfg, cfg = cfgs(family, remat=mode, scan_layers=False)
        calls.clear()
        jdispatch.reset_launch_counts()
        jax.jit(lambda p, b: jax.grad(lambda q: jstep.loss_fn(
            q, jcfg, b)[0])(p))(jax.tree.map(jnp.asarray, params), batch)
        ref[mode] = (jdispatch.launch_counts(), calls["n"])
        model = trainable(params, cfg)
        dispatch.reset_launch_counts()
        sharding.CONSTRAINT_CALLS = 0
        with sharding.use_rules(mesh, sharding.DEFAULT_RULES):
            step.value_and_grad(model, cfg, to_torch(batch))
        seen[mode] = (dispatch.launch_counts(), sharding.CONSTRAINT_CALLS)
    assert seen["none"] == seen["block"] == seen["dots"] == ref["none"]
    layers = cfg.num_layers
    per_block = (ref["none"][1] - 1) // layers
    assert per_block >= 1 and ref["none"][1] == 1 + layers * per_block
    for mode in ("block", "dots"):
        assert ref[mode] == (ref["none"][0], 1 + per_block), mode


@pytest.mark.parametrize("mode", ["block", "dots"])
def test_the_recompute_is_muted_and_the_hooks_still_run(mode):
    """A checkpointed function that counts a dispatch and a constraint:
    each counted once, by its forward; the constraint hooks see the
    forward and the recompute."""
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    hooked = []
    w = torch.randn(8, 8, requires_grad=True)

    def fn(x, w):
        dispatch.count_launch("remat_probe")
        y = torch.einsum("bd,de->be", x, w)
        y = sharding.logical_constraint(y, ("batch", "embed"))
        return (torch.tanh(y) * y).sum()

    sharding.CONSTRAINT_HOOKS.append(lambda x, spec: hooked.append(spec))
    try:
        dispatch.reset_launch_counts()
        sharding.CONSTRAINT_CALLS = 0
        x = torch.randn(4, 8, requires_grad=True)
        with sharding.use_rules(mesh, sharding.DEFAULT_RULES):
            out = remat.checkpoint(fn, mode, ("test", mode), x, w)
            assert len(hooked) == 1
            out.backward()
    finally:
        sharding.CONSTRAINT_HOOKS.pop()
    assert dispatch.launch_counts() == {"remat_probe": 1}
    assert sharding.CONSTRAINT_CALLS == 1
    assert len(hooked) == 2
    dispatch.reset_launch_counts()


@pytest.mark.parametrize("mode", ["block", "dots"])
def test_the_recompute_runs_under_the_forwards_rules_on_another_thread(
        mode):
    """The backward, so the recompute, on a thread where no rules are
    active (as autograd's device thread on CUDA): the recompute still
    resolves its constraint under the forward's rules, the hooks see it,
    and it counts nothing."""
    import threading
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    hooked = []
    w = torch.randn(8, 8, requires_grad=True)

    def fn(x, w):
        y = torch.einsum("bd,de->be", x, w)
        y = sharding.logical_constraint(y, ("batch", "embed"))
        return (torch.tanh(y) * y).sum()

    sharding.CONSTRAINT_HOOKS.append(lambda x, spec: hooked.append(spec))
    try:
        sharding.CONSTRAINT_CALLS = 0
        x = torch.randn(4, 8, requires_grad=True)
        with sharding.use_rules(mesh, sharding.DEFAULT_RULES):
            out = remat.checkpoint(fn, mode, ("test", mode), x, w)
        errors = []

        def backward():
            try:
                assert sharding.current_rules() is None
                out.backward()
            except BaseException as e:     # re-raised on the test's thread
                errors.append(e)
        t = threading.Thread(target=backward)
        t.start()
        t.join()
        if errors:
            raise errors[0]
    finally:
        sharding.CONSTRAINT_HOOKS.pop()
    assert sharding.CONSTRAINT_CALLS == 1
    assert len(hooked) == 2 and hooked[0] == hooked[1]
    assert sharding.current_rules() is None


def test_the_einsum_classification_is_the_dot_generals():
    has = remat.einsum_has_batch
    assert not has("bsd,df->bsf") and not has("bsnh,nhd->bsd")
    assert not has("...d,de->...e") and not has("bn,nm->bm")
    assert has("bskgh,btkh->bkgst") and has("bkgst,btkh->bskgh")
    assert has("ecd,edf->ecf") and has("...d,...d->...")
    assert has("bn,bhp->bhnp")


@pytest.mark.parametrize("mode", ["block", "dots"])
def test_no_grad_prefill_and_eval_make_no_checkpoint_call(mode,
                                                          monkeypatch):
    calls = collections.Counter()
    real = remat.checkpoint

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)
    monkeypatch.setattr(remat, "checkpoint", counted)
    jcfg, cfg = cfgs("hybrid", remat=mode)
    _, cfg_none = cfgs("hybrid", remat="none")
    params = reference_params(jcfg)
    batch = to_torch(batch_np(cfg))
    model = trainable(params, cfg)
    with torch.no_grad():
        caches = lm.init_caches(cfg, 2, S, device="cpu")
        logits, _, _ = lm.prefill(model, cfg, batch["inputs"], caches)
        caches = lm.init_caches(cfg, 2, S, device="cpu")
        plain, _, _ = lm.prefill(model, cfg_none, batch["inputs"], caches)
    ev = step.make_eval_step(cfg)(model, batch)
    assert calls["n"] == 0
    assert torch.equal(logits, plain)
    assert torch.isfinite(ev["loss"])
    step.value_and_grad(model, cfg, batch)
    assert calls["n"] == cfg.num_layers


def _temp(arch, remat_mode, strategy):
    rec = dryrun.run_cell(arch, "train_4k", False, probes=False,
                          cfg_override=get_config(arch).reduced(
                              remat=remat_mode), strategy=strategy)
    assert rec["status"] == "ok", rec
    return rec["memory"]["temp_size_in_bytes"], rec["costs"]["flops"]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-1.3b"])
def test_dry_run_temp_peak_follows_remat_and_dp_noremat_restores_it(arch):
    # first, as a process's first cell also counts what it caches (32
    # bytes at these widths), which the later cells find made
    rec, full, early = recompute_flops(arch, "dp")
    none, none_flops = _temp(arch, "none", "dp")
    assert rec["costs"]["flops"] == none_flops
    block, block_flops = _temp(arch, "block", "dp")
    dots, _ = _temp(arch, "dots", "dp")
    noremat, noremat_flops = _temp(arch, "block", "dp_noremat")
    assert block < dots < none
    assert noremat == none and noremat_flops == none_flops
    # the recompute: one more forward of every block, up to the last
    # tensor it saves, and the whole forward without the early stop
    assert 0 < early <= full
    assert math.isclose(block_flops, none_flops + early, rel_tol=1e-9)
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        _, whole = _temp(arch, "block", "dp")
    assert math.isclose(whole, none_flops + full, rel_tol=1e-9)
