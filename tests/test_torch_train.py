"""Parity of the port's training step (repro_torch.train) with the
reference's (repro.train), on the CPU.

Weights are drawn by the reference (jax.random) and carried across with
repro_torch.models.convert; tokens come from numpy seeds; the configs are
reduced and float32. Every family the step serves is covered: dense
(internlm2-1.8b), dense with the chunked cross-entropy (fused_ce), dense
with attn_impl="flash" (the reference's Pallas kernel in interpret mode,
as tests/test_torch_attention.py runs it), SSM (mamba2-1.3b: the SSD op's
autograd Function), hybrid (recurrentgemma-2b) and MoE in both routing
modes (mixtral-8x22b; moonshot-v1-16b-a3b aux-free, its router_bias
nonzero, at a capacity factor under which choices drop).

Tolerances are tests/test_torch_models.py's: TOL (2e-4) for the loss
and its parts, MAMBA_TOL (2e-3) for a quantity taken after optimizer
steps. A gradient leaf (or a first moment, 0.1 x a clipped gradient) is
held to TOL scaled to the leaf's largest magnitude (`close_leaf`), since
gradients are far smaller than 2e-4 in absolute terms. One AdamW step from identical gradients (the
reference's, carried over) is held to OPT_TOL: the same float32
operations in the same order, but the global norm sums its squares in
another order (per block here, per stacked leaf there), which moves it,
and with it the clip scale, by about 1e-6.
Parameters after a whole step are never compared leaf for leaf: Adam's
first step is a sign, and a gradient near zero whose sign differs by
rounding moves a parameter by 2 lr.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core.systems import TPUSpec
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.train import metrics as jmetrics
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.systems import H100_SXM
from repro_torch.models import common, convert, ssm
from repro_torch.train import metrics, optim, step

TOL = dict(rtol=2e-4, atol=2e-4)
MAMBA_TOL = dict(rtol=2e-3, atol=2e-3)
OPT_TOL = dict(rtol=4e-6, atol=1e-7)
DROP_FACTOR = 0.5          # a capacity factor under which choices drop
B, S = 2, 64

DENSE = dict(num_layers=2, head_dim=64)
FAMILIES = {
    "dense": ("internlm2-1.8b", DENSE),
    "fused_ce": ("internlm2-1.8b", dict(DENSE, fused_ce=True)),
    "flash": ("internlm2-1.8b", dict(DENSE, attn_impl="flash")),
    "ssm": ("mamba2-1.3b", {}),
    "hybrid": ("recurrentgemma-2b", {}),
    "moe": ("mixtral-8x22b", {}),
    "moe_aux_free": ("moonshot-v1-16b-a3b",
                     dict(moe_capacity_factor=DROP_FACTOR)),
}
OPT = dict(lr=5e-3, warmup_steps=1, decay_steps=100)


def cfgs(family, **over):
    arch, base = FAMILIES[family]
    kw = dict(base, dtype="float32", **over)
    return jget_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def reference_params(jcfg, key=0):
    """The reference's params (jitted init); an aux-free config's
    router_bias is made nonzero, so that selection and weights differ."""
    params = jax.jit(lambda k: jlm.init(k, jcfg)[0])(jax.random.PRNGKey(key))
    params = jax.tree.map(np.asarray, params)
    if jcfg.aux_free_bias:
        rng = np.random.default_rng(7)
        groups = list(params["groups"])
        g = dict(groups[0])
        g["moe"] = dict(g["moe"])
        bias = g["moe"]["router_bias"]
        g["moe"]["router_bias"] = (rng.standard_normal(bias.shape) * 0.05
                                   ).astype(np.float32)
        groups[0] = g
        params = {**params, "groups": tuple(groups)}
    return params


def batch_np(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        inputs = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    else:
        inputs = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    return {"inputs": inputs,
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def trainable(params_np, cfg):
    model = convert.params_from_reference(params_np, cfg, device="cpu")
    return model.requires_grad_(True)


def reference_state(params_np, opt_cfg):
    params = jax.tree.map(jnp.asarray, params_np)
    return {"params": params, "opt": joptim.init(params, opt_cfg),
            "step": jnp.zeros((), jnp.int32)}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach()
                                          .float()),
                               np.asarray(want, np.float32),
                               err_msg=err_msg, **(tol or TOL))


def close_leaf(got, want, name):
    """TOL relative to the leaf's scale: |got - want| <= 2e-4 (|want| +
    max |want|)."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    close(got, want, err_msg=name, rtol=TOL["rtol"],
          atol=TOL["atol"] * scale)


@pytest.fixture(scope="module")
def setups():
    """family -> (jcfg, cfg, reference params as numpy, batch); built
    once a family."""
    cache = {}

    def get(family):
        if family not in cache:
            jcfg, cfg = cfgs(family)
            cache[family] = (jcfg, cfg, reference_params(jcfg),
                             batch_np(cfg))
        return cache[family]
    return get


def reference_grads(jcfg, params_np, batch):
    fn = jax.jit(lambda p, b: jax.value_and_grad(
        jstep.loss_fn, has_aux=True)(p, jcfg, b))
    (loss, parts), grads = fn(jax.tree.map(jnp.asarray, params_np), batch)
    return loss, parts, np_tree(grads)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_losses_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 32), dtype=np.float32)
    w = rng.standard_normal((32, 50), dtype=np.float32) * 0.3
    labels = rng.integers(0, 50, (2, 16)).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    tx = torch.from_numpy(x).to(tdt)
    tw = torch.from_numpy(w).to(tdt)
    logits = jnp.einsum("bsd,dv->bsv", jx, jw)
    want = jcommon.softmax_cross_entropy(logits, jnp.asarray(labels))
    got = common.softmax_cross_entropy(torch.einsum("bsd,dv->bsv", tx, tw),
                                       torch.from_numpy(labels))
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    close(got, want, **tol)
    for n in (1, 4, 8):
        want = jcommon.chunked_cross_entropy(jx, jw, jnp.asarray(labels), n)
        got = common.chunked_cross_entropy(tx, tw, torch.from_numpy(labels),
                                           n)
        close(got, want, **tol)
    with pytest.raises(AssertionError):
        common.chunked_cross_entropy(tx, tw, torch.from_numpy(labels), 3)


# --------------------------------------------------------------------------
# the carry-over, both ways
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid", "moe",
                                    "moe_aux_free"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_carry_over_round_trips_bit_for_bit(family, dtype):
    """reference -> port -> reference: the same tree, the same dtypes and
    the same bits, group stacks and the tail included."""
    arch, base = FAMILIES[family]
    over = dict(base, dtype=dtype)
    if family == "hybrid":
        over["num_layers"] = 8         # two (R, R, A) groups and a tail
    jcfg = jget_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    params = reference_params(jcfg)
    model = convert.params_from_reference(params, cfg, device="cpu")
    leaves = convert.leaf_map(model)
    n_groups = cfg.num_layers // len(cfg.block_pattern)
    assert len(leaves) == len(jax.tree.leaves(params)) + (n_groups - 1) * \
        len(jax.tree.leaves(params["groups"]))
    back = convert.to_reference(dict(model.named_parameters()), leaves)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      np.asarray(want).view(np.uint8))
    named = convert.from_reference(params, leaves, device="cpu")
    for n, p in model.named_parameters():
        assert torch.equal(named[n], p)


def test_state_from_reference_carries_every_tree():
    jcfg, cfg = cfgs("moe_aux_free")
    params = reference_params(jcfg)
    opt_cfg = joptim.AdamWConfig(**OPT)
    jstate = reference_state(params, opt_cfg)
    jstate["opt"]["count"] = jnp.asarray(3, jnp.int32)
    jstate["step"] = jnp.asarray(3, jnp.int32)
    state = convert.state_from_reference(np_tree(jstate), cfg, device="cpu")
    assert all(p.requires_grad for p in state["params"].parameters())
    assert int(state["opt"]["count"]) == 3 and int(state["step"]) == 3
    leaves = convert.leaf_map(state["params"])
    for k in ("m", "v", "master"):
        back = convert.to_reference(state["opt"][k], leaves)
        for got, want in zip(jax.tree.leaves(back),
                             jax.tree.leaves(jstate["opt"][k])):
            np.testing.assert_array_equal(got, np.asarray(want))


# --------------------------------------------------------------------------
# loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_every_gradient_leaf_match_reference(setups, family):
    jcfg, cfg, params, batch = setups(family)
    jloss, jparts, jgrads = reference_grads(jcfg, params, batch)
    model = trainable(params, cfg)
    loss, parts, grads = step.value_and_grad(model, cfg, to_torch(batch))
    close(loss, jloss)
    for k in ("ce", "aux"):
        close(parts[k], jparts[k])
    if cfg.num_experts:
        assert float(parts["aux"]) > 0
    leaves = convert.leaf_map(model)
    want = convert.from_reference(jgrads, leaves, device="cpu")
    missing = sorted(n for n, g in grads.items() if g is None)
    # the selection bias enters only top-k: jax.grad gives it zeros
    assert missing == sorted(n for n in leaves if n.endswith("router_bias"))
    for n in missing:
        assert not want[n].any()
    for n, g in grads.items():
        if g is not None:
            assert g.dtype == want[n].dtype, n
            close_leaf(g, want[n], n)


def test_ssd_function_gradient_matches_reference_model_scan():
    """The SSD op's autograd Function against jax.grad of the reference's
    plain jnp chunked scan, in every input and the entering state, with
    the final state read and unread."""
    jcfg, cfg = cfgs("ssm")
    rng = np.random.default_rng(3)
    b, s, h, p, n = 2, 96, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xs = [rng.standard_normal((b, s, h, p), dtype=np.float32),
          np.log1p(np.exp(rng.standard_normal((b, s, h), dtype=np.float32))),
          rng.standard_normal(h, dtype=np.float32) * 0.3,
          rng.standard_normal((b, s, n), dtype=np.float32),
          rng.standard_normal((b, s, n), dtype=np.float32),
          rng.standard_normal((b, h, n, p), dtype=np.float32)]
    w = rng.standard_normal((b, s, h, p), dtype=np.float32)
    for read_state in (True, False):
        def jloss(*a):
            y, final = jssm._ssd_chunked(*a[:5], jcfg, a[5])
            out = jnp.sum(y * w)
            return out + jnp.sum(final ** 2) if read_state else out

        want = jax.grad(jloss, argnums=tuple(range(6)))(
            *map(jnp.asarray, xs))
        ts = [torch.from_numpy(x).requires_grad_() for x in xs]
        y, final = ssm._ssd_chunked(*ts[:5], cfg, ts[5])
        out = (y * torch.from_numpy(w)).sum()
        (out + final.square().sum() if read_state else out).backward()
        for t, wg in zip(ts, want):
            close(t.grad, wg, **MAMBA_TOL)


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_master", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count,grad_clip", [(0, 1.0), (0, 1e3),
                                             (150, 1e-2)])
def test_apply_updates_matches_reference(use_master, dtype, count,
                                         grad_clip):
    """One AdamW step from identical gradients (the reference's, carried
    over) on a state with nonzero moments: clipped (grad_clip 1 and 1e-2)
    and not (1e3); the schedule in warm-up (count 0 of 100 steps) and in
    its cosine decay (150)."""
    arch, base = FAMILIES["moe_aux_free"]
    jcfg = jget_config(arch).reduced(dtype=dtype, **base)
    cfg = get_config(arch).reduced(dtype=dtype, **base)
    opt_cfg = dict(lr=1e-3, warmup_steps=100, decay_steps=1000,
                   grad_clip=grad_clip, use_master=use_master)
    jopt, topt = (joptim.AdamWConfig(**opt_cfg),
                  optim.AdamWConfig(**opt_cfg))
    params = reference_params(jcfg)
    rng = np.random.default_rng(5)

    def grads_like(tree, scale):
        return jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape) * scale, a.dtype), tree)

    jstate = reference_state(params, jopt)
    # moments from one earlier step, then the count under test
    p1, o1, _ = joptim.apply_updates(jstate["params"],
                                     grads_like(params, 0.01),
                                     jstate["opt"], jopt)
    o1["count"] = jnp.asarray(count, jnp.int32)
    jgrads = grads_like(params, 0.02)
    state = convert.state_from_reference(
        np_tree({"params": p1, "opt": o1, "step": jnp.zeros((), jnp.int32)}),
        cfg, device="cpu")
    model = state["params"]
    leaves = convert.leaf_map(model)
    grads = convert.from_reference(np_tree(jgrads), leaves, device="cpu")
    before = {n: g.clone() for n, g in grads.items()}
    want_p, want_o, want_m = joptim.apply_updates(p1, jgrads, o1, jopt)
    got_p, got_o, got_m = optim.apply_updates(model, grads, state["opt"],
                                              topt)
    assert got_p is model
    for n, g in grads.items():
        assert torch.equal(g, before[n]), "apply_updates wrote a gradient"
    assert int(got_o["count"]) == count + 1
    close(got_m["grad_norm"], want_m["grad_norm"], **OPT_TOL)
    close(got_m["lr"], want_m["lr"], **OPT_TOL)
    assert ("master" in got_o) == use_master
    for k in ("m", "v") + (("master",) if use_master else ()):
        for n, t in got_o[k].items():
            path, g = leaves[n]
            want = np.asarray(convert._at(want_o[k], path))
            close(t, want if g is None else want[g], err_msg=f"{k} {n}",
                  **OPT_TOL)
    for n, p in model.named_parameters():
        path, g = leaves[n]
        want = np.asarray(convert._at(want_p, path))
        want = want if g is None else want[g]
        assert p.dtype == convert._tensor(want, "cpu").dtype
        # bf16: one unit in the last place where the fp32 results straddle
        # a rounding boundary
        tol = OPT_TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=0)
        close(p, want, err_msg=n, **tol)


def test_schedule_and_clip_match_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, decay_steps=50, min_lr_ratio=0.1)
    for c in (0, 1, 5, 10, 11, 30, 50, 51, 1000):
        close(optim.schedule(optim.AdamWConfig(**cfg),
                             torch.tensor(c, dtype=torch.int32)),
              joptim.schedule(joptim.AdamWConfig(**cfg),
                              jnp.asarray(c, jnp.int32)), **OPT_TOL)
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    for max_norm in (0.1, 100.0):
        want, wnorm = joptim.clip_by_global_norm(
            jax.tree.map(jnp.asarray, tree), max_norm)
        got, norm = optim.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
        close(norm, wnorm, **OPT_TOL)
        for k in tree:
            close(got[k], want[k], **OPT_TOL)


# --------------------------------------------------------------------------
# the step: accumulation, the MoE bias update, eval, five steps
# --------------------------------------------------------------------------

def one_step(family, setups, num_microbatches, opt=OPT):
    """One train step of each package from the same state and batch:
    (reference state, metrics), (port state, metrics)."""
    jcfg, cfg, params, batch = setups(family)
    jopt, topt = joptim.AdamWConfig(**opt), optim.AdamWConfig(**opt)
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt, num_microbatches))
    jstate, jm = jfn(reference_state(params, jopt), batch)
    state = convert.state_from_reference(
        np_tree(reference_state(params, jopt)), cfg, device="cpu")
    state, m = step.make_train_step(cfg, topt, num_microbatches)(
        state, to_torch(batch))
    return (jstate, jm), (state, m)


@pytest.mark.parametrize("family", ["dense", "ssm", "moe"])
def test_two_microbatches_match_reference_and_one_batch(setups, family):
    """Accumulation over 2 microbatches: the loss (the mean), the parts
    (the last microbatch's), the global norm and the first moments (0.1 x
    the clipped mean gradient) equal the reference's. Without experts
    they also equal one whole batch's, whose loss is the same mean; with
    experts the aux loss, a product of batch means, is not."""
    (jstate, jm), (state, m) = one_step(family, setups, 2)
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        close(m[k], jm[k], err_msg=k)
    leaves = convert.leaf_map(state["params"])
    want = convert.from_reference(np_tree(jstate["opt"]["m"]), leaves,
                                  device="cpu")
    for n, t in state["opt"]["m"].items():
        close_leaf(t, want[n], n)
    assert int(state["step"]) == int(jstate["step"]) == 1
    if family == "moe":
        return
    _, (whole, wm) = one_step(family, setups, 1)
    close(m["loss"], wm["loss"])
    close(m["grad_norm"], wm["grad_norm"])
    for n, t in state["opt"]["m"].items():
        close_leaf(t, whole["opt"]["m"][n], n)


def test_moe_bias_update_matches_reference(setups):
    """After one step of the aux-free config, each router_bias is the
    reference's: AdamW's decay of a leaf without gradient, then the nudge
    from the raw router gradient, the mean load taken over the whole
    stack of its pattern slot."""
    (jstate, jm), (state, m) = one_step("moe_aux_free", setups, 1)
    leaves = convert.leaf_map(state["params"])
    named = dict(state["params"].named_parameters())
    biases = [n for n in leaves if n.endswith("router_bias")]
    assert len(biases) == 2
    for n in biases:
        path, g = leaves[n]
        want = np.asarray(convert._at(jstate["params"], path))[g]
        close(named[n], want, err_msg=n, **OPT_TOL)
    # the nudge moved the bias by the rate beyond the decay alone
    _, cfg, params, _ = setups("moe_aux_free")
    path, g = leaves[biases[0]]
    start = convert._at(params, path)[g]
    lr = float(m["lr"])
    moved = named[biases[0]].detach().numpy() - start * (1 - lr * 0.1)
    np.testing.assert_allclose(np.abs(moved), 1e-3, rtol=1e-3)


@pytest.mark.parametrize("family", ["dense", "ssm", "moe_aux_free"])
def test_eval_step_matches_reference(setups, family):
    jcfg, cfg, params, batch = setups(family)
    want = jax.jit(jstep.make_eval_step(jcfg))(
        jax.tree.map(jnp.asarray, params), batch)
    model = trainable(params, cfg)
    got = step.make_eval_step(cfg)(model, to_torch(batch))
    assert not got["loss"].requires_grad
    for k in ("loss", "ce", "aux"):
        close(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid",
                                    "moe_aux_free"])
def test_five_steps_of_losses_match_reference(setups, family):
    """Five steps on one fixed batch (tests/test_models_smoke.py's
    optimizer): the losses fall and stay within MAMBA_TOL of the
    reference's."""
    jcfg, cfg, params, batch = setups(family)
    jopt, topt = joptim.AdamWConfig(**OPT), optim.AdamWConfig(**OPT)
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt))
    jstate = reference_state(params, jopt)
    state = convert.state_from_reference(np_tree(jstate), cfg, device="cpu")
    fn = step.make_train_step(cfg, topt)
    tb = to_torch(batch)
    want, got = [], []
    for _ in range(5):
        jstate, jm = jfn(jstate, batch)
        state, m = fn(state, tb)
        want.append(float(jm["loss"]))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, **MAMBA_TOL)
    assert got[-1] < got[0], got
    assert int(state["step"]) == 5 and int(state["opt"]["count"]) == 5


def test_init_state_is_trainable_and_mirrors_the_reference_layout():
    jcfg, cfg = cfgs("moe_aux_free")
    opt_cfg = optim.AdamWConfig(use_master=True)
    state, axes = step.init_state(0, cfg, opt_cfg, device="cpu")
    model = state["params"]
    assert all(p.requires_grad for p in model.parameters())
    names = [n for n, _ in model.named_parameters()]
    for k in ("m", "v", "master"):
        assert list(state["opt"][k]) == names
        assert all(t.dtype == torch.float32 for t in state["opt"][k].values())
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert set(axes) == {"params", "opt", "step"}
    assert set(axes["opt"]) == {"m", "v", "count", "master"}
    # the serving construction stays frozen
    from repro_torch.models import lm
    assert not any(p.requires_grad
                   for p in lm.init(cfg, device="cpu").parameters())
    no_master, _ = step.init_state(0, cfg, optim.AdamWConfig(
        use_master=False), device="cpu")
    assert "master" not in no_master["opt"]


def test_train_entry_points_default_to_the_card():
    """init_state and state_from_reference put the state on the card
    unless given device="cpu"; with no CUDA device they raise."""
    jcfg, cfg = cfgs("dense")
    jstate = np_tree(reference_state(reference_params(jcfg),
                                     joptim.AdamWConfig()))
    calls = [lambda: step.init_state(0, cfg, optim.AdamWConfig())[0],
             lambda: convert.state_from_reference(jstate, cfg)]
    for call in calls:
        if torch.cuda.is_available():
            state = call()
            assert state["params"].embed.device.type == "cuda"
            assert state["opt"]["count"].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_fill_cache_refuses_autograd():
    from repro_torch.models import attention, lm
    jcfg, cfg = cfgs("dense")
    state, _ = step.init_state(0, cfg, optim.AdamWConfig(), device="cpu")
    caches = lm.init_caches(cfg, 1, 16, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no_grad"):
        lm.prefill(state["params"], cfg, tokens, caches)
    with torch.no_grad():
        lm.prefill(state["params"], cfg, tokens, caches)
    assert attention.INF_POS not in caches[0]["pos"][0, :4].tolist()


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

def test_metrics_logger_matches_reference_with_the_h100_row(tmp_path):
    """The reference logger given a TPUSpec carrying the H100 row's
    numbers (its one ICI link = one NVLink direction) writes the same
    records as the port's default."""
    h100 = TPUSpec(name=H100_SXM.name,
                   peak_flops_bf16=H100_SXM.peak_flops_bf16,
                   hbm_bandwidth=H100_SXM.hbm_bandwidth,
                   hbm_capacity=H100_SXM.hbm_capacity,
                   ici_link_bandwidth=H100_SXM.link_bandwidth,
                   ici_links=H100_SXM.links,
                   chip_power=H100_SXM.chip_power,
                   chips_per_host=H100_SXM.chips_per_host,
                   host_overhead_power=H100_SXM.host_overhead_power)
    for arch in ("internlm2-1.8b", "mamba2-1.3b", "moonshot-v1-16b-a3b"):
        for chips, shape in ((1, ("t", "train", 4096, 1)),
                             (4, ("t", "train", 4096, 256))):
            jlog = jmetrics.MetricsLogger(
                tmp_path / "ref.jsonl", jget_config(arch),
                JShapeSpec(*shape), chips, tpu=h100)
            log = metrics.MetricsLogger(tmp_path / "port.jsonl",
                                        get_config(arch), ShapeSpec(*shape),
                                        chips)
            assert log.roofline_step_s == pytest.approx(
                jlog.roofline_step_s, rel=1e-12)
            for i, sec in enumerate((0.5, 0.25)):
                want = jlog.log(i, sec, {"loss": 2.5})
                got = log.log(i, sec, {"loss": torch.tensor(2.5)})
                for k in want:
                    if k != "time":
                        assert got[k] == pytest.approx(want[k], rel=1e-12), k
            jlog.close()
            log.close()
    rows = [json.loads(line) for line in
            (tmp_path / "port.jsonl").read_text().splitlines()]
    assert len(rows) == 12 and all(r["mfu"] > 0 for r in rows)
