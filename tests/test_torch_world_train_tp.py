"""The train step computed on the blocks of a torch.distributed world, on
the CPU: tensor- and expert-parallel over "model", MoE training on ranks,
against the reference's 8-device train step.

`specs.build_train` on a RankMesh reads every parameter through
`sharding.at_use` (gathered over "data" at its use, its "model" split
kept) and runs the collectives with their adjoints (`reduce_over`,
`gather_over`, `enter_over`, `mean_over`). Two worlds run here:

- four gloo ranks on a (2, 2) ("data", "model") mesh take the gradient of
  a toy model built from those ops (an embedding and a head over a split
  vocabulary, a two-layer MLP split over "model" with its first weight
  split over "data" too, a replicated scale, a bias split over "data"
  only, and a mean of batch statistics through a nonlinear term), each
  against one process;
- eight gloo ranks on (2, 4) train reduced fp32 mixtral (softmax routing,
  aux loss; heads split, kv heads whole, experts split), moonshot
  (aux-free bias) and mixtral with two microbatches from the reference's
  init, against the reference's jitted build_train on 8 XLA CPU devices
  (this file runs itself as that child: `python
  tests/test_torch_world_train_tp.py child OUT`), and internlm2 with the
  chunked cross-entropy against the port's one-position step.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

B, S, STEPS, SEED = 4, 32, 3, 0
MESH = (2, 4)
AXES = ("data", "model")
# (arch, microbatches): softmax routing with its aux loss, the aux-free
# bias, and a rank's rows of each global microbatch
CASES = (("mixtral-8x22b", 1), ("moonshot-v1-16b-a3b", 1),
         ("mixtral-8x22b", 2))


def _config(arch, package="repro_torch"):
    import importlib
    get = importlib.import_module(package + ".configs").get_config
    return get(arch).reduced(dtype="float32")


def _child(out_path: str) -> None:
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs.base import ShapeSpec
    from repro.data import DataConfig, SyntheticLM, make_global_batch
    from repro.dist.sharding import sharding_tree
    from repro.launch import specs
    from repro.launch.mesh import make_mesh
    from repro.train import optim, step as step_lib
    assert len(jax.devices()) == 8, jax.devices()
    np_tree = lambda t: jax.tree.map(np.asarray, t)      # noqa: E731
    mesh = make_mesh(MESH, AXES)
    shape = ShapeSpec("t", "train", S, B)
    opt_cfg = optim.AdamWConfig()
    out = {}
    for arch, micro in CASES:
        cfg = _config(arch, "repro")
        jitted, _ = specs.build_train(cfg, shape, mesh, opt_cfg=opt_cfg,
                                      num_microbatches=micro)
        state, axes = step_lib.init_state(jax.random.PRNGKey(SEED), cfg,
                                          opt_cfg)
        sh = sharding_tree(state, axes, mesh, specs.rules_for(cfg, shape))
        init = np_tree(state)
        state = jax.tree.map(jax.device_put, state, sh)
        ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B))
        losses = []
        for s in range(STEPS):
            state, metrics = jitted(state, make_global_batch(
                ds.batch(s), mesh, {"inputs": P("data"),
                                    "labels": P("data")}))
            losses.append(float(metrics["loss"]))
        out[(arch, micro)] = {"init": init, "losses": losses,
                              "final": np_tree(state)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    _child(sys.argv[2])
    sys.exit(0)


import torch  # noqa: E402
from test_torch_specs import (CHILD_TIMEOUT_S, TOL,  # noqa: E402
                              assert_state)
from test_torch_world_train import (_assert_blocks, _blocks,  # noqa: E402
                                    _gather_state, _place_state,
                                    _port_state, _same_tree)

from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.dist import world  # noqa: E402

DEADLINE_S = 240
ADJOINT_TOL = dict(rtol=1e-6, atol=1e-6)
TOY = dict(b=4, s=3, v=8, d=6, f=4)     # rows, tokens, vocab, embed, mlp
TRAIN = ShapeSpec("t", "train", S, B)


# --------------------------------------------------------------------------
# the toy model of the adjoint checks (module level: the ranks unpickle it)
# --------------------------------------------------------------------------

def _toy_leaves() -> dict:
    """name -> (whole leaf, its spec over ("data", "model"))."""
    g = torch.Generator().manual_seed(11)
    t = TOY

    def draw(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64).float()

    return {"table": (draw(t["v"], t["d"]), ("model", "data")),
            "scale": (draw(t["d"]) * 0.1, ()),
            "bias": (draw(t["d"]) * 0.1, ("data",)),
            "w1": (draw(t["d"], t["f"]) / 2, ("data", "model")),
            "w2": (draw(t["f"], t["d"]) / 2, ("model",)),
            "head": (draw(t["d"], t["v"]) / 2, (None, "model"))}


def _toy_batch():
    g = np.random.default_rng(4)
    t = TOY
    return (torch.from_numpy(g.integers(0, t["v"], (t["b"], t["s"]))),
            torch.from_numpy(g.integers(0, t["v"], (t["b"], t["s"]))))


class _IdentitySum(torch.autograd.Function):
    """mean_over's all-reduce sum with an identity adjoint, the wrong one
    (the division by the batch's blocks after it is differentiated as any
    division is)."""

    @staticmethod
    def forward(ctx, x, axes):
        from repro_torch.dist import sharding
        return sharding.reduce_over(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _toy_loss(p: dict, tokens, labels, mean) -> torch.Tensor:
    """The embedding lookup, x * (1 + scale), a residual two-layer MLP
    with a bias, the head's CE over this rank's rows, and 8 x |mean
    softmax|^2 of the batch's statistics (nonlinear in the global
    mean)."""
    import torch.nn.functional as F

    from repro_torch.dist import sharding
    from repro_torch.models import lm
    x = lm.embed_lookup(p["table"], tokens) * (1.0 + p["scale"])
    f = sharding.split_axes(p["w1"], 1)
    h = F.gelu(torch.einsum("bsd,df->bsf", sharding.enter_over(x, f),
                            p["w1"]))
    x = x + sharding.reduce_over(torch.einsum("bsf,fd->bsd", h, p["w2"]),
                                 f) + p["bias"]
    v = sharding.split_axes(p["head"], 1)
    logits = sharding.gather_over(torch.einsum(
        "bsd,dv->bsv", sharding.enter_over(x, v), p["head"]), -1, v)
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    stat = mean(torch.softmax(logits, -1).mean(dim=(0, 1)),
                sharding.split_of("batch"))
    return ce + 8.0 * stat.square().sum()


def _toy_grads(identity_mean: bool = False) -> dict:
    """On a (2, 2) rank mesh: every leaf's gradient, reduced over "data"
    (the batch's axis) and divided by its two blocks, gathered whole;
    and each leaf's reduced gradient block over "model" as this rank
    holds it."""
    import torch.distributed as dist

    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), AXES, group=dist.group.WORLD)
    tokens, labels = _toy_batch()
    rows = sharding.NamedSharding(mesh, sharding.PartitionSpec("data"))
    tokens = sharding.local_block(tokens, rows)
    labels = sharding.local_block(labels, rows)
    blocks, leaves, fsdp = {}, {}, {}
    for name, (whole, spec) in _toy_leaves().items():
        sh = sharding.NamedSharding(mesh, sharding.PartitionSpec(*spec),
                                    tuple(whole.shape))
        blocks[name] = sharding.local_block(whole, sh).clone() \
            .requires_grad_(True)
        leaves[id(blocks[name])] = sh
        fsdp[name] = tuple(a for _, e in sh.splits() for a in e
                           if a != "model")
    mean = (lambda x, axes: _IdentitySum.apply(x, axes) / 2) \
        if identity_mean else sharding.mean_over
    with sharding.use_rules(mesh, {}, {"batch": ("data",)}, leaves):
        used = {n: sharding.at_use(t) for n, t in blocks.items()}
        _toy_loss(used, tokens, labels, mean).backward()
    out = {"coords": dict(mesh.coords), "whole": {}, "model_block": {}}
    for name, t in blocks.items():
        g = sharding.use_grad(t).contiguous()
        dist.all_reduce(g, group=mesh.axis_group("data"))
        g = g / 2
        sh = leaves[id(t)]
        out["model_block"][name] = g.numpy()
        out["whole"][name] = sharding.gather(g, sh.without(fsdp[name])) \
            .numpy()
        assert t.grad is None, name          # nothing reached the block
    return out


def _toy_one() -> dict:
    """The same loss in one process, over every row: its gradients."""
    leaves = {n: w.clone().requires_grad_(True)
              for n, (w, _) in _toy_leaves().items()}
    tokens, labels = _toy_batch()
    _toy_loss(leaves, tokens, labels, lambda x, axes: x).backward()
    return {n: t.grad.numpy() for n, t in leaves.items()}


def _four() -> list:
    import torch.distributed as dist
    out = {"exact": _toy_grads(), "identity": _toy_grads(True)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


# --------------------------------------------------------------------------
# what the 8 ranks run
# --------------------------------------------------------------------------

def _moe_case(ref: dict, arch: str, micro: int) -> dict:
    import torch.distributed as dist

    from repro_torch.data import (DataConfig, SyntheticLM,
                                  make_global_batch)
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert
    from repro_torch.train import optim
    cfg = _config(arch)
    mesh = make_mesh(MESH, AXES, group=dist.group.WORLD)
    fn, _ = specs.build_train(cfg, TRAIN, mesh, opt_cfg=optim.AdamWConfig(),
                              num_microbatches=micro)
    sh, batch_sh = fn.in_shardings
    state = _place_state(convert.state_from_reference(
        ref[(arch, micro)]["init"], cfg, device="cpu"), sh)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                global_batch=B))
    specs_ = {k: s.spec for k, s in batch_sh.items()}
    losses, norms = [], []
    for s in range(STEPS):
        _, m = fn(state, make_global_batch(ds.batch(s), mesh, specs_))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "final": _gather_state(state, sh, cfg),
            "rank": _blocks(state, sh, mesh)}


def _fused_ce_run(mesh_shape) -> dict:
    """Reduced fp32 internlm2 with the chunked cross-entropy (fused_ce),
    drawn from SEED: STEPS steps of build_train on `mesh_shape` (a rank
    mesh inside a world, one position outside it); the losses and the
    gathered parameters."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.data import (DataConfig, SyntheticLM,
                                  make_global_batch)
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import optim, step as step_lib
    cfg = dataclasses.replace(_config("internlm2-1.8b"), fused_ce=True)
    group = dist.group.WORLD if dist.is_initialized() else None
    mesh = make_mesh(mesh_shape, AXES, device="cpu" if group is None
                     else None, group=group)
    opt_cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1)
    fn, _ = specs.build_train(cfg, TRAIN, mesh, opt_cfg=opt_cfg)
    sh, batch_sh = fn.in_shardings
    state, _ = step_lib.init_state(SEED, cfg, opt_cfg, device="cpu")
    if group is not None:
        state = _place_state(state, sh)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                global_batch=B))
    specs_ = {k: s.spec for k, s in batch_sh.items()}
    losses = []
    for s in range(STEPS):
        _, m = fn(state, make_global_batch(ds.batch(s), mesh, specs_))
        losses.append(float(m["loss"]))
    params = (step_lib.gathered(state["params"], sh["params"], cfg)
              if group is not None else state["params"])
    return {"losses": losses,
            "params": {n: p.detach().numpy().copy()
                       for n, p in params.named_parameters()}}


def _refusals() -> dict:
    """What the train builds give on ranks: "built" for the cp strategy
    (tests/test_torch_world_seq.py trains it), the message of the one
    that must raise."""
    import torch.distributed as dist

    from repro_torch.dist import strategies
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(MESH, AXES, group=dist.group.WORLD)
    cfg = _config("mixtral-8x22b")
    out = {}
    extra, cp_cfg, _ = strategies.strategy_for(cfg, None, "cp")
    try:
        specs.build_train(cp_cfg, TRAIN, mesh, rules_extra=extra)
        out["cp"] = "built"
    except NotImplementedError as e:
        out["cp"] = str(e)
    try:        # rows split over "model" beside heads split over it
        specs.build_train(cfg, ShapeSpec("t", "train", S, 8), mesh,
                          rules_extra={"batch": ("data", "model")})
    except NotImplementedError as e:
        out["batch_model"] = str(e)
    return out


def _eight(ref) -> list:
    import torch.distributed as dist
    out = {case: _moe_case(ref, *case) for case in CASES}
    out["fused_ce"] = _fused_ce_run(MESH)
    out["refused"] = _refusals()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("world_train_tp") / "reference.pkl"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, __file__, "child", str(out)],
                         env=env, capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT_S)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def eight(ref):
    return world.spawn(_eight, 8, backend="gloo", args=(ref,),
                       deadline_s=DEADLINE_S)


@pytest.fixture(scope="module")
def four():
    return world.spawn(_four, 4, backend="gloo", deadline_s=DEADLINE_S)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("leaf", list(_toy_leaves()))
def test_adjoints_give_the_one_process_gradient(four, leaf):
    """reduce_over (identity), gather_over (slice), enter_over (sum) and
    mean_over (sum over the batch's ranks, over their count) under
    autograd, with at_use's gradient reduced over "data": every leaf's
    gradient is one process's within 1e-6 on every rank."""
    want = _toy_one()[leaf]
    for r in four:
        np.testing.assert_allclose(r["exact"]["whole"][leaf], want,
                                   err_msg=str(r["exact"]["coords"]),
                                   **ADJOINT_TOL)


@pytest.mark.parametrize("leaf", ["scale", "bias"])
def test_replicated_leaves_take_one_gradient_on_every_model_rank(four,
                                                                 leaf):
    """A leaf that "model" does not split (the scale, whole on every
    rank; the bias, split over "data" only): once reduced over "data",
    its gradient is the same on every rank bit for bit, as each "model"
    rank's gradient of x is the sum over them (enter_over)."""
    gs = [r["exact"]["model_block"][leaf] for r in four]
    for g in gs[1:]:
        np.testing.assert_array_equal(g, gs[0])


def test_an_identity_adjoint_on_the_statistics_fails(four):
    """With the identity as the adjoint of mean_over's all-reduce (the
    division by the two blocks differentiated after it), the statistics'
    term reaches the gradients at half its size: they leave the
    one-process ones by far more than the tolerance that the exact
    adjoint meets."""
    want = _toy_one()
    worst = max(float(np.abs(four[0]["identity"]["whole"][n] - w).max()
                      / max(float(np.abs(w).max()), 1e-30))
                for n, w in want.items())
    assert worst > 1e-3, worst


@pytest.mark.parametrize("arch,micro", CASES, ids=str)
def test_moe_train_on_ranks_matches_the_8_device_reference(eight, ref, arch,
                                                           micro):
    """STEPS steps of build_train on (2, 4) ranks from the reference's
    init: losses, every parameter, m, v and master within TOL of the
    reference's (moments scaled to the leaf); every rank reports the same
    losses and grad_norm and gathers the same state."""
    cfg = _config(arch)
    got = eight[0][(arch, micro)]
    for r in eight:
        assert r[(arch, micro)]["losses"] == got["losses"]
        assert r[(arch, micro)]["norms"] == got["norms"]
        _same_tree(r[(arch, micro)]["final"], got["final"])
    want = ref[(arch, micro)]
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    assert_state(_port_state(got["final"], cfg), want["final"], cfg, TOL,
                 "leaf")


@pytest.mark.parametrize("arch,micro", CASES, ids=str)
def test_each_rank_holds_its_blocks_and_position_bytes(eight, arch, micro):
    """Every rank's blocks are the slices of the gathered leaves that its
    coordinates select, and a rank holds exactly position_bytes."""
    cfg = _config(arch)
    for r in eight:
        rec = r[(arch, micro)]
        assert rec["rank"]["held"] == rec["rank"]["position_bytes"]
        assert _assert_blocks(rec["rank"], rec["final"], cfg) > 0


def test_the_chunked_cross_entropy_on_ranks_gathers_each_chunks_logits(
        eight):
    """fused_ce on (2, 4) ranks, whose head splits the vocabulary: each
    chunk's logits are gathered whole (lm.head_logits), so the losses
    and parameters after STEPS steps are the one-position run's within
    TOL, the same on every rank."""
    got = eight[0]["fused_ce"]
    for r in eight:
        assert r["fused_ce"]["losses"] == got["losses"]
    want = _fused_ce_run((1, 1))
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    for name, w in want["params"].items():
        np.testing.assert_allclose(got["params"][name], w, err_msg=name,
                                   **TOL)


def test_the_train_step_builds_cp_and_refuses_model_batch_splits(eight):
    """On ranks build_train builds the cp strategy (q's rows split over
    "model": context parallelism, trained against the reference in
    tests/test_torch_world_seq.py) and refuses a batch split over the
    axis that splits the heads."""
    for r in eight:
        got = r["refused"]
        assert set(got) == {"cp", "batch_model"}, got
        assert got["cp"] == "built", got["cp"]
        assert "['model']" in got["batch_model"], got["batch_model"]
