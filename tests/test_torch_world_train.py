"""Train state split over the ranks of a torch.distributed world, on the
CPU: an 8-rank gloo world against the reference's 8-device child.

One module-scoped world (`world.spawn` over gloo, one CPU rank a mesh
position) runs every check of tests/multidevice_child.py that splits
train state: `check_sharded_train_step` (three steps on a (2, 4) rank
mesh), `check_elastic_rescale` ((2, 4) for two steps, a checkpoint
gathered and written by rank 0, restored a block a rank onto (8, 1), two
steps more) and `check_pipeline` (GPipe's ring on (4, 2) ranks), and the
train launcher with `--mesh 2,4`. The reference's outputs are those of
tests/test_torch_specs.py's child, made once a session
(`reference_outputs`). Every rank returns its blocks and the gathered
state; the parent holds them against the reference within the child's
own tolerances, and each block against its slice of the gathered leaf.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from test_torch_specs import (BLOCK_SPECS, ELASTIC_OPT, ELASTIC_TOL, TINY,
                              TOL, assert_state, reference_outputs)

from repro_torch.dist import world

DEADLINE_S = 240
PIPE_TOL = dict(rtol=1e-5, atol=1e-5)       # check_pipeline's
# Two AdamW runs whose gradients differ part by at most ~2 lr a step:
# |m_hat / sqrt(v_hat)| <= 1.0019 for t <= 4 at b1 0.9 and b2 0.95,
# whatever the gradients (Cauchy-Schwarz over the bias-corrected sums);
# a bf16 leaf by one bf16 unit of its largest magnitude more. The
# moments carry the gradients' scale: a relative norm error per leaf.
# chip_smoke.py holds its bf16 world runs by the same bounds.
ADAM_X = 2.01
BF16_ULP = 2.0 ** -7
MOMENT_REL = 5e-2
# one row a batch: no mesh splits it, every rank computes it whole and
# reduces nothing over "data"; on (2, 4) the tied vocabulary is split
# over "model", so the ranks' bf16 run is held to one process's by
# Adam's bound (ADAM_X, BF16_ULP, MOMENT_REL)
LAUNCH = ["--arch", "mamba2-1.3b", "--reduced", "--seq-len", "16",
          "--global-batch", "1", "--device", "cpu", "--lr", "1e-3"]


# --------------------------------------------------------------------------
# what the ranks run (module level, so a spawned rank can unpickle it)
# --------------------------------------------------------------------------

def _tiny():
    from repro_torch.configs import get_config
    return get_config("internlm2-1.8b").reduced(**TINY)


def _gather_state(state, sh, cfg) -> dict:
    """The whole state, gathered from every rank's blocks (every rank
    calls it alike), as the reference's tree of numpy arrays."""
    from repro_torch.dist.sharding import gather
    from repro_torch.models import convert
    from repro_torch.train import step as step_lib
    whole = {"params": step_lib.gathered(state["params"], sh["params"], cfg),
             "opt": {k: {n: gather(t, sh["opt"][k][n])
                         for n, t in state["opt"][k].items()}
                     for k in ("m", "v", "master") if k in state["opt"]},
             "step": state["step"]}
    whole["opt"]["count"] = state["opt"]["count"]
    return torch.utils._pytree.tree_map(_numpy,
                                        convert.state_to_reference(whole))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy in numpy; bf16 as float32, which holds it exactly."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _blocks(state, sh, mesh) -> dict:
    """This rank's coordinates, its blocks (numpy) with their specs, the
    bytes it holds and position_bytes."""
    from repro_torch.dist.sharding import position_bytes
    named = dict(state["params"].named_parameters())
    leaves = {("params", n): (t, sh["params"][n]) for n, t in named.items()}
    for k in ("m", "v", "master"):
        leaves.update({(k, n): (t, sh["opt"][k][n])
                       for n, t in state["opt"][k].items()})
    held = sum(t.numel() * t.element_size() for t, _ in leaves.values())
    held += sum(state[k].numel() * state[k].element_size()
                for k in ("step",)) + state["opt"]["count"].element_size()
    return {"coords": dict(mesh.coords), "shape": dict(mesh.shape),
            "held": held, "position_bytes": position_bytes(state, sh),
            "blocks": {key: (t.detach().numpy().copy(), tuple(s.spec),
                             s.global_shape)
                       for key, (t, s) in leaves.items()}}


def _run(fn, state, ds, mesh, batch_sh, lo, hi, same_batch=False):
    from repro_torch.data import make_global_batch
    specs_ = {k: s.spec for k, s in batch_sh.items()}
    losses = []
    for s in range(lo, hi):
        _, metrics = fn(state, make_global_batch(
            ds.batch(lo if same_batch else s), mesh, specs_))
        losses.append(float(metrics["loss"]))
    return losses


def _place_state(state, sh) -> dict:
    """A whole train state cut, in place, to this rank's blocks."""
    from repro_torch.dist.sharding import local_block
    from repro_torch.train import step as step_lib
    step_lib.place_blocks(state["params"], sh["params"])
    for k in ("m", "v", "master"):
        state["opt"][k] = {n: local_block(t, sh["opt"][k][n]).clone()
                           for n, t in state["opt"][k].items()}
    return state


def _setup(cfg, mesh_shape, batch, opt_kw, init_np):
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert
    from repro_torch.train import optim, step as step_lib
    mesh = make_mesh(mesh_shape, ("data", "model"), group=dist.group.WORLD)
    shape = ShapeSpec("tiny", "train", seq_len=32, global_batch=batch)
    opt_cfg = optim.AdamWConfig(**opt_kw)
    fn, _ = specs.build_train(cfg, shape, mesh, opt_cfg=opt_cfg)
    state_sh, batch_sh = fn.in_shardings
    if init_np is not None:
        state = _place_state(
            convert.state_from_reference(init_np, cfg, device="cpu"),
            state_sh)
    else:                     # a fresh draw, cut to this rank's blocks
        state, _ = step_lib.init_state(7, cfg, opt_cfg, device="cpu",
                                       mesh=mesh,
                                       rules=specs.rules_for(cfg, shape))
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=batch))
    return mesh, fn, state, state_sh, batch_sh, ds


def _train(ref) -> dict:
    """check_sharded_train_step on a (2, 4) rank mesh."""
    from repro_torch.dist import sharding
    cfg = _tiny()
    mesh, fn, state, sh, batch_sh, ds = _setup(cfg, (2, 4), 4, {},
                                               ref["train_init"])
    before = sharding.CONSTRAINT_CALLS
    losses = _run(fn, state, ds, mesh, batch_sh, 0, 3, same_batch=True)
    return {"losses": losses, "calls": sharding.CONSTRAINT_CALLS - before,
            "final": _gather_state(state, sh, cfg),
            "rank": _blocks(state, sh, mesh)}


def _elastic(ref, ck_dir: str) -> dict:
    """check_elastic_rescale: (2, 4) uninterrupted for 4 steps; (2, 4)
    for 2, saved, restored onto a fresh (8, 1) state, 2 more."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import convert
    cfg = _tiny()
    mesh_a, fn_a, st, sh_a, bsh_a, ds = _setup(cfg, (2, 4), 8, ELASTIC_OPT,
                                               ref["elastic_init"])
    _run(fn_a, st, ds, mesh_a, bsh_a, 0, 4)
    uninterrupted = _gather_state(st, sh_a, cfg)
    del st
    _, _, mid, _, _, _ = _setup(cfg, (2, 4), 8, ELASTIC_OPT,
                                ref["elastic_init"])
    _run(fn_a, mid, ds, mesh_a, bsh_a, 0, 2)
    mid_whole = _gather_state(mid, sh_a, cfg)
    mgr = CheckpointManager(ck_dir)
    mgr.save(2, convert.state_to_reference(mid),
             shardings=convert.shardings_to_reference(mid, sh_a))
    mgr.wait()
    mesh_b, fn_b, state, sh_b, bsh_b, _ = _setup(cfg, (8, 1), 8,
                                                 ELASTIC_OPT, None)
    skeleton = convert.state_to_reference(state)
    tree, meta = mgr.restore(skeleton, shardings=convert.
                             shardings_to_reference(state, sh_b))
    convert.load_reference_state(state, tree)
    _run(fn_b, state, ds, mesh_b, bsh_b, 2, 4)
    return {"uninterrupted": uninterrupted, "mid": mid_whole,
            "step": meta["step"], "final": _gather_state(state, sh_b, cfg),
            "rank_b": _blocks(state, sh_b, mesh_b)}


def _pipeline(ref) -> np.ndarray:
    import torch.distributed as dist

    from repro_torch.dist.pipeline_parallel import gpipe
    from repro_torch.dist.sharding import (NamedSharding, PartitionSpec,
                                           local_block)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4, 2), ("pod", "data"), group=dist.group.WORLD)
    ws = torch.from_numpy(ref["pipeline"]["ws"])
    xs = torch.from_numpy(ref["pipeline"]["xs"])
    block = local_block(ws, NamedSharding(mesh, PartitionSpec("pod")))
    return gpipe(lambda w, x: torch.tanh(x @ w), block, xs, mesh=mesh,
                 axis="pod").numpy()


def _two_axis_blocks() -> dict:
    """This rank's block of the child's (16, 8) leaf under each of
    BLOCK_SPECS on a (4, 2) ("pod", "data") rank mesh, and the leaf
    gathered back from the blocks."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import (NamedSharding, PartitionSpec,
                                           gather, local_block)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4, 2), ("pod", "data"), group=dist.group.WORLD)
    leaf = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
    out = {}
    for spec in BLOCK_SPECS:
        sh = NamedSharding(mesh, PartitionSpec(*spec))
        block = local_block(leaf, sh).clone()
        out[spec] = (block.numpy(), gather(block, sh).numpy())
    return out


def _launch(ck_dir: str, metrics: str) -> dict:
    """launch.train.main on every rank: 2 steps on (2, 4), then resumed
    from its checkpoint on (8, 1) to step 4."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import specs, train
    from repro_torch.launch.mesh import make_mesh
    ck = ["--checkpoint-dir", ck_dir, "--checkpoint-every", "2"]
    train.main(LAUNCH + ck + ["--steps", "2", "--mesh", "2,4"])
    state = train.main(LAUNCH + ck + ["--steps", "4", "--mesh", "8,1",
                                      "--metrics-file", metrics])
    cfg = get_config("mamba2-1.3b").reduced()
    mesh = make_mesh((8, 1), ("data", "model"), group=dist.group.WORLD)
    fn, _ = specs.build_train(cfg, ShapeSpec("cli", "train", 16, 1), mesh)
    return _gather_state(state, fn.in_shardings[0], cfg)


def _eight(ref, ck_elastic: str, ck_launch: str, metrics: str) -> dict:
    import torch.distributed as dist
    out = {"train": _train(ref), "elastic": _elastic(ref, ck_elastic),
           "pipeline": _pipeline(ref), "blocks": _two_axis_blocks(),
           "launch": _launch(ck_launch, metrics)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


def _one(ref) -> dict:
    """The (2, 4) run's steps on a (1, 1) mesh of one rank."""
    cfg = _tiny()
    mesh, fn, state, sh, batch_sh, ds = _setup(cfg, (1, 1), 4, {},
                                               ref["train_init"])
    losses = _run(fn, state, ds, mesh, batch_sh, 0, 3, same_batch=True)
    return {"losses": losses, "final": _gather_state(state, sh, cfg)}


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_outputs(tmp_path_factory)


@pytest.fixture(scope="module")
def eight(ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("world_train")
    return {"ranks": world.spawn(
        _eight, 8, backend="gloo", args=(ref, str(d / "elastic"),
                                         str(d / "launch"),
                                         str(d / "m.jsonl")),
        deadline_s=DEADLINE_S), "dir": d}


# --------------------------------------------------------------------------
# helpers of the parent
# --------------------------------------------------------------------------

def _port_state(tree_np, cfg):
    from repro_torch.models import convert
    return convert.state_from_reference(tree_np, cfg, device="cpu")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, np.asarray(tree)


def _expected_block(whole: np.ndarray, spec, rank: dict) -> np.ndarray:
    """The block of `whole` at a rank's coordinates: along a split dim,
    its coordinates row-major over the entry's axes."""
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n = math.prod(rank["shape"][a] for a in axes)
        index = 0
        for a in axes:
            index = index * rank["shape"][a] + rank["coords"][a]
        size = whole.shape[dim] // n
        whole = np.take(whole, range(index * size, (index + 1) * size),
                        axis=dim)
    return whole


def _assert_blocks(rank: dict, whole_state: dict, cfg) -> int:
    """Each block is its slice of the gathered leaf; returns the number
    of split leaves (none of which a rank holds whole)."""
    state = _port_state(whole_state, cfg)
    named = dict(state["params"].named_parameters())
    split = 0
    for (tree, name), (block, spec, gshape) in rank["blocks"].items():
        whole = (named[name] if tree == "params"
                 else state["opt"][tree][name]).detach().numpy()
        assert whole.shape == gshape, name
        want = _expected_block(whole, spec, rank)
        np.testing.assert_array_equal(block, want, err_msg=str(name))
        if block.shape != whole.shape:
            split += 1
    return split


def _within_adam_bound(got, want, dtypes, lrs) -> None:
    """Reference-layout trees of numpy leaves (bf16 widened; `dtypes`
    the port's dtype of each leaf) after steps taken at learning rates
    `lrs`: parameters and master within ADAM_X x sum(lrs) (bf16 leaves
    one BF16_ULP of the leaf's largest magnitude more), m and v within
    MOMENT_REL relative norm, integer leaves equal."""
    bound = ADAM_X * sum(lrs)
    flat_w = dict(_leaves(want))
    for (k, x), (k2, dt) in zip(_leaves(got), _leaves(dtypes), strict=True):
        y = flat_w[k]
        assert k == k2
        if not np.issubdtype(x.dtype, np.floating):
            np.testing.assert_array_equal(x, y, err_msg=str(k))
        elif k[:2] in (("opt", "m"), ("opt", "v")):
            norm = float(np.linalg.norm(y))
            assert float(np.linalg.norm(x - y)) <= MOMENT_REL * norm, k
        else:
            limit = bound + (BF16_ULP * float(max(np.abs(x).max(),
                                                  np.abs(y).max()))
                             if dt == torch.bfloat16 else 0.0)
            assert float(np.abs(x - y).max()) <= limit, (k, limit)


def _same_tree(a, b, tol=None):
    for (k, x), (k2, y) in zip(_leaves(a), _leaves(b), strict=True):
        assert k == k2
        if tol is None:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
        else:
            np.testing.assert_allclose(x, y, err_msg=str(k), **tol)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

def test_sharded_train_step_on_ranks_matches_the_8_device_reference(
        eight, ref):
    """check_sharded_train_step on a (2, 4) rank mesh: losses and the
    gathered final state within TOL of the reference's, the same on
    every rank; the constraints resolve as the virtual mesh's do."""
    cfg = _tiny()
    ranks = eight["ranks"]
    for r in ranks:
        assert r["train"]["losses"] == ranks[0]["train"]["losses"]
        _same_tree(r["train"]["final"], ranks[0]["train"]["final"])
        assert r["train"]["calls"] == 3 * (1 + 5 * 2)
    np.testing.assert_allclose(ranks[0]["train"]["losses"],
                               ref["train_losses"], **TOL)
    state = _port_state(ranks[0]["train"]["final"], cfg)
    assert_state(state, ref["train_final"], cfg, TOL, "leaf")


@pytest.mark.parametrize("run", ["train", "elastic"])
def test_each_rank_holds_its_blocks_and_position_bytes(eight, run):
    """Every rank's blocks are the slices of the gathered leaves that its
    coordinates select, no split leaf is whole on any rank, and a rank
    holds exactly position_bytes of the state."""
    cfg = _tiny()
    for r in eight["ranks"]:
        rec, whole = ((r["train"]["rank"], r["train"]["final"])
                      if run == "train" else
                      (r["elastic"]["rank_b"], r["elastic"]["final"]))
        assert rec["held"] == rec["position_bytes"]
        assert _assert_blocks(rec, whole, cfg) > 0
    first = eight["ranks"][0]["train"]["rank"]
    total = sum(b.nbytes for b, _, _ in first["blocks"].values())
    whole_bytes = sum(math.prod(g) * b.itemsize
                      for b, _, g in first["blocks"].values())
    assert total < whole_bytes / 2


def test_elastic_rescale_on_ranks_matches_the_reference(eight, ref):
    """(2, 4) -> save -> (8, 1) restore -> 2 steps: within ELASTIC_TOL of
    the reference's elastic final and of the port's uninterrupted rank
    run, and the uninterrupted run within it of the reference's."""
    cfg = _tiny()
    got = eight["ranks"][0]["elastic"]
    assert got["step"] == 2
    for r in eight["ranks"]:
        _same_tree(r["elastic"]["final"], got["final"])
    assert_state(_port_state(got["final"], cfg), ref["elastic_final"], cfg,
                 ELASTIC_TOL, ELASTIC_TOL)
    assert_state(_port_state(got["uninterrupted"], cfg), ref["elastic_ref"],
                 cfg, ELASTIC_TOL, ELASTIC_TOL)
    _same_tree(got["final"], got["uninterrupted"], ELASTIC_TOL)


def test_the_ranks_file_restores_in_one_process_bit_for_bit(eight):
    """The step-2 file rank 0 wrote, restored in one process onto a
    one-position mesh, equals the state the ranks gathered."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    mgr = CheckpointManager(eight["dir"] / "elastic")
    assert mgr.all_steps() == [2]
    want = eight["ranks"][0]["elastic"]["mid"]
    skeleton = torch.utils._pytree.tree_map(
        lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(a).dtype),
        want)
    tree, meta = mgr.restore(skeleton, shardings=make_mesh(
        (1,), ("data",), device="cpu"))
    assert meta["step"] == 2
    _same_tree(torch.utils._pytree.tree_map(lambda t: t.numpy(), tree),
               want)


@pytest.mark.parametrize("spec", BLOCK_SPECS, ids=str)
def test_blocks_follow_the_reference_device_layout(eight, ref, spec):
    """Rank r's block under a two-axis entry and a 2-D spec is the shard
    jax.device_put gives device r of the same (4, 2) mesh (rank r sits
    where jax.make_mesh puts device r), and gathering the blocks gives
    the leaf back."""
    want = ref["blocks"][spec]
    leaf = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    for rank, r in enumerate(eight["ranks"]):
        block, whole = r["blocks"][spec]
        np.testing.assert_array_equal(block, want[rank], err_msg=str(rank))
        np.testing.assert_array_equal(whole, leaf, err_msg=str(rank))


def test_gpipe_on_ranks_matches_check_pipeline(eight, ref):
    want = ref["pipeline"]["want"]
    for rank, r in enumerate(eight["ranks"]):
        got = r["pipeline"]
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, err_msg=str(rank), **PIPE_TOL)
    np.testing.assert_allclose(ref["pipeline"]["gpipe"], want, **PIPE_TOL)


def test_launcher_trains_on_ranks_and_resumes_on_another_mesh(eight):
    """launch.train.main on every rank: --mesh 2,4 for 2 steps, resumed
    from the ranks' checkpoint on --mesh 8,1; rank 0 alone wrote the
    metrics; the result is the same on every rank and the one-process
    launcher's run of 4 steps within Adam's bound (a one-row batch is
    whole on every rank, but on (2, 4) the tied vocabulary is split over
    "model": the bf16 gradient of the hidden state sums four partial
    products, rounded otherwise than one product)."""
    from repro_torch.launch import train
    from repro_torch.models import convert
    from repro_torch.train import optim
    for r in eight["ranks"]:
        _same_tree(r["launch"], eight["ranks"][0]["launch"])
    lines = (eight["dir"] / "m.jsonl").read_text().splitlines()
    assert len(lines) == 2            # steps 3 and 4, written once
    one = convert.state_to_reference(train.main(LAUNCH + ["--steps", "4"]))
    want = torch.utils._pytree.tree_map(_numpy, one)
    opt_cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=10, decay_steps=100)
    lrs = [float(optim.schedule(opt_cfg, torch.tensor(t)))
           for t in range(1, 5)]
    _within_adam_bound(eight["ranks"][0]["launch"], want,
                       torch.utils._pytree.tree_map(lambda t: t.dtype, one),
                       lrs)


def test_a_one_rank_mesh_step_equals_the_one_position_step(ref):
    """On a (1, 1) rank mesh nothing is split or reduced: three steps
    equal make_train_step's on a one-position mesh bit for bit."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLM, make_global_batch
    from repro_torch.dist.sharding import PartitionSpec as P
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert
    cfg = _tiny()
    got = world.spawn(_one, 1, backend="gloo", args=(ref,),
                      deadline_s=DEADLINE_S)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    fn, _ = specs.build_train(cfg, ShapeSpec("tiny", "train", 32, 4), mesh)
    state = _port_state(ref["train_init"], cfg)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=4))
    losses = []
    for _ in range(3):
        _, m = fn(state, make_global_batch(ds.batch(0), mesh, {
            "inputs": P("data"), "labels": P("data")}))
        losses.append(float(m["loss"]))
    assert got["losses"] == losses
    _same_tree(got["final"], torch.utils._pytree.tree_map(
        lambda t: t.detach().numpy(), convert.state_to_reference(state)))


def test_apply_updates_with_a_supplied_norm_is_the_single_device_update():
    """optim.apply_updates given global_norm(grads) as `norm` updates the
    parameters, m, v and master bit for bit as without it."""
    from repro_torch.models import lm
    from repro_torch.train import optim
    cfg = _tiny()
    runs = []
    for supplied in (False, True):
        model = lm.init(cfg, seed=2, device="cpu")
        opt_cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=1)
        state = optim.init(model, opt_cfg)
        g = torch.Generator().manual_seed(5)
        for _ in range(2):
            grads = {n: torch.randn(p.shape, generator=g)
                     for n, p in model.named_parameters()}
            norm = optim.global_norm(grads) if supplied else None
            _, state, metrics = optim.apply_updates(model, grads, state,
                                                    opt_cfg, norm=norm)
        runs.append((model, state, metrics))
    (a, sa, ma), (b, sb, mb) = runs
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    for k in ("m", "v", "master"):
        for n in sa[k]:
            assert torch.equal(sa[k][n], sb[k][n]), (k, n)
    assert torch.equal(ma["grad_norm"], mb["grad_norm"])
