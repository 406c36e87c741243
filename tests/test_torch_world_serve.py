"""The serve step on the ranks of a torch.distributed world, on the CPU:
an 8-rank gloo world against the reference's 8-device serve step.

`specs.build_prefill` / `build_serve` on a RankMesh hold the parameters
and caches split as the reference's rules lay them out and compute
tensor- and expert-parallel over "model". This file runs itself as a
child (`python tests/test_torch_world_serve.py child OUT`) under
XLA_FLAGS=--xla_force_host_platform_device_count=8, which runs the
reference's jitted build_prefill + build_serve (a prefill of B rows of
S tokens, then NEW greedy decode steps) for reduced mixtral on (2, 4)
(heads split, kv heads whole, experts split) and (1, 8) (heads and
experts whole, the expert hidden dim and the vocabulary split) and
reduced internlm2 on (2, 4), and pickles its weights, logits and
tokens. One module-scoped 8-rank gloo world runs the same steps on rank
meshes with the weights carried across (convert), and the port's own
weights, drawn a leaf at a time and cut to each rank's blocks, for
moonshot (its split router_bias), mamba2, recurrentgemma, internlm2
under the dp and 2d strategies, and mixtral on (8, 1), against the
port's one-position steps. Logits within TOL, greedy tokens equal; a
one-rank mesh is the one-position step bit for bit. The sequence splits
(cp, 2d_splitcache, long_500k) build on ranks here and run in
tests/test_torch_world_seq.py.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

B, S, NEW, MAX_LEN = 4, 16, 4, 32    # rows, prompt, decode steps, ring
SEED = 3
AXES = ("data", "model")
REF_CASES = (("mixtral-8x22b", (2, 4)), ("mixtral-8x22b", (1, 8)),
             ("internlm2-1.8b", (2, 4)))
# (arch, mesh, strategy): the port's own draw against its one-position step
PORT_CASES = (("moonshot-v1-16b-a3b", (2, 4), "megatron"),
              ("mamba2-1.3b", (2, 4), "megatron"),
              ("recurrentgemma-2b", (2, 4), "megatron"),
              ("internlm2-1.8b", (2, 4), "dp"),
              ("internlm2-1.8b", (2, 4), "2d"),
              ("mixtral-8x22b", (8, 1), "megatron"))
SEQUENCE_SPLITS = ("cp", "2d_splitcache", "long_500k")
DEADLINE_S = 240


def _config(arch, package="repro_torch"):
    import importlib
    get = importlib.import_module(package + ".configs").get_config
    return get(arch).reduced(dtype="float32")


def _prompt(vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, (B, S)).astype(
        np.int32)


def _child(out_path: str) -> None:
    import jax

    from repro.configs.base import ShapeSpec
    from repro.launch import specs
    from repro.launch.mesh import make_mesh
    from repro.models import lm as jlm
    assert len(jax.devices()) == 8, jax.devices()
    np_tree = lambda t: jax.tree.map(np.asarray, t)      # noqa: E731
    out = {"params": {}, "runs": {}}
    for arch, dims in REF_CASES:
        cfg = _config(arch, "repro")
        if arch not in out["params"]:
            out["params"][arch] = np_tree(jax.jit(
                lambda k: jlm.init(k, cfg)[0])(jax.random.PRNGKey(SEED)))
        params = out["params"][arch]
        mesh = make_mesh(dims, AXES)
        prefill, _ = specs.build_prefill(
            cfg, ShapeSpec("p", "prefill", MAX_LEN, B), mesh)
        serve, _ = specs.build_serve(
            cfg, ShapeSpec("d", "decode", MAX_LEN, B), mesh)
        caches = np_tree(jlm.init_caches(cfg, B, MAX_LEN)[0])
        logits, caches = prefill(params, _prompt(cfg.vocab_size), caches)
        got = [np.asarray(logits)]
        nxt = np.argmax(got[0], axis=-1).astype(np.int32)
        cache_len = np.full((B,), S, np.int32)
        key = jax.random.PRNGKey(0)
        for _ in range(NEW):
            nxt, logits, caches = serve(params, nxt[:, None], cache_len,
                                        caches, key)
            nxt = np.asarray(nxt)
            got += [np.asarray(logits), nxt]
            cache_len = cache_len + 1
        out["runs"][(arch, dims)] = got
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    _child(sys.argv[2])
    sys.exit(0)


import torch  # noqa: E402
from test_torch_specs import CHILD_TIMEOUT_S, TOL  # noqa: E402
from test_torch_world_train import _expected_block  # noqa: E402

from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.dist import world  # noqa: E402

TRAIN = ShapeSpec("t", "train", S, B)       # a train cell


# --------------------------------------------------------------------------
# what the ranks run (module level, so a spawned rank can unpickle it)
# --------------------------------------------------------------------------

def _steps(cfg, mesh, strategy="megatron", shape_name="d"):
    from repro_torch.dist import strategies
    from repro_torch.launch import specs
    extra, cfg, _ = strategies.strategy_for(cfg, None, strategy)
    pre = ShapeSpec(shape_name, "prefill", MAX_LEN, B)
    dec = ShapeSpec(shape_name, "decode", MAX_LEN, B)
    prefill, _ = specs.build_prefill(cfg, pre, mesh, rules_extra=extra)
    serve, _ = specs.build_serve(cfg, dec, mesh, rules_extra=extra)
    return prefill, serve, specs.rules_for(cfg, dec, extra)


def _drive(cfg, params, caches, prefill=None, serve=None, rows=slice(None)):
    """A prefill of _prompt's `rows` and NEW greedy steps through the
    built steps (or, without them, engine's one-position steps): the
    logits of every step and the tokens of the decode steps, global."""
    from repro_torch.serve import engine
    prefill = prefill or engine.make_prefill_step(cfg)
    serve = serve or (lambda p, i, n, c, k: engine.make_serve_step(cfg)(
        p, i, n, c, None))
    tokens = torch.from_numpy(_prompt(cfg.vocab_size))[rows]
    with torch.no_grad():
        logits, caches = prefill(params, tokens, caches)
        out = [logits.numpy()]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        cache_len = torch.full((tokens.shape[0],), S, dtype=torch.int32)
        key = torch.zeros(2, dtype=torch.uint32)
        for _ in range(NEW):
            nxt, logits, caches = serve(params, nxt[rows, None], cache_len,
                                        caches, key)
            out += [logits.numpy(), nxt.numpy()]
            cache_len = cache_len + 1
    return out


class _Gathers:
    """While open, each call of sharding.gather: (its axes, the leaf's
    spec, the leaf's global shape, the shape it returned)."""

    def __enter__(self):
        from repro_torch.dist import sharding
        self.mod, self.real, self.calls = sharding, sharding.gather, []

        def call(block, sh, axes=None):
            out = self.real(block, sh, axes)
            self.calls.append((axes, tuple(sh.spec), sh.global_shape,
                               tuple(out.shape)))
            return out
        sharding.gather = call
        return self

    def __exit__(self, *exc):
        self.mod.gather = self.real


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in
               torch.utils._pytree.tree_leaves(tree))


def _serve_case(cfg, mesh, params, strategy="megatron") -> dict:
    """The rank's run of one case: its outputs, the gathers it made, the
    bytes it holds against position_bytes."""
    from repro_torch.dist.sharding import position_bytes
    from repro_torch.models import lm
    prefill, serve, rules = _steps(cfg, mesh, strategy)
    caches = lm.init_caches(cfg, B, MAX_LEN, mesh=mesh, rules=rules)
    axes = prefill.in_shardings[1].dim_axes(0)
    n = int(np.prod([mesh.shape[a] for a in axes]))
    start = mesh.block_index(axes) * (B // n)
    rec = {"coords": dict(mesh.coords), "shape": dict(mesh.shape),
           "held": (_tree_bytes(dict(params.named_parameters())),
                    _tree_bytes(caches)),
           "position_bytes": (
               position_bytes(params, prefill.in_shardings[0]),
               position_bytes(caches, prefill.in_shardings[2]))}
    with _Gathers() as g:
        rec["out"] = _drive(cfg, params, caches, prefill, serve,
                            slice(start, start + B // n))
    rec["gathers"] = g.calls
    return rec


def _blocks(params, shardings) -> dict:
    return {n: (p.detach().numpy().copy(), tuple(shardings[n].spec),
                shardings[n].global_shape)
            for n, p in params.named_parameters()}


def _refusals(mesh) -> dict:
    """What the builds of the sequence splits give on ranks ("built", or
    the message they raise: tests/test_torch_world_seq.py runs them), and
    the message of the build that must raise."""
    from repro_torch.launch import specs
    cfg = _config("mixtral-8x22b")
    out = {}
    for name in SEQUENCE_SPLITS:
        try:
            if name == "long_500k":
                specs.build_serve(cfg, ShapeSpec(name, "decode", MAX_LEN, 1),
                                  mesh)
            else:
                _steps(cfg, mesh, name)
            out[name] = "built"
        except NotImplementedError as e:
            out[name] = str(e)
    specs.build_train(cfg, TRAIN, mesh)    # builds: MoE trains on ranks
    try:        # rows split over "model" beside heads split over it
        specs.build_serve(cfg, ShapeSpec("d", "decode", MAX_LEN, 8), mesh,
                          rules_extra={"batch": ("data", "model")})
    except NotImplementedError as e:
        out["batch_model"] = str(e)
    return out


def _eight(ref) -> list:
    import torch.distributed as dist

    from repro_torch.dist.sharding import sharding_tree
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert, lm
    from repro_torch.train import optim, step as step_lib
    out = {"ref": {}, "port": {}}
    for arch, dims in REF_CASES:
        cfg = _config(arch)
        mesh = make_mesh(dims, AXES, group=dist.group.WORLD)
        prefill, _, _ = _steps(cfg, mesh)
        params = step_lib.place_blocks(convert.params_from_reference(
            ref["params"][arch], cfg, device="cpu"),
            prefill.in_shardings[0])
        out["ref"][(arch, dims)] = _serve_case(cfg, mesh, params)
    for arch, dims, strategy in PORT_CASES:
        cfg = _config(arch)
        mesh = make_mesh(dims, AXES, group=dist.group.WORLD)
        _, _, rules = _steps(cfg, mesh, strategy)
        params = lm.init(cfg, seed=SEED, device="cpu", mesh=mesh,
                         rules=rules)
        rec = _serve_case(cfg, mesh, params, strategy)
        if strategy == "megatron":
            rec["blocks"] = _blocks(params, _steps(cfg, mesh)[0]
                                    .in_shardings[0])
        out["port"][(arch, dims, strategy)] = rec
    mesh = make_mesh((2, 4), AXES, group=dist.group.WORLD)
    out["refused"] = _refusals(mesh)
    cfg = _config("internlm2-1.8b")
    state, _ = step_lib.init_state(7, cfg, optim.AdamWConfig(),
                                   device="cpu", mesh=mesh,
                                   rules=specs.rules_for(cfg, TRAIN))
    out["train_blocks"] = _blocks(
        state["params"],
        sharding_tree(lm.init(cfg, device="meta"), lm.param_axes(cfg),
                      mesh, specs.rules_for(cfg, TRAIN)))
    out["coords"] = dict(mesh.coords)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


def _one() -> list:
    """Mixtral's steps on a (1, 1) mesh of one rank."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    cfg = _config("mixtral-8x22b")
    mesh = make_mesh((1, 1), AXES, group=dist.group.WORLD)
    prefill, serve, rules = _steps(cfg, mesh)
    params = lm.init(cfg, seed=SEED, device="cpu", mesh=mesh, rules=rules)
    caches = lm.init_caches(cfg, B, MAX_LEN, mesh=mesh, rules=rules)
    return _drive(cfg, params, caches, prefill, serve)


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("world_serve") / "reference.pkl"
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


# --------------------------------------------------------------------------
# helpers of the parent
# --------------------------------------------------------------------------

def _one_position(arch, strategy="megatron"):
    from repro_torch.dist import strategies
    from repro_torch.models import lm
    cfg = strategies.strategy_for(_config(arch), None, strategy)[1]
    model = lm.init(cfg, seed=SEED, device="cpu")
    return _drive(cfg, model, lm.init_caches(cfg, B, MAX_LEN, device="cpu"))


def _assert_outputs(got, want):
    """Logits within TOL, tokens equal, step by step."""
    assert len(got) == len(want) == 1 + 2 * NEW
    for i, (a, b) in enumerate(zip(got, want)):
        if i and i % 2 == 0:
            np.testing.assert_array_equal(a, b, err_msg=f"tokens {i}")
        else:
            np.testing.assert_allclose(a, b, err_msg=f"logits {i}", **TOL)


def _assert_rank_records(ranks, key, kind):
    """Every rank returns the same global outputs and holds exactly
    position_bytes; no gather brings back a "model"-split leaf whole."""
    for r in ranks:
        rec = r[kind][key]
        for a, b in zip(rec["out"], ranks[0][kind][key]["out"]):
            np.testing.assert_array_equal(a, b)
        assert rec["held"] == rec["position_bytes"]
        for axes, spec, gshape, shape in rec["gathers"]:
            assert axes is not None and "model" not in axes, (key, axes)
            for dim, entry in enumerate(spec):
                group = entry if isinstance(entry, tuple) else (entry,)
                if "model" in group and rec["shape"]["model"] > 1:
                    assert shape[dim] < gshape[dim], (key, spec, shape)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dims", REF_CASES, ids=str)
def test_serve_on_ranks_matches_the_8_device_reference(eight, ref, arch,
                                                       dims):
    """build_prefill + build_serve on a rank mesh: a prefill and NEW
    greedy steps within TOL of the reference's jitted steps on the same
    8-device mesh, tokens equal, the same on every rank."""
    _assert_rank_records(eight, (arch, dims), "ref")
    _assert_outputs(eight[0]["ref"][(arch, dims)]["out"],
                    ref["runs"][(arch, dims)])


@pytest.mark.parametrize("arch,dims,strategy", PORT_CASES, ids=str)
def test_serve_on_ranks_matches_the_one_position_step(eight, arch, dims,
                                                      strategy):
    """The port's own weights, drawn a leaf at a time and cut to each
    rank's blocks, through the rank steps: within TOL of the
    one-position steps on the whole draw, tokens equal."""
    key = (arch, dims, strategy)
    _assert_rank_records(eight, key, "port")
    _assert_outputs(eight[0]["port"][key]["out"],
                    _one_position(arch, strategy))


@pytest.mark.parametrize("arch,dims,strategy",
                         [c for c in PORT_CASES if c[2] == "megatron"],
                         ids=str)
def test_streamed_init_keeps_each_ranks_block_of_the_whole_draw(
        eight, arch, dims, strategy):
    """lm.init(mesh=) on every rank: each leaf is the block of the whole
    lm.init(seed) that the rank's coordinates select, bit for bit."""
    from repro_torch.models import lm
    whole = dict(lm.init(_config(arch), seed=SEED,
                         device="cpu").named_parameters())
    split = 0
    for r in eight:
        rec = r["port"][(arch, dims, strategy)]
        assert set(rec["blocks"]) == set(whole)
        for name, (block, spec, gshape) in rec["blocks"].items():
            w = whole[name].numpy()
            assert w.shape == gshape, name
            np.testing.assert_array_equal(
                block, _expected_block(w, spec, rec), err_msg=name)
            split += block.shape != w.shape
    assert split > 0


def test_init_state_on_ranks_keeps_the_blocks_of_the_whole_state(eight):
    """init_state(mesh=) draws through lm.init's rank form: every rank's
    parameters are the blocks of the whole init_state that place_blocks
    would cut, bit for bit."""
    from repro_torch.train import optim, step as step_lib
    state, _ = step_lib.init_state(7, _config("internlm2-1.8b"),
                                   optim.AdamWConfig(), device="cpu")
    whole = dict(state["params"].named_parameters())
    for r in eight:
        rec = {"coords": r["coords"], "shape": {"data": 2, "model": 4}}
        for name, (block, spec, _) in r["train_blocks"].items():
            np.testing.assert_array_equal(
                block, _expected_block(whole[name].detach().numpy(), spec,
                                       rec), err_msg=name)


def test_a_one_rank_mesh_serves_as_the_one_position_step():
    """Mixtral's steps on a (1, 1) rank mesh equal the one-position
    steps bit for bit: no collective, no masked lookup, the same
    products."""
    got = world.spawn(_one, 1, backend="gloo", deadline_s=DEADLINE_S)
    for a, b in zip(got, _one_position("mixtral-8x22b"), strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_sequence_splits_build_and_a_model_batch_split_refuses_on_ranks(
        eight):
    """cp, 2d_splitcache and long_500k's kv_seq rule split a sequence dim
    over ranks: their prefill and serve steps build there (split-K decode
    and context parallelism, held against the reference in
    tests/test_torch_world_seq.py), and a batch split over the axis that
    splits the heads is refused. The MoE train step builds on ranks too
    (tests/test_torch_world_train_tp.py trains it)."""
    for r in eight:
        got = r["refused"]
        assert set(got) == set(SEQUENCE_SPLITS) | {"batch_model"}
        for name in SEQUENCE_SPLITS:
            assert got[name] == "built", got[name]
        assert "['model']" in got["batch_model"], got["batch_model"]
