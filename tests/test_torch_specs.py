"""The port's per-cell specs and step builders (repro_torch.launch.specs)
and its sharded train launcher against the reference, on the CPU.

The abstract args of build_train / build_prefill / build_serve equal the
reference's (jax.eval_shape) in shape and dtype, leaf for leaf through
convert.leaf_map (a stacked reference leaf holds the port's leaf of each
group). The sharded train step and the elastic rescale of
tests/multidevice_child.py run in the reference on 8 host devices: this
file runs itself as a child (`python tests/test_torch_specs.py child
OUT`) under XLA_FLAGS=--xla_force_host_platform_device_count=8, which
pickles the reference's initial state, losses and final states; the
parent carries the initial state across (convert.state_from_reference)
and runs the port on virtual meshes of the same shapes. Tolerances are
tests/test_torch_train.py's: MAMBA_TOL for losses and parameters after
optimizer steps, TOL scaled to the leaf for the moments; the elastic
rescale holds the reference child's own 2e-5 between the two packages,
and the port's resumed run equals its uninterrupted run bit for bit.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

CHILD_TIMEOUT_S = 300
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            dtype="float32")                # the child checks' config
TOL = dict(rtol=2e-4, atol=2e-4)
MAMBA_TOL = dict(rtol=2e-3, atol=2e-3)
ELASTIC_TOL = dict(rtol=2e-5, atol=2e-5)
ELASTIC_OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=10)


def _child(out_path: str) -> None:
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.checkpoint import CheckpointManager
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.data import DataConfig, SyntheticLM, make_global_batch
    from repro.dist.sharding import sharding_tree
    from repro.launch import specs
    from repro.launch.mesh import make_mesh
    from repro.train import optim, step as step_lib
    assert len(jax.devices()) == 8, jax.devices()
    cfg = get_config("internlm2-1.8b").reduced(**TINY)
    np_tree = lambda t: jax.tree.map(np.asarray, t)      # noqa: E731
    out = {}

    def setup(mesh, shape, opt_cfg):
        jitted, _ = specs.build_train(cfg, shape, mesh, opt_cfg=opt_cfg)
        state, axes = step_lib.init_state(jax.random.PRNGKey(0), cfg,
                                          opt_cfg)
        sh = sharding_tree(state, axes, mesh, specs.rules_for(cfg, shape))
        return jitted, state, sh

    def batch_of(ds, s, mesh):
        return make_global_batch(ds.batch(s), mesh, {"inputs": P("data"),
                                                     "labels": P("data")})

    # check_sharded_train_step: 3 steps on (2, 4), default AdamW
    mesh_a = make_mesh((2, 4), ("data", "model"))
    shape = ShapeSpec("tiny", "train", seq_len=32, global_batch=4)
    jitted, state, sh = setup(mesh_a, shape, optim.AdamWConfig())
    out["train_init"] = np_tree(state)
    state = jax.tree.map(jax.device_put, state, sh)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=4))
    losses = []
    for _ in range(3):
        state, metrics = jitted(state, batch_of(ds, 0, mesh_a))
        losses.append(float(metrics["loss"]))
    out["train_losses"], out["train_final"] = losses, np_tree(state)

    # check_elastic_rescale: (2, 4) for 4 steps, and 2 + checkpoint +
    # (8, 1) for 2
    import tempfile
    shape = ShapeSpec("tiny", "train", seq_len=32, global_batch=8)
    opt_cfg = optim.AdamWConfig(**ELASTIC_OPT)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=8))

    def run(jitted, state, mesh, lo, hi):
        for s in range(lo, hi):
            state, _ = jitted(state, batch_of(ds, s, mesh))
        return state

    jit_a, s0, sh_a = setup(mesh_a, shape, opt_cfg)
    out["elastic_init"] = np_tree(s0)
    ref = run(jit_a, jax.tree.map(jax.device_put, s0, sh_a), mesh_a, 0, 4)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mid = run(jit_a, jax.tree.map(jax.device_put, s0, sh_a), mesh_a, 0,
                  2)
        mgr.save(2, mid)
        mesh_b = make_mesh((8, 1), ("data", "model"))
        jit_b, skeleton, sh_b = setup(mesh_b, shape, opt_cfg)
        restored, _ = mgr.restore(skeleton, shardings=sh_b)
        final = run(jit_b, restored, mesh_b, 2, 4)
    out["elastic_ref"], out["elastic_final"] = np_tree(ref), np_tree(final)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    _child(sys.argv[2])
    sys.exit(0)


import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.data import make_global_batch  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.sharding import PartitionSpec as P  # noqa: E402
from repro_torch.launch import specs, train  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train import optim  # noqa: E402

ABSTRACT_ARCHS = ("internlm2-1.8b", "mamba2-1.3b", "recurrentgemma-2b",
                  "mixtral-8x22b", "musicgen-large")
# the reference's optimizer init makes its moments with np.zeros even under
# jax.eval_shape, so its abstract train state reserves (without touching)
# 8 bytes a parameter: the larger models' train state is compared reduced
FULL_WIDTH_TRAIN = ("internlm2-1.8b", "mamba2-1.3b")


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "reference.pkl"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, __file__, "child", str(out)],
                         env=env, capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT_S)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def assert_abstract_params(model, shapes):
    for name, (path, g) in convert.leaf_map(model).items():
        t, want = dict(model.named_parameters())[name], _at(shapes, path)
        assert t.is_meta, name
        got = tuple(t.shape) if g is None else (want.shape[0],) + tuple(
            t.shape)
        assert got == tuple(want.shape) and _dtype(t) == str(want.dtype), \
            name


def assert_abstract_caches(cfg, caches, want):
    p = len(cfg.block_pattern)
    stacked = cfg.num_layers // p * p
    for i, cache in enumerate(caches):
        path, g = ((("groups", i % p), i // p) if i < stacked
                   else (("tail", i - stacked), None))
        for k, t in cache.items():
            w = _at(want, path + (k,))
            got = tuple(t.shape) if g is None else (w.shape[0],) + tuple(
                t.shape)
            assert t.is_meta and got == tuple(w.shape), (i, k)
            assert _dtype(t) == str(w.dtype), (i, k)


def assert_same(got: torch.Tensor, want, name, kind=None):
    assert tuple(got.shape) == tuple(want.shape) and \
        _dtype(got) == str(want.dtype), name
    got = got.detach().numpy()
    if kind is None:
        np.testing.assert_array_equal(got, want, err_msg=name)
    elif kind == "leaf":           # TOL relative to the leaf's scale
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **kind)


@pytest.mark.parametrize("arch", ABSTRACT_ARCHS)
def test_build_abstract_args_equal_the_reference(arch):
    """train_4k, prefill_32k and decode_32k at the published widths (the
    train state of the larger models reduced)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    jmesh = jmake_mesh((1, 1), ("data", "model"))
    tcfg, tjcfg = ((cfg, jcfg) if arch in FULL_WIDTH_TRAIN
                   else (cfg.reduced(), jcfg.reduced()))
    _, (state, batch) = specs.build_train(tcfg, SHAPES["train_4k"], mesh)
    _, (jstate, jbatch) = jspecs.build_train(tjcfg, JSHAPES["train_4k"],
                                             jmesh)
    assert_abstract_params(state["params"], jstate["params"])
    leaves = convert.leaf_map(state["params"])
    for k in ("m", "v", "master"):
        for name, t in state["opt"][k].items():
            path, g = leaves[name]
            w = _at(jstate["opt"][k], path)
            got = tuple(t.shape) if g is None else (w.shape[0],) + tuple(
                t.shape)
            assert t.is_meta and got == tuple(w.shape), (k, name)
            assert _dtype(t) == str(w.dtype), (k, name)
    for t, w in ((state["step"], jstate["step"]),
                 (state["opt"]["count"], jstate["opt"]["count"])):
        assert t.is_meta and tuple(t.shape) == tuple(w.shape) == ()
        assert _dtype(t) == str(w.dtype)
    for k in ("inputs", "labels"):
        assert tuple(batch[k].shape) == tuple(jbatch[k].shape)
        assert _dtype(batch[k]) == str(jbatch[k].dtype)

    _, (params, inputs, caches) = specs.build_prefill(
        cfg, SHAPES["prefill_32k"], mesh)
    _, (jparams, jinputs, jcaches) = jspecs.build_prefill(
        jcfg, JSHAPES["prefill_32k"], jmesh)
    assert_abstract_params(params, jparams)
    assert_abstract_caches(cfg, caches, jcaches)
    assert tuple(inputs.shape) == tuple(jinputs.shape)
    assert _dtype(inputs) == str(jinputs.dtype)

    _, args = specs.build_serve(cfg, SHAPES["decode_32k"], mesh)
    _, jargs = jspecs.build_serve(jcfg, JSHAPES["decode_32k"], jmesh)
    assert_abstract_params(args[0], jargs[0])
    assert_abstract_caches(cfg, args[3], jargs[3])
    for i in (1, 2, 4):
        assert args[i].is_meta
        assert tuple(args[i].shape) == tuple(jargs[i].shape)
        assert _dtype(args[i]) == str(jargs[i].dtype)


def tiny():
    return get_config("internlm2-1.8b").reduced(**TINY)


def port_state(tree_np, cfg):
    return convert.state_from_reference(tree_np, cfg, device="cpu")


def batch_on(ds, s, mesh):
    return make_global_batch(ds.batch(s), mesh, {"inputs": P("data"),
                                                 "labels": P("data")})


def assert_state(state, want, cfg, params_tol, moment_tol):
    leaves = convert.leaf_map(state["params"])
    named = dict(state["params"].named_parameters())
    for tree, port, tol in [(want["params"], named, params_tol)] + [
            (want["opt"][k], state["opt"][k],
             params_tol if k == "master" else moment_tol)
            for k in ("m", "v", "master")]:
        for name, (path, g) in leaves.items():
            w = np.asarray(_at(tree, path))
            assert_same(port[name], w if g is None else w[g], name, tol)
    assert int(state["step"]) == int(want["step"])
    assert int(state["opt"]["count"]) == int(want["opt"]["count"])


def test_sharded_train_step_matches_the_8_device_reference(child):
    """tests/multidevice_child.py::check_sharded_train_step: 3 steps on a
    (2, 4) mesh, the port's on virtual positions."""
    cfg = tiny()
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    shape = ShapeSpec("tiny", "train", seq_len=32, global_batch=4)
    fn, _ = specs.build_train(cfg, shape, mesh)
    state = port_state(child["train_init"], cfg)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=4))
    losses, before = [], sharding.CONSTRAINT_CALLS
    for _ in range(3):
        out, metrics = fn(state, batch_on(ds, 0, mesh))
        assert out is state
        losses.append(float(metrics["loss"]))
    # the embedding, two residuals and three attention hooks a layer
    assert sharding.CONSTRAINT_CALLS - before == 3 * (1 + 5 * 2)
    np.testing.assert_allclose(losses, child["train_losses"], **MAMBA_TOL)
    assert np.isfinite(losses).all()
    assert_state(state, child["train_final"], cfg, MAMBA_TOL, "leaf")


def test_sharded_step_refuses_a_tensor_off_the_mesh_device():
    cfg = tiny()
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    shape = ShapeSpec("tiny", "train", seq_len=32, global_batch=4)
    fn, (abstract, _) = specs.build_train(cfg, shape, mesh)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=4))
    with pytest.raises(ValueError, match="meta"):
        fn(abstract, batch_on(ds, 0, mesh))


def run_port(fn, state, ds, mesh, lo, hi):
    for s in range(lo, hi):
        fn(state, batch_on(ds, s, mesh))
    return state


def test_elastic_rescale_is_bit_identical_and_matches_reference(child,
                                                                tmp_path):
    """(2, 4) -> checkpoint -> (8, 1): the resumed port run equals its
    uninterrupted run bit for bit, and both are within the reference
    child's 2e-5 of the reference's runs."""
    cfg = tiny()
    shape = ShapeSpec("tiny", "train", seq_len=32, global_batch=8)
    opt_cfg = optim.AdamWConfig(**ELASTIC_OPT)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=8))
    mesh_a = make_mesh((2, 4), ("data", "model"), device="cpu")
    mesh_b = make_mesh((8, 1), ("data", "model"), device="cpu")
    fn_a, _ = specs.build_train(cfg, shape, mesh_a, opt_cfg=opt_cfg)
    fn_b, _ = specs.build_train(cfg, shape, mesh_b, opt_cfg=opt_cfg)
    ref = run_port(fn_a, port_state(child["elastic_init"], cfg), ds, mesh_a,
                   0, 4)
    mid = run_port(fn_a, port_state(child["elastic_init"], cfg), ds, mesh_a,
                   0, 2)
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, convert.state_to_reference(mid))
    resumed = port_state(child["elastic_init"], cfg)
    skeleton = convert.state_to_reference(resumed)
    tree, meta = mgr.restore(skeleton, shardings=mesh_b)
    assert meta["step"] == 2
    convert.load_reference_state(resumed, tree)
    final = run_port(fn_b, resumed, ds, mesh_b, 2, 4)
    want = jax.tree.map(np.asarray, convert.state_to_reference(ref))
    assert_state(final, want, cfg, None, None)
    assert_state(ref, child["elastic_ref"], cfg, ELASTIC_TOL, ELASTIC_TOL)
    assert_state(final, child["elastic_final"], cfg, ELASTIC_TOL,
                 ELASTIC_TOL)


def test_sharded_serve_step_equals_the_one_position_step():
    """A reduced mixtral (tests/multidevice_child.py's serve check)
    through build_prefill and build_serve on a (2, 4) virtual mesh: the
    logits and greedy tokens of a prefill and four decode steps equal
    engine.make_prefill_step / make_serve_step's bit for bit, and the
    caches are refilled in place."""
    cfg = get_config("mixtral-8x22b").reduced(num_layers=2,
                                              dtype="float32")
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    b, s, max_len = 4, 16, 64
    model = lm.init(cfg, seed=3, device="cpu")
    prefill, _ = specs.build_prefill(
        cfg, ShapeSpec("tinypre", "prefill", max_len, b), mesh)
    serve, (_, _, _, _, key) = specs.build_serve(
        cfg, ShapeSpec("tinydec", "decode", max_len, b), mesh)
    assert tuple(key.shape) == (2,) and key.dtype == torch.uint32
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))
    runs = []
    for sharded in (True, False):
        caches = lm.init_caches(cfg, b, max_len, device="cpu")
        with torch.no_grad():
            if sharded:
                logits, out = prefill(model, tokens, caches)
                assert out is caches
            else:
                logits, caches = engine.make_prefill_step(cfg)(
                    model, tokens, caches)
            got = [logits]
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            cache_len = torch.full((b,), s, dtype=torch.int32)
            for _ in range(4):
                if sharded:
                    nxt, logits, caches = serve(
                        model, nxt[:, None], cache_len, caches,
                        torch.zeros(2, dtype=torch.uint32))
                else:
                    nxt, logits, caches = engine.make_serve_step(cfg)(
                        model, nxt[:, None], cache_len, caches, None)
                got += [logits, nxt]
                cache_len = cache_len + 1
        runs.append(got)
    for a, c in zip(*runs):
        assert torch.equal(a, c)


def test_launcher_trains_on_a_2x4_mesh_and_resumes(tmp_path, capsys):
    """`launch.train --mesh 2,4` runs and resumes on the CPU, and ends
    where a one-position run of the same steps ends, bit for bit."""
    common = ["--arch", "mamba2-1.3b", "--reduced", "--seq-len", "16",
              "--global-batch", "2", "--device", "cpu"]
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every",
          "2"]
    train.main(common + ck + ["--steps", "2", "--mesh", "2,4"])
    state = train.main(common + ck + ["--steps", "4", "--mesh", "8,1"])
    assert "[restore] resumed from step 2" in capsys.readouterr().out
    one = train.main(common + ["--steps", "4", "--mesh", "1"])
    assert int(state["step"]) == int(one["step"]) == 4
    a = convert.state_to_reference(state)
    b = convert.state_to_reference(one)
    for (k, x), (_, y) in zip(
            sorted(torch.utils._pytree.tree_flatten_with_path(a)[0],
                   key=lambda kv: str(kv[0])),
            sorted(torch.utils._pytree.tree_flatten_with_path(b)[0],
                   key=lambda kv: str(kv[0]))):
        assert torch.equal(x, y), k


def test_production_mesh_and_metrics_count_positions_as_chips(tmp_path):
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train.metrics import MetricsLogger
    single = make_production_mesh(device="cpu")
    multi = make_production_mesh(multi_pod=True, device="cpu")
    assert (single.axis_names, dict(single.shape)) == (
        ("data", "model"), {"data": 16, "model": 16})
    assert (multi.axis_names, dict(multi.shape)) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16})
    assert single.size == 256 and multi.size == 512
    assert single.device_set == {torch.device("cpu")}
    shape = ShapeSpec("cli", "train", 128, 8)
    log = MetricsLogger(tmp_path / "m.jsonl", tiny(), shape,
                        chips=single.size)
    assert log.chips == 256
    log.close()


def _smoke_constant(name: str):
    """A literal constant of chip_smoke.py, read without importing it."""
    import ast
    tree = ast.parse((Path(__file__).resolve().parents[1]
                      / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_production_mesh_bytes_equal_the_reference_and_the_smoke():
    """Bytes one position of make_production_mesh() (and the multi-pod
    mesh) holds of the train state under megatron at train_4k: the port's
    shard_shape over its meta state, the reference's resolve_spec over its
    abstract params (plus fp32 m, v and master, and the int32 count and
    step), and the chip smoke's PROD_BYTES all agree."""
    from test_sharding_rules import MULTI, SINGLE

    from repro.dist import sharding as jsh
    from repro.dist import strategies as jstrat
    from repro_torch.dist import strategies
    from repro_torch.launch.mesh import make_production_mesh
    want = _smoke_constant("PROD_BYTES")
    assert tuple(want) == _smoke_constant("PROD_ARCHS")
    meshes = {"single": (make_production_mesh(device="cpu"), SINGLE),
              "multi": (make_production_mesh(multi_pod=True, device="cpu"),
                        MULTI)}
    for arch, by_mesh in want.items():
        cfg, jcfg = get_config(arch), jget_config(arch)
        state, axes = specs.state_specs(cfg, optim.AdamWConfig())
        rules = specs.rules_for(cfg, SHAPES["train_4k"],
                                strategies.strategy_for(
                                    cfg, SHAPES["train_4k"], "megatron")[0])
        jrules = jspecs.rules_for(jcfg, JSHAPES["train_4k"],
                                  jstrat.strategy_for(
                                      jcfg, JSHAPES["train_4k"],
                                      "megatron")[0])
        jshapes, jaxes = jspecs.params_specs(jcfg)
        flat = jax.tree_util.tree_leaves(jax.tree.map(
            lambda s, a: (s, a), jshapes, jaxes))
        pairs = list(zip(flat[0::2], flat[1::2]))
        for key, (mesh, fake) in meshes.items():
            got = sharding.position_bytes(
                state, sharding.sharding_tree(state, axes, mesh, rules))
            ref = 8                                  # count and step
            for s, a in pairs:
                spec = jsh.resolve_spec(s.shape, a, fake, jrules)
                n = int(np.prod(s.shape))
                for e in spec:
                    for ax in (e if isinstance(e, tuple) else (e,)):
                        n //= fake.shape[ax] if ax else 1
                ref += n * (s.dtype.itemsize + 3 * 4)
            assert got == ref == by_mesh[key], (arch, key, got, ref)
