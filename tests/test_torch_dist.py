"""Parity of the port's distribution substrate (repro_torch.dist.sharding,
.strategies, .compression, .pipeline_parallel) with the reference, on the
CPU.

Rule resolution is pure arithmetic over a mesh's shape: every case of
tests/test_sharding_rules.py runs through both packages' resolve_spec on
that file's own FakeMesh, and the specs compare entry by entry. The two
collectives run in the port over virtual positions of one device; the
reference runs them with shard_map over 8 host devices, so this file runs
itself as a child (`python tests/test_torch_dist.py child OUT`) under
XLA_FLAGS=--xla_force_host_platform_device_count=8, feeds the reference
the same numpy inputs and pickles its outputs for the parent to compare.
Bounds: the int8 codes, the compressed psum and the error-feedback
residuals bit for bit (the same float32 operations in the same order);
GPipe within tests/multidevice_child.py's 1e-5 (the port batches the
four stages' products into one, which rounds differently from four).
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
GPIPE = dict(s=4, m=8, d=16)          # tests/multidevice_child.py's shapes
GPIPE_TOL = dict(rtol=1e-5, atol=1e-5)


def compression_inputs():
    rng = np.random.default_rng(1)
    return {"a": rng.standard_normal((64, 32), dtype=np.float32),
            "b": rng.standard_normal((8,), dtype=np.float32) * 10,
            "c": np.zeros((3, 5), np.float32),
            "d": np.float32(-2.5) * np.ones((), np.float32)}


def gpipe_inputs():
    rng = np.random.default_rng(0)
    s, m, d = GPIPE["s"], GPIPE["m"], GPIPE["d"]
    ws = (rng.standard_normal((s, d, d), dtype=np.float32)
          / np.float32(np.sqrt(d)))
    xs = rng.standard_normal((m, 2, d), dtype=np.float32)
    return ws, xs


def _child(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.dist.compression import compressed_psum_pod
    from repro.dist.pipeline_parallel import gpipe
    from repro.launch.mesh import make_mesh
    assert len(jax.devices()) == 8, jax.devices()
    mesh = make_mesh((4, 2), ("pod", "data"))
    g = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P()))
         for k, v in compression_inputs().items()}
    psum = jax.tree.map(np.asarray, compressed_psum_pod(g, mesh,
                                                        axis="pod"))
    ws, xs = gpipe_inputs()
    pods = make_mesh((4,), ("pod",))
    pipe = np.asarray(gpipe(lambda w, x: jnp.tanh(x @ w), jnp.asarray(ws),
                            jnp.asarray(xs), mesh=pods, axis="pod"))
    with open(out_path, "wb") as f:
        pickle.dump({"psum": psum, "gpipe": pipe}, f)


if __name__ == "__main__":
    _child(sys.argv[2])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_sharding_rules import MULTI, SINGLE, FakeMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.dist import compression as jcomp  # noqa: E402
from repro.dist import pipeline_parallel as jpipe  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.dist import strategies as jstrat  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import compression, pipeline_parallel  # noqa: E402
from repro_torch.dist import sharding, strategies  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist") / "reference.pkl"
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


# --------------------------------------------------------------------------
# rule resolution: tests/test_sharding_rules.py's cases in both packages
# --------------------------------------------------------------------------

RULE_CASES = [
    # (id, shape, names, mesh, rule overrides, expected spec entries)
    ("tp_plus_fsdp", (4096, 8192), ("embed", "mlp"), SINGLE, None,
     ("data", "model")),
    ("missing_axis_dropped", (256, 64), ("batch", None), SINGLE, None,
     ("data",)),
    ("missing_axis_multi", (256, 64), ("batch", None), MULTI, None,
     (("pod", "data"),)),
    ("indivisible_falls_back", (3072, 24, 128),
     ("embed", "heads", "head_dim"), SINGLE, None, ("data",)),
    ("divisible_heads_shard", (4096, 32, 128),
     ("embed", "heads", "head_dim"), SINGLE, None, ("data", "model")),
    ("axis_never_reused", (1024, 2048), ("mlp", "vocab"), SINGLE, None,
     ("model",)),
    ("fsdp_over_pod_and_data", (16384, 53248), ("embed", "mlp"), MULTI,
     {"embed": ("data", "pod")}, (("data", "pod"), "model")),
    ("experts_ep", (64, 2048, 1408), ("experts", "embed", "expert_mlp"),
     SINGLE, None, ("model", "data")),
    ("experts_tp_fallback", (8, 6144, 16384),
     ("experts", "embed", "expert_mlp"), SINGLE, None,
     (None, "data", "model")),
    ("trailing_nones_trimmed", (32, 128), (None, None), SINGLE, None, ()),
    ("scalar", (), "_scalar_", SINGLE, None, ()),
    ("string_axes_leaf", (4096, 8192), "embed mlp", SINGLE, None,
     ("data", "model")),
    ("string_axes_underscore", (128, 64), "batch _", SINGLE, None,
     ("data",)),
]


@pytest.mark.parametrize("case", RULE_CASES, ids=[c[0] for c in RULE_CASES])
def test_resolve_spec_matches_reference_on_fake_mesh(case):
    _, shape, names, mesh, rules, want = case
    port = sharding.resolve_spec(shape, names, mesh, dict(
        sharding.DEFAULT_RULES, **(rules or {})))
    ref = jsh.resolve_spec(shape, names, mesh, dict(
        jsh.DEFAULT_RULES, **(rules or {})))
    assert tuple(port) == want == tuple(ref)
    assert isinstance(port, sharding.PartitionSpec) and port == want


def test_default_rules_and_names_equal_the_reference():
    assert sharding.DEFAULT_RULES == jsh.DEFAULT_RULES
    for names in (None, "_scalar_", "batch _ embed", ("a", None)):
        assert sharding._names_of(names) == jsh._names_of(names)


def test_partition_spec_is_an_immutable_sequence():
    spec = sharding.PartitionSpec("data", ("pod", "model"), None)
    assert spec == ("data", ("pod", "model"), None)
    assert spec == sharding.PartitionSpec("data", ("pod", "model"), None)
    assert spec != sharding.PartitionSpec("data")
    assert list(spec) == ["data", ("pod", "model"), None] and len(spec) == 3
    with pytest.raises(TypeError):
        spec[0] = "model"
    assert sharding.PartitionSpec() == ()


def test_named_sharding_shard_shape_and_device():
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert dict(mesh.shape) == {"data": 2, "model": 4}
    sh = sharding.NamedSharding(mesh, sharding.PartitionSpec("data",
                                                             "model"))
    assert sh.device == torch.device("cpu") and sh.mesh is mesh
    assert sh.shard_shape((64, 32, 5)) == (32, 8, 5)
    both = sharding.NamedSharding(mesh, (("data", "model"),))
    assert both.shard_shape((64,)) == (8,)
    assert sharding.NamedSharding(mesh, ()).shard_shape(()) == ()
    with pytest.raises(ValueError):
        sh.shard_shape((3, 32))
    # the port's Mesh reads as the reference's duck-typed mesh
    assert tuple(sharding.resolve_spec((64, 32), "embed mlp", mesh, {})) \
        == tuple(jsh.resolve_spec((64, 32), "embed mlp",
                                  FakeMesh({"data": 2, "model": 4}), {}))


def test_logical_constraint_is_the_identity_under_rules():
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    x = torch.zeros((4, 6, 8))
    assert sharding.logical_constraint(x, ("batch", "seq", "embed")) is x
    before = sharding.CONSTRAINT_CALLS
    with sharding.use_rules(mesh, {}):
        assert sharding.current_rules() == (mesh, {})
        assert sharding.logical_constraint(x, ("batch", "seq", "embed")) \
            is x
        with pytest.raises(ValueError, match="meta"):
            sharding.logical_constraint(x.to("meta"), ("batch",))
    assert sharding.current_rules() is None
    assert sharding.CONSTRAINT_CALLS == before + 2


def test_sharding_tree_reads_a_module_by_parameter_name():
    from repro_torch.models import lm
    cfg = get_config("internlm2-1.8b").reduced(num_layers=2)
    model = lm.init(cfg, device="meta")
    axes = lm.param_axes(model)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    tree = sharding.sharding_tree({"p": model}, {"p": axes}, mesh, {})
    assert set(tree["p"]) == set(axes)
    assert tree["p"]["embed"].spec == ("model", "data")
    with pytest.raises(ValueError):
        sharding.sharding_tree({"p": model}, {"p": {"embed": "_"}}, mesh,
                               {})


# --------------------------------------------------------------------------
# strategies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jstrat.STRATEGIES) + [None])
def test_strategy_for_matches_reference(name):
    assert strategies.STRATEGIES == jstrat.STRATEGIES
    assert strategies.OPTIMIZED == jstrat.OPTIMIZED
    cfg = get_config("internlm2-1.8b")
    jcfg = jget_config("internlm2-1.8b")
    rules, got_cfg, got = strategies.strategy_for(cfg, None, name)
    jrules, want_cfg, want = jstrat.strategy_for(jcfg, None, name)
    assert (rules, got) == (jrules, want)
    assert got_cfg.remat == want_cfg.remat
    assert (got_cfg is cfg) == (want_cfg is jcfg)


# --------------------------------------------------------------------------
# compression
# --------------------------------------------------------------------------

def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.int8, 4: np.int32}[a.dtype.itemsize])


@pytest.mark.parametrize("key", sorted(compression_inputs()))
def test_quantize_codes_and_scale_equal_the_reference(key):
    x = compression_inputs()[key]
    q, scale = compression._quantize(torch.from_numpy(np.array(x)))
    jq, jscale = jcomp._quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert _bits(np.float32(scale)) == _bits(np.float32(jscale))
    np.testing.assert_array_equal(
        _bits(compression._dequantize(q, scale).numpy()),
        _bits(jcomp._dequantize(jq, jscale)))


def test_compressed_psum_pod_equals_the_8_device_reference(child):
    """(4, 2) ("pod", "data") virtual mesh against the reference's shard_map
    over 8 host devices: every leaf bit for bit, and within the
    reference's int8 bound of 4x the leaf."""
    mesh = make_mesh((4, 2), ("pod", "data"), device="cpu")
    tree = {k: torch.from_numpy(np.array(v))
            for k, v in compression_inputs().items()}
    got = compression.compressed_psum_pod(tree, mesh, axis="pod")
    want = child["psum"]
    assert set(got) == set(want)
    for k, v in compression_inputs().items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape
        np.testing.assert_array_equal(_bits(got[k].numpy()),
                                      _bits(want[k]), err_msg=k)
        a, b = got[k].numpy(), 4.0 * v
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-9) < 2e-2, k


def test_error_feedback_matches_reference_over_50_steps():
    rng = np.random.default_rng(2)
    g = {"w": rng.standard_normal((128,), dtype=np.float32),
         "u": [rng.standard_normal((4, 3), dtype=np.float32)]}
    tg = {"w": torch.from_numpy(g["w"]), "u": [torch.from_numpy(g["u"][0])]}
    jg = jax.tree.map(jnp.asarray, g)
    res = jres = None
    acc_sent = np.zeros(128, np.float32)
    for _ in range(50):
        sent, res = compression.error_feedback_compress(tg, res)
        jsent, jres = jcomp.error_feedback_compress(jg, jres)
        for got, want in ((sent["w"], jsent["w"]), (res["w"], jres["w"]),
                          (res["u"][0], jres["u"][0])):
            np.testing.assert_array_equal(_bits(got.numpy()),
                                          _bits(np.asarray(want)))
        acc_sent += sent["w"].numpy()
    acc_true = 50 * g["w"]
    rel = np.abs(acc_sent - acc_true).max() / np.abs(acc_true).max()
    assert rel < 1e-2, rel


# --------------------------------------------------------------------------
# pipeline parallelism
# --------------------------------------------------------------------------

def test_gpipe_matches_the_4_pod_reference(child):
    ws, xs = gpipe_inputs()
    mesh = make_mesh((GPIPE["s"],), ("pod",), device="cpu")
    got = pipeline_parallel.gpipe(lambda w, x: torch.tanh(x @ w),
                                  torch.from_numpy(ws), torch.from_numpy(xs),
                                  mesh=mesh, axis="pod")
    np.testing.assert_allclose(got.numpy(), child["gpipe"], **GPIPE_TOL)
    want = torch.from_numpy(xs)
    for i in range(GPIPE["s"]):
        want = torch.tanh(want @ torch.from_numpy(ws[i]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **GPIPE_TOL)


def test_gpipe_on_a_2d_mesh_and_its_stage_count_check():
    """PP on "pod" composes with the mesh's other axes; a weights stack
    that is not one stage a position raises the reference's ValueError."""
    mesh = make_mesh((4, 2), ("pod", "data"), device="cpu")
    ws, xs = gpipe_inputs()
    got = pipeline_parallel.gpipe(lambda w, x: torch.tanh(x @ w),
                                  torch.from_numpy(ws), torch.from_numpy(xs),
                                  mesh=mesh, axis="pod")
    assert got.shape == xs.shape
    with pytest.raises(ValueError, match="3 stages on a 4-way 'pod' axis"):
        pipeline_parallel.gpipe(lambda w, x: x, torch.from_numpy(ws[:3]),
                                torch.from_numpy(xs), mesh=mesh, axis="pod")


@pytest.mark.parametrize("m, s", [(8, 4), (4, 4), (16, 2), (1, 1)])
def test_bubble_fraction_matches_reference(m, s):
    assert pipeline_parallel.bubble_fraction(m, s) == \
        jpipe.bubble_fraction(m, s)
    assert abs(pipeline_parallel.bubble_fraction(8, 4) - 3 / 11) < 1e-9
