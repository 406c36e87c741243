"""The port's logical axes against the reference's, for every
architecture at its published widths, with no allocation: the port's
abstract model, caches and train state are tensors on the meta device,
the reference's come from jax.eval_shape (repro.launch.specs).

The port's blocks are not stacked, so a parameter or cache leaf of a
stacked reference group carries the reference's axes without the
"layers" axis that the reference prepends (repro/models/lm.py:27-45);
convert.leaf_map names each port parameter's reference leaf and group.
Resolved against tests/test_sharding_rules.py's FakeMesh (SINGLE and
MULTI) under every strategy and every shape's rules, each port leaf's
spec equals the reference leaf's with that leading None dropped.
"""
import jax
import pytest
from test_sharding_rules import MULTI, SINGLE

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.dist import sharding as jsh
from repro.dist import strategies as jstrat
from repro.launch import specs as jspecs
from repro.models import common as jcommon
from repro.train import optim as joptim
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.dist import sharding, strategies
from repro_torch.launch import specs
from repro_torch.models import common, convert, lm
from repro_torch.train import optim, step

CACHE_BATCH, CACHE_LEN = 2, 64


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jget_config(arch)
            shapes, axes = jspecs.params_specs(jcfg)
            cshapes, caxes = jspecs.cache_specs(jcfg, CACHE_BATCH, CACHE_LEN)
            cache[arch] = (jcfg, shapes, axes, cshapes, caxes)
        return cache[arch]
    return get


def layer_map(cfg) -> dict:
    """Layer i of the port's caches -> (reference path, group index)."""
    p = len(cfg.block_pattern)
    stacked = cfg.num_layers // p * p
    return {i: (("groups", i % p), i // p) if i < stacked
            else (("tail", i - stacked), None)
            for i in range(cfg.num_layers)}


def stacked_axes(axes: str, g) -> str:
    return axes if g is None else "layers " + axes


def stacked_shape(shape, g, ref_shape) -> tuple:
    return tuple(shape) if g is None else (ref_shape[0],) + tuple(shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_shapes_and_dtypes_equal_the_reference(arch, reference):
    jcfg, shapes, axes, _, _ = reference(arch)
    cfg = get_config(arch)
    model = lm.init(cfg, device="meta")
    assert all(p.is_meta for p in model.parameters())
    port_axes = lm.param_axes(model)
    assert port_axes == lm.param_axes(cfg)
    leaves = convert.leaf_map(model)
    named = dict(model.named_parameters())
    assert set(leaves) == set(port_axes) == set(named)
    seen = set()
    for name, (path, g) in leaves.items():
        want = _at(shapes, path)
        assert _at(axes, path) == stacked_axes(port_axes[name], g), name
        assert tuple(want.shape) == stacked_shape(named[name].shape, g,
                                                  want.shape), name
        assert _dtype(named[name]) == str(want.dtype), name
        seen.add(path)
    ref_paths = {tuple(getattr(k, "key", getattr(k, "idx", None))
                       for k in kp)
                 for kp, _ in jax.tree_util.tree_leaves_with_path(axes)}
    assert seen == ref_paths


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_shapes_and_dtypes_equal_the_reference(arch, reference):
    jcfg, _, _, cshapes, caxes = reference(arch)
    cfg = get_config(arch)
    caches = lm.init_caches(cfg, CACHE_BATCH, CACHE_LEN, device="meta")
    port_axes = lm.cache_axes(cfg)
    assert len(caches) == len(port_axes) == cfg.num_layers
    for i, (path, g) in layer_map(cfg).items():
        assert set(caches[i]) == set(port_axes[i]) == set(_at(caxes, path))
        for k, t in caches[i].items():
            want = _at(cshapes, path + (k,))
            assert _at(caxes, path + (k,)) == stacked_axes(port_axes[i][k],
                                                           g), (i, k)
            assert tuple(want.shape) == stacked_shape(t.shape, g,
                                                      want.shape), (i, k)
            assert _dtype(t) == str(want.dtype), (i, k)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-1.3b",
                                  "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("use_master", [True, False])
def test_train_state_axes_equal_the_reference(arch, use_master):
    """The reference's optimizer init makes its moments with np.zeros even
    under jax.eval_shape (it reserves 8 bytes a parameter without touching
    them), so moonshot's state is compared reduced (its aux-free router
    bias kept)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    if cfg.num_experts:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    state, axes = step.init_state(0, cfg, optim.AdamWConfig(
        use_master=use_master), device="meta")
    jstate, jaxes = jspecs.state_specs(jcfg, joptim.AdamWConfig(
        use_master=use_master))
    assert set(axes["opt"]) == set(jaxes["opt"])
    assert axes["step"] == jaxes["step"] and \
        axes["opt"]["count"] == jaxes["opt"]["count"]
    leaves = convert.leaf_map(state["params"])
    for tree in ["params"] + [("opt", k) for k in ("m", "v", "master")
                              if k in axes["opt"]]:
        port = axes[tree] if tree == "params" else axes["opt"][tree[1]]
        ref = jaxes[tree] if tree == "params" else jaxes["opt"][tree[1]]
        for name, (path, g) in leaves.items():
            assert _at(ref, path) == stacked_axes(port[name], g), name
    for name, t in state["opt"]["m"].items():
        assert t.is_meta and t.dtype.is_floating_point
        path, g = leaves[name]
        want = _at(jstate["opt"]["m"], path)
        assert tuple(want.shape) == stacked_shape(t.shape, g, want.shape)
        assert _dtype(t) == str(want.dtype) == "float32"


def _rule_sets(cfg, jcfg):
    for shape_name in SHAPES:
        for strat in sorted(strategies.STRATEGIES):
            extra, _, _ = strategies.strategy_for(cfg, SHAPES[shape_name],
                                                  strat)
            jextra, _, _ = jstrat.strategy_for(jcfg, JSHAPES[shape_name],
                                               strat)
            rules = specs.rules_for(cfg, SHAPES[shape_name], extra)
            jrules = jspecs.rules_for(jcfg, JSHAPES[shape_name], jextra)
            assert rules == jrules
            yield f"{shape_name}/{strat}", rules, jrules


def _same_spec(port, ref, g) -> bool:
    """A stacked reference leaf's spec is the port's with a leading None
    (the "layers" axis resolves to None), trimmed as resolve_spec trims."""
    want = tuple(port) if g is None else (
        (None,) + tuple(port) if tuple(port) else ())
    return tuple(ref) == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_on_fake_meshes_equal_the_reference(arch, reference):
    """Every parameter and cache leaf, resolved on SINGLE (16, 16) and
    MULTI (2, 16, 16) under every strategy and every shape's rules."""
    jcfg, shapes, axes, cshapes, caxes = reference(arch)
    cfg = get_config(arch)
    model = lm.init(cfg, device="meta")
    port_axes = lm.param_axes(model)
    named = dict(model.named_parameters())
    leaves = convert.leaf_map(model)
    caches = lm.init_caches(cfg, CACHE_BATCH, CACHE_LEN, device="meta")
    cache_axes = lm.cache_axes(cfg)
    checked = 0
    for label, rules, jrules in _rule_sets(cfg, jcfg):
        for mesh in (SINGLE, MULTI):
            for name, (path, g) in leaves.items():
                port = sharding.resolve_spec(named[name].shape,
                                             port_axes[name], mesh, rules)
                ref = jsh.resolve_spec(_at(shapes, path).shape,
                                       _at(axes, path), mesh, jrules)
                assert _same_spec(port, ref, g), (label, name, port, ref)
                checked += 1
            for i, (path, g) in layer_map(cfg).items():
                for k, t in caches[i].items():
                    port = sharding.resolve_spec(t.shape, cache_axes[i][k],
                                                 mesh, rules)
                    ref = jsh.resolve_spec(_at(cshapes, path + (k,)).shape,
                                           _at(caxes, path + (k,)), mesh,
                                           jrules)
                    assert _same_spec(port, ref, g), (label, i, k, port,
                                                      ref)
                    checked += 1
    assert checked > 0


def test_moe_rules_shard_experts_only_where_they_divide():
    """"experts" -> model takes moonshot's 64 experts over a 16-way model
    axis; mixtral's 8 shed it and "expert_mlp" picks the ffn dim up."""
    for arch, want in (("moonshot-v1-16b-a3b", ("model", "data")),
                       ("mixtral-8x22b", (None, "data", "model"))):
        cfg = get_config(arch)
        model = lm.init(cfg, device="meta")
        ax = lm.param_axes(model)
        name = next(n for n in ax if n.endswith("moe.w_gate"))
        spec = sharding.resolve_spec(dict(model.named_parameters())[name]
                                     .shape, ax[name], SINGLE, {})
        assert tuple(spec) == want, (arch, spec)


@pytest.mark.parametrize("names", [("embed", "heads"), ("batch", None, "x"),
                                   (), "vocab embed", "_scalar_",
                                   (None, None)])
def test_axes_helpers_match_reference(names):
    assert common.axes_str(names) == jcommon.axes_str(names)
    s = jcommon.axes_str(names)
    assert common.axes_names(s) == jcommon.axes_names(s)
    tree = {"a": ("embed", None), "b": [("heads",), {"c": ()}]}
    assert common.map_axes_tree(tree) == {
        "a": "embed _", "b": ["heads", {"c": "_scalar_"}]}
    assert jcommon.map_axes_tree({"a": ("embed", None)}) == {"a": "embed _"}


def test_split_tree_over_dicts_and_modules():
    import torch
    w, b = torch.zeros(4, 3), torch.zeros(3)
    params, axes = common.split_tree(
        {"w": (w, ("embed", "mlp")), "sub": [(b, ("mlp",))]})
    assert params["w"] is w and params["sub"][0] is b
    assert axes == {"w": "embed mlp", "sub": ["mlp"]}
    jparams, jaxes = jcommon.split_tree(
        {"w": (jax.numpy.zeros((4, 3)), ("embed", "mlp")),
         "sub": [(jax.numpy.zeros(3), ("mlp",))]})
    assert jaxes == axes
    model = lm.init(get_config("mamba2-1.3b").reduced(num_layers=1),
                    device="meta")
    named, maxes = common.split_tree(model)
    assert set(named) == set(maxes) == set(lm.param_axes(model))
    assert maxes["blocks.0.mixer.in_proj"] == "embed ssm_proj"
