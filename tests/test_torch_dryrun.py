"""The port's dry run (repro_torch.launch.dryrun and its cost tracer,
launch/_trace.py) on the CPU: meta tensors only, nothing allocated.

- The tracer on hand-built programs on a (2, 4) meta mesh: exact flops and
  the collectives its rules give (one all-reduce for a column- then
  row-parallel MLP, one all-gather for an FSDP weight, one all-to-all for
  a constraint that moves an axis, a collective-permute for the gpipe
  roll), ring bytes by core.hlo's formulas, live bytes.
- Against the reference's XLA: the MLP's per-device flops equal
  cost_analysis()'s (only dots in it, and the all-reduce's additions,
  which XLA counts as flops); reduced internlm2-1.8b and
  mamba2-1.3b at train_4k on the single production mesh give the
  reference's record where the port's numbers come from the same code
  (configs, specs' shardings, core.traffic) and bands where they come
  from different machinery (the tracer against XLA). The reference runs
  in a child with 512 host devices (`python tests/test_torch_dryrun.py
  child OUT`, ~20 s), started in the background by a module fixture.
- Every arch reduced over the four shapes and both meshes, one cell at
  full width, the CLI, and the kernel dispatch on meta tensors.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import hlo
from repro_torch.dist import sharding as shlib
from repro_torch.dist.pipeline_parallel import gpipe
from repro_torch.launch import dryrun, specs
from repro_torch.launch._trace import CostTracer
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import blocks

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 300
M, K, F, N = 64, 32, 128, 48          # the MLP: (M, K) @ (K, F) @ (F, N)
PARITY_ARCHS = ("internlm2-1.8b", "mamba2-1.3b")
# The port's flops a position against XLA's (extrapolated probes, reduced
# configs at train_4k): the tracer counts torch.utils.flop_counter's
# formulas, which cover the matmuls only, where XLA's cost_analysis also
# counts one flop an element of every elementwise op, reduction and
# transcendental. Observed: internlm2 0.891, mamba2 0.668 (the SSD scan's
# exp / cumsum / masks are the largest elementwise share). A dropped
# split (a replicated matmul) would be >= 2x, a missed layer <= 0.5x.
FLOPS_BAND = (0.5, 1.25)


def _child(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import get_config as jget
    from repro.launch import dryrun as jdryrun
    rec = {"cells": {}}
    for arch in PARITY_ARCHS:
        rec["cells"][arch] = jdryrun.run_cell(
            arch, "train_4k", False, cfg_override=jget(arch).reduced())
    rec["skip"] = jdryrun.run_cell("internlm2-1.8b", "long_500k", False)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("data", "model"))

    def mlp(x, w1, w2):
        return (x @ w1) @ w2

    sds = lambda shape, spec: jax.ShapeDtypeStruct(      # noqa: E731
        shape, jnp.float32, sharding=NamedSharding(mesh, spec))
    compiled = jax.jit(mlp, out_shardings=NamedSharding(
        mesh, P("data"))).lower(sds((M, K), P("data")),
                                sds((K, F), P(None, "model")),
                                sds((F, N), P("model"))).compile()
    rec["mlp_flops"] = float(compiled.cost_analysis()["flops"])
    rec["mlp_hlo"] = compiled.as_text()
    Path(out).write_text(json.dumps(rec, default=str))


@pytest.fixture(scope="module")
def reference_child(tmp_path_factory):
    """Start the reference's child now; `.result()` waits for it."""
    out = tmp_path_factory.mktemp("dryrun") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, __file__, "child", str(out)],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    class Pending:
        value = None

        def result(self):
            if self.value is None:
                log, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
                assert proc.returncode == 0, log[-4000:]
                self.value = json.loads(out.read_text())
            return self.value

    yield Pending()
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _start_child_early(reference_child):
    """The child runs while the tests before the parity tests do."""


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def mesh24():
    return make_mesh((2, 4), ("data", "model"), device="meta")


def _sh(mesh, *entries):
    return shlib.NamedSharding(mesh, shlib.PartitionSpec(*entries))


def _mlp_trace(mesh, w1_spec=(None, "model")):
    x, w1, w2 = _meta(M, K), _meta(K, F), _meta(F, N)
    tr = CostTracer(mesh)
    tr.seed([x, w1, w2], [_sh(mesh, "data"), _sh(mesh, *w1_spec),
                          _sh(mesh, "model")])
    with tr:
        y = (x @ w1) @ w2
    return tr, y


# --------------------------------------------------------------------------
# the tracer on hand-built programs
# --------------------------------------------------------------------------

def test_megatron_mlp_flops_and_one_all_reduce(mesh24):
    tr, y = _mlp_trace(mesh24)
    # column-parallel: work split over data (rows) and model (F); row-
    # parallel: rows over data, F contracted over model
    assert tr.flops == 2 * M * K * F / 8 + 2 * M * F * N / 8
    assert len(tr.ops) == 1
    (op,) = tr.ops
    assert (op.kind, op.group_size) == ("all-reduce", 4)
    assert "'model'" in op.line
    assert op.result_bytes == (M // 2) * N * 4 == tr.position_bytes(y)
    assert tr.spec(y) == (("data",), ())
    assert tr.unruled == {}


def test_fsdp_weight_contracted_gives_one_all_gather(mesh24):
    x, w = _meta(M, K), _meta(K, F)
    tr = CostTracer(mesh24)
    tr.seed([x, w], [_sh(mesh24, "data"), _sh(mesh24, "data", "model")])
    with tr:
        x @ w
    assert [(o.kind, o.group_size) for o in tr.ops] == [("all-gather", 2)]
    # the gathered weight: its (K / 2, F / 4) shard times the 2 positions
    assert tr.ops[0].result_bytes == K * (F // 4) * 4
    assert tr.flops == 2 * M * K * F / 8


def test_constraint_moving_an_axis_gives_one_all_to_all(mesh24):
    x = _meta(M, K)
    tr = CostTracer(mesh24)
    tr.seed([x], [_sh(mesh24, "data")])
    rules = {"rows": "data", "cols": "data"}
    with tr, shlib.use_rules(mesh24, rules):
        y = x * 2.0
        shlib.logical_constraint(y, (None, "cols"))
    assert [(o.kind, o.group_size) for o in tr.ops] == [("all-to-all", 2)]
    assert tr.ops[0].result_bytes == (M // 2) * K * 4
    assert tr.spec(y) == ((), ("data",))


def test_constraint_drop_add_and_swap(mesh24):
    """A dropped axis is an all-gather, an added one a local slice (no
    collective), an axis swapped for one of the same size on the same
    dim a collective-permute; a fully replicated constraint does nothing,
    as the reference's."""
    mesh = make_mesh((4, 4), ("data", "model"), device="meta")
    x = _meta(M, K)
    tr = CostTracer(mesh)
    tr.seed([x], [_sh(mesh, "data")])
    with tr:
        shlib.mesh_constraint(x, shlib.PartitionSpec("model"))   # swap
        shlib.mesh_constraint(x, shlib.PartitionSpec("model", "data"))
        shlib.mesh_constraint(x, shlib.PartitionSpec(None, "data"))
    assert [o.kind for o in tr.ops] == ["collective-permute", "all-gather"]
    assert tr.ops[0].result_bytes == (M // 4) * K * 4
    assert tr.ops[1].result_bytes == M * (K // 4) * 4
    tr = CostTracer(mesh24)
    tr.seed([x], [_sh(mesh24, "data")])
    with tr, shlib.use_rules(mesh24, {}):
        shlib.logical_constraint(x, (None, None))
    assert tr.ops == [] and tr.spec(x) == (("data",), ())


def test_parts_of_a_split_dim(mesh24):
    """A part of a split dim that divides evenly is spread over the same
    axes again (a collective-permute of its shards); one that does not is
    all-gathered; a select on a split dim gathers the selected part."""
    x = _meta(M, K)
    tr = CostTracer(mesh24)
    tr.seed([x], [_sh(mesh24, None, "model")])
    with tr:
        even = x[:, :16]              # 16 of 32 columns: 4 a position
        odd = x[:, :6]
        row, col = x[0], x[:, 0]
    assert tr.spec(even) == ((), ("model",))
    assert tr.spec(odd) == ((), ()) and tr.spec(col) == ((),)
    assert tr.spec(row) == (("model",),)     # dim 0 is whole: no collective
    assert [(o.kind, o.result_bytes) for o in tr.ops] == [
        ("collective-permute", M * 4 * 4), ("all-gather", M * 6 * 4),
        ("all-gather", M * 4)]


def test_gpipe_roll_is_a_collective_permute():
    mesh = make_mesh((4,), ("pod",), device="meta")
    s, m, d = 4, 8, 16
    ws, xs = _meta(s, d, d), _meta(m, 2, d)
    tr = CostTracer(mesh)
    tr.seed([ws], [_sh(mesh, "pod")])
    with tr:
        out = gpipe(lambda w, x: torch.tanh(x @ w), ws, xs, mesh=mesh,
                    axis="pod")
    assert tuple(out.shape) == (m, 2, d)
    permutes = [o for o in tr.ops if o.kind == "collective-permute"]
    assert len(permutes) == m + s - 1           # one roll a tick
    assert all(o.result_bytes == 2 * d * 4 and o.group_size == 4
               for o in permutes)


def test_ring_bytes_follow_the_hlo_formulas(mesh24):
    tr, _ = _mlp_trace(mesh24, w1_spec=("data", "model"))
    kinds = {o.kind for o in tr.ops}
    assert kinds == {"all-gather", "all-reduce"}
    for o in tr.ops:
        n, g = o.result_bytes, o.group_size
        want = {"all-reduce": 2.0 * n * (g - 1) / g,
                "all-gather": n * (g - 1) / g}[o.kind]
        assert o.ring_bytes == want
    summary = hlo.summarize(tr.ops)
    assert summary["total_ring_bytes"] == sum(o.ring_bytes for o in tr.ops)
    assert summary["total_count"] == len(tr.ops)


def test_live_bytes_count_saved_tensors_until_the_backward(mesh24):
    """Intermediates count at their per-position size from the op that
    makes them until autograd lets go of them; arguments count nothing."""
    w = _meta(K, F).requires_grad_()
    x = _meta(M, K)
    tr = CostTracer(mesh24)
    tr.seed([x, w], [_sh(mesh24, "data"), _sh(mesh24, None, "model")])
    with tr:
        h = x @ w                       # (M/2, F/4), saved by sin
        y = torch.sin(h)                # (M/2, F/4)
        del h
        loss = y.sum()
        assert tr.live >= 2 * (M // 2) * (F // 4) * 4
        loss.backward()
        del y, loss
    shard = (M // 2) * (F // 4) * 4
    assert tr.peak >= 2 * shard
    # the graph is gone; w.grad stays: (K, F / 4) a position, summed over
    # the rows' data split by an all-reduce (after the loss's sum over all
    # eight positions)
    assert tr.live == K * (F // 4) * 4 == tr.position_bytes(w.grad)
    assert [(o.kind, o.group_size) for o in tr.ops] == [("all-reduce", 8),
                                                        ("all-reduce", 2)]


# --------------------------------------------------------------------------
# the kernel dispatch on meta tensors
# --------------------------------------------------------------------------

def test_meta_takes_the_plain_version_and_cuda_mode_raises():
    from repro_torch.kernels import dispatch
    t = _meta(4)
    assert dispatch.resolve("auto", t) is False
    assert dispatch.resolve(None, t) is False
    assert dispatch.resolve("torch_ref", t) is False
    with pytest.raises(ValueError, match="lies on the meta device"):
        dispatch.resolve("cuda", t)


def test_a_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    from types import SimpleNamespace

    from repro_torch.kernels import _build, dispatch
    seen = []
    monkeypatch.setattr(_build, "require_hopper", seen.append)
    fake = SimpleNamespace(device=torch.device("cuda", 0))
    assert dispatch.resolve("auto", fake) is True
    assert dispatch.resolve("cuda", fake) is True
    assert seen == [fake.device] * 2
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch.resolve("auto", SimpleNamespace(device=torch.device("xpu")))


def test_every_kernel_op_runs_on_meta_through_its_plain_version():
    """Each registered family's example on meta tensors: outputs on meta
    with the CPU run's shapes and dtypes; no launch, no host sync (a
    .item() on meta raises)."""
    from repro_torch.kernels import dispatch

    def flat(o):
        if isinstance(o, torch.Tensor):
            return [o]
        if isinstance(o, dict):
            o = list(o.values())
        return [t for x in o for t in flat(x)] if isinstance(
            o, (list, tuple)) else []

    ops = dispatch.registered()
    assert set(ops) >= {"scan_filter", "aggregate", "scan_aggregate",
                        "scan_compressed", "group_aggregate",
                        "flash_attention", "decode_attention", "ssd_chunk"}
    for name, op in ops.items():
        args, kw = op.example(np.random.default_rng(0))
        want = flat(op.fn(*args, **kw))
        got = flat(op.fn(*[a.to("meta") if isinstance(a, torch.Tensor)
                           else a for a in args], **kw))
        assert [(t.shape, t.dtype, t.device.type) for t in got] == \
            [(t.shape, t.dtype, "meta") for t in want], name


def test_kernel_ops_under_autograd_on_meta():
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ssd_chunk import ops as ssd
    b, s, h, p, n = 2, 64, 2, 16, 8
    x = _meta(b, s, h, p).requires_grad_()
    dt, bb, cc = _meta(b, s, h), _meta(b, s, n), _meta(b, s, n)
    a_log = _meta(h).requires_grad_()
    y, state = ssd.ssd(x, dt, a_log, bb, cc, 16)
    assert (tuple(y.shape), y.dtype) == ((b, s, h, p), torch.float32)
    assert tuple(state.shape) == (b, h, n, p)
    gx, ga = torch.autograd.grad(y.sum(), [x, a_log])
    assert gx.shape == x.shape and ga.shape == a_log.shape
    q = _meta(1, 2, 2, 128, 64, dtype=torch.bfloat16).requires_grad_()
    k = _meta(1, 2, 128, 64, dtype=torch.bfloat16)
    o = flash.flash5(q, k, k)
    assert (o.shape, o.dtype, o.device.type) == (q.shape, q.dtype, "meta")
    assert torch.autograd.grad(o.float().sum(), q)[0].shape == q.shape


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_flash_train_and_prefill_steps_run_on_meta(arch):
    from repro_torch.kernels.ssd_chunk import kernel as sk
    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl="flash")
    mesh = make_production_mesh(device="meta")
    before = sk.LAUNCHES
    for shape_name in ("train_4k", "prefill_32k"):
        shape = SHAPES[shape_name]
        fn, abstract = specs.build_step(cfg, shape, mesh)
        out = fn(*abstract)
        if shape.kind == "train":
            state, metrics = out
            loss = metrics["loss"]
            assert (loss.shape, loss.dtype, loss.device.type) == \
                ((), torch.float32, "meta")
            assert all(p.device.type == "meta"
                       for p in state["params"].parameters())
        else:
            logits, caches = out
            assert tuple(logits.shape) == (shape.global_batch,
                                           cfg.vocab_size)
            assert logits.device.type == "meta"
            assert len(caches) == cfg.num_layers
    assert sk.LAUNCHES == before


# --------------------------------------------------------------------------
# the grid, the full-width cell and the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_grid_runs_every_cell(arch, mesh_name):
    """Every shape of `arch` (reduced) on one production mesh, no probes:
    each cell ok or skipped by design; its argument bytes are
    position_bytes of its arguments under their shardings."""
    from repro_torch.configs import cell_applicable
    from repro_torch.dist import strategies
    multi = mesh_name == "multi"
    mesh = make_production_mesh(multi_pod=multi, device="meta")
    cfg0 = get_config(arch).reduced()
    for shape_name, shape in SHAPES.items():
        rec = dryrun.run_cell(arch, shape_name, multi, probes=False,
                              cfg_override=cfg0)
        ok, _ = cell_applicable(cfg0, shape)
        assert rec["status"] == ("ok" if ok else "skipped-by-design")
        assert rec["chips"] == mesh.size
        if not ok:
            continue
        extra, cfg, _ = strategies.strategy_for(cfg0, shape)
        fn, args = specs.build_step(cfg, shape, mesh, rules_extra=extra)
        want = sum(shlib.position_bytes(a, sh)
                   for a, sh in zip(args, fn.in_shardings))
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] == want
        assert 0 < mem["alias_size_in_bytes"] < want
        assert mem["temp_size_in_bytes"] > 0
        assert set(rec["collective_schedule"]) <= {
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"}


def test_full_width_mamba2_cell_holds_the_smoke_bytes():
    """mamba2-1.3b at its published widths, train_4k, single mesh: the
    donated train state is chip_smoke.py's PROD_BYTES, and the batch's
    (256, 4096) int32 inputs and labels, split 16 ways, come on top."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    prod = next(ast.literal_eval(n.value) for n in tree.body
                if isinstance(n, ast.Assign) and
                getattr(n.targets[0], "id", None) == "PROD_BYTES")
    rec = dryrun.run_cell("mamba2-1.3b", "train_4k", False, probes=False)
    state = prod["mamba2-1.3b"]["single"]
    mem = rec["memory"]
    assert mem["alias_size_in_bytes"] == state == 1189683208
    assert mem["argument_size_in_bytes"] == state + 2 * 256 * 4096 * 4 // 16
    assert rec["status"] == "ok" and rec["costs"]["flops"] > 0


def test_a_cell_with_probes_allocates_only_meta_tensors():
    """Every tensor an op makes during a cell (the full run and both
    probes) lies on the meta device."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch._trace import tensors_of
    devices = set()

    class Devices(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            devices.update(t.device.type for t in tensors_of(out))
            return out

    with Devices():
        rec = dryrun.run_cell("internlm2-1.8b", "train_4k", False,
                              cfg_override=get_config(
                                  "internlm2-1.8b").reduced())
    assert rec["status"] == "ok" and "probe_costs" in rec
    assert devices == {"meta"}


def test_cli_writes_cells_and_exits_1_on_a_failure(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(dryrun, "ART", tmp_path)
    real = dryrun.run_cell

    def small(arch, shape, multi, **kw):
        if shape == "decode_32k":
            raise RuntimeError("a failing cell")
        return real(arch, shape, multi, cfg_override=get_config(
            arch).reduced(), **kw)

    monkeypatch.setattr(dryrun, "run_cell", small)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "internlm2-1.8b", "--no-probes"])
    assert e.value.code == 1
    cells = {p.name: json.loads(p.read_text())
             for p in (tmp_path / "single").glob("*.json")}
    assert len(cells) == len(SHAPES)          # no --shape: every shape
    assert cells["internlm2-1.8b__train_4k.json"]["status"] == "ok"
    assert cells["internlm2-1.8b__long_500k.json"]["status"] == \
        "skipped-by-design"
    bad = cells["internlm2-1.8b__decode_32k.json"]
    assert bad["status"] == "error" and "a failing cell" in bad["error"]
    assert "FAILURES" in capsys.readouterr().out
    # cells on disk are kept unless --force
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "train_4k",
                 "--no-probes"])
    assert "[skip] single/internlm2-1.8b/train_4k (cached)" in \
        capsys.readouterr().out
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "train_4k",
                 "--mesh", "multi", "--force"])
    rec = json.loads((tmp_path / "multi" / "mamba2-1.3b__train_4k.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert set(rec) >= {"probe_costs", "analytic_hbm", "roofline",
                        "roofline_cpu_measured", "utilization"}
    assert "all requested cells ok" in capsys.readouterr().out


# --------------------------------------------------------------------------
# parity with the reference's dry run
# --------------------------------------------------------------------------

EQUAL_KEYS = ("arch", "shape", "mesh", "chips", "kind", "strategy",
              "params", "active_params", "status", "analytic_hbm",
              "analytic_collective")


def recompute_flops(arch, strategy=None):
    """The reduced train_4k cell of `arch` under remat "none", and what
    one recompute of every block adds to its flops, both counted by the
    dry run's tracer in that run: (record, full, early). `full` sums
    every block's forward; `early` sums every block's forward up to the
    last tensor it saves for the backward, where torch's non-reentrant
    checkpoint stops its recompute (its default early stop: the packing
    of a saved input comes before its op runs)."""
    tracers, full, early = [], [], []

    class Tracer(dryrun.CostTracer):
        def __enter__(self):
            tracers.append(self)
            return super().__enter__()

    real = blocks.block_apply

    def block_apply(*args, **kwargs):
        tracer = tracers[-1]
        start = last = tracer.flops

        def pack(t):
            nonlocal last
            last = tracer.flops
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = real(*args, **kwargs)
        full.append(tracer.flops - start)
        early.append(last - start)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun, "CostTracer", Tracer)
        mp.setattr(blocks, "block_apply", block_apply)
        rec = dryrun.run_cell(arch, "train_4k", False, probes=False,
                              cfg_override=get_config(arch).reduced(
                                  remat="none"), strategy=strategy)
    assert rec["status"] == "ok", rec
    assert len(full) == get_config(arch).reduced().num_layers
    return rec, sum(full), sum(early)


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_cell_matches_the_reference_dry_run(arch, reference_child):
    got = dryrun.run_cell(arch, "train_4k", False,
                          cfg_override=get_config(arch).reduced())
    ref = reference_child.result()["cells"][arch]
    for key in EQUAL_KEYS:
        assert got[key] == ref[key], key
    for key in ("bytes_per_device", "ring_bytes_per_device"):
        assert got["roofline"][key] == ref["roofline"][key], key
    # the arguments and the donated state, byte for byte: both packages
    # split the same leaves by the same rules
    for key in ("argument_size_in_bytes", "alias_size_in_bytes"):
        assert got["memory"][key] == ref["memory"][key], key
    assert got["memory"]["generated_code_size_in_bytes"] == 0
    # XLA's collective-permutes here move reduced weight gradients between
    # device orders after its partitioner splits a dot over the idle
    # "model" axis; sharding propagation on logical specs all-reduces and
    # slices locally instead, so it has none in these cells (its permutes
    # come from axis swaps and rolls: the constraint and gpipe tests)
    assert set(ref["collective_schedule"]) - {"collective-permute"} <= \
        set(got["collective_schedule"])
    assert set(got["probe_costs"]) == set(ref["probe_costs"])
    est, xla = got["probe_costs"]["est_full"], ref["probe_costs"]["est_full"]
    model_pp = got["utilization"]["model_flops_per_device"]
    assert model_pp == ref["utilization"]["model_flops_per_device"]
    assert est["flops"] >= model_pp
    assert FLOPS_BAND[0] <= est["flops"] / xla["flops"] <= FLOPS_BAND[1]
    # the full run's own count equals the probes' extrapolation where it
    # keeps every activation, as the probes do: L = 2p, and the probes
    # differ from that cell only in attention and CE paths that count the
    # same matmuls at these widths. The cell itself runs the config's
    # remat ("block"), whose recompute adds one forward of every block
    # up to the last tensor the block saves (recompute_flops).
    keep, _, early = recompute_flops(arch)
    assert math.isclose(keep["costs"]["flops"], est["flops"], rel_tol=1e-12)
    assert math.isclose(got["costs"]["flops"],
                        keep["costs"]["flops"] + early, rel_tol=1e-9)
    assert got["unruled_ops"] == {}


def test_mlp_flops_equal_xla_cost_analysis(mesh24, reference_child):
    ref = reference_child.result()
    tr, _ = _mlp_trace(mesh24)
    # XLA also counts the all-reduce's additions, one flop an element of
    # its result; the tracer leaves them to the collective
    adds = sum(o.result_bytes // 4 for o in tr.ops if o.kind == "all-reduce")
    assert tr.flops + adds == ref["mlp_flops"]
    # and XLA partitions it with one all-reduce over 4 positions too
    ops = hlo.parse_collectives(ref["mlp_hlo"])
    assert [(o.kind, o.group_size, o.result_bytes) for o in ops] == \
        [(o.kind, o.group_size, o.result_bytes) for o in tr.ops]


def test_long_context_of_a_quadratic_arch_is_the_reference_skip(
        reference_child):
    got = dryrun.run_cell("internlm2-1.8b", "long_500k", False)
    assert got == reference_child.result()["skip"]


if __name__ == "__main__" and sys.argv[1:2] == ["child"]:
    _child(sys.argv[2])
