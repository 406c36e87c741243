"""Multi-pod dry run of the port: every (arch x shape x mesh) cell on meta
tensors (counterpart of repro/launch/dryrun.py).

For each cell this produces (artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json):
  - proof that the step runs at the production widths and depth on the
    production mesh's positions, with no allocation: the reference lowers
    and compiles for 512 host devices; the port builds the step
    (`launch.specs.build_step` on `make_production_mesh(device="meta")`)
    and runs it on meta tensors under the cost tracer
    (repro_torch.launch._trace). `lower_s` is the time build_step takes,
    `compile_s` the time of the meta run;
  - memory per position: arguments and outputs at their shardings
    (`dist.sharding.position_bytes`), the donated arguments (the train
    state, or the caches), the tracer's peak of live intermediates as
    `temp_size_in_bytes`, of the step under the cell's `remat` (the
    reference's default "block" rematerialises every block: the tracer
    sees the recompute's ops and the activations it frees); no
    generated code;
  - costs measured on two probes of p and 2p layers (p = the block
    pattern's length) and extrapolated to the full depth, as the
    reference does (`core.roofline.extrapolate`); the port's blocks are
    not stacked, so the probes differ from the cell only in num_layers,
    attn_impl, fused_ce and remat (`_probe_cfg`); `costs` holds the full
    run's own counts beside them;
  - the collective schedule: sharding propagation over the meta run
    (the tracer's CollectiveOps), summarized by `core.hlo.summarize`
    with the reference's kind names and ring formulas, and the ops the
    tracer has no rule for (`unruled_ops`);
  - core.traffic's analytic HBM and collective terms, the three roofline
    terms on the H100 row, and the MODEL_FLOPS ratio.

It launches no kernel: on meta tensors every kernel op takes its plain
version (kernels.dispatch.resolve), which computes nothing.

Usage:
  python -m repro_torch.launch.dryrun --arch mamba2-1.3b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import SHAPES, ARCH_IDS, cell_applicable, get_config
from repro_torch.core import hlo as hlolib
from repro_torch.core import roofline, traffic
from repro_torch.dist import sharding as shlib
from repro_torch.dist import strategies
from repro_torch.launch import specs
from repro_torch.launch._trace import CostTracer, tensors_of
from repro_torch.launch.mesh import make_production_mesh

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def _probe_cfg(cfg, layers: int):
    """The probe variant of `cfg` at `layers` layers (the reference's
    loop-free variant; the port's stack is never a loop)."""
    return dataclasses.replace(cfg, num_layers=layers, scan_layers=False,
                               attn_impl="naive", fused_ce=False,
                               remat="none")


@dataclasses.dataclass
class Traced:
    """One step run on meta tensors under a CostTracer."""
    fn: object
    abstract: tuple
    out: object
    tracer: CostTracer
    build_s: float
    run_s: float


def trace_step(cfg, shape, mesh, rules_extra=None) -> Traced:
    """Build `cfg`'s step for `shape` on `mesh` (a mesh on the meta
    device) and run it once on its abstract arguments under a
    CostTracer seeded with their shardings."""
    t0 = time.perf_counter()
    fn, abstract = specs.build_step(cfg, shape, mesh,
                                    rules_extra=rules_extra)
    build_s = time.perf_counter() - t0
    tracer = CostTracer(mesh)
    tracer.seed(list(abstract), list(fn.in_shardings))
    t0 = time.perf_counter()
    with tracer:
        out = fn(*abstract)
    return Traced(fn, abstract, out, tracer, build_s,
                  time.perf_counter() - t0)


def _costs(traced: Traced) -> dict:
    coll = hlolib.summarize(traced.tracer.ops)
    return {
        "flops": float(traced.tracer.flops),
        "bytes": float(traced.tracer.bytes),
        "ring_bytes": float(coll["total_ring_bytes"]),
        "collective_count": float(coll["total_count"]),
    }


def _memory(traced: Traced) -> dict:
    args, shardings = list(traced.abstract), list(traced.fn.in_shardings)
    tr = traced.tracer
    return {
        "argument_size_in_bytes": shlib.position_bytes(args, shardings),
        "output_size_in_bytes": sum(
            tr.position_bytes(t) for t in tensors_of(traced.out)),
        "temp_size_in_bytes": int(tr.peak),
        "alias_size_in_bytes": sum(
            shlib.position_bytes(args[i], shardings[i])
            for i in traced.fn.donate_argnums),
        "generated_code_size_in_bytes": 0,
    }


def mesh_shape(mesh) -> traffic.MeshShape:
    """core.traffic's view of a mesh: its positions as chips, the "model"
    axis as TP, the rest as FSDP and DP (MeshShape.production for the
    production meshes)."""
    tp = int(mesh.shape.get("model", 1))
    return traffic.MeshShape(chips=mesh.size, tp=tp, fsdp=mesh.size // tp,
                             dp=mesh.size // tp)


def estimate(rec: dict, cfg, shape, mesh, rules_extra, strat_name: str,
             *, probes: bool = True) -> dict:
    """Fill `rec` with the cell's run on `mesh`: times, memory, schedule,
    and with probes the extrapolated costs, analytic terms, rooflines
    and utilization."""
    full = trace_step(cfg, shape, mesh, rules_extra)
    rec["lower_s"] = round(full.build_s, 2)
    rec["compile_s"] = round(full.run_s, 2)
    rec["memory"] = _memory(full)
    rec["collective_schedule"] = hlolib.summarize(full.tracer.ops)["ops"]
    rec["costs"] = _costs(full)
    rec["unruled_ops"] = dict(sorted(full.tracer.unruled.items()))
    rec["status"] = "ok"
    del full

    if probes:
        p = len(cfg.block_pattern)
        cost_p = _costs(_compile_probe(cfg, shape, mesh, p, rules_extra))
        cost_2p = _costs(_compile_probe(cfg, shape, mesh, 2 * p,
                                        rules_extra))
        est = roofline.extrapolate(cost_p, cost_2p, cfg.num_layers, p)
        rec["probe_costs"] = {"p": cost_p, "2p": cost_2p, "est_full": est}

        mshape = mesh_shape(mesh)
        hbm = traffic.hbm_traffic(cfg, shape, mshape, strat_name)
        coll = traffic.collective_traffic(cfg, shape, mshape, strat_name)
        rec["analytic_hbm"] = hbm
        rec["analytic_collective"] = coll

        terms = roofline.terms(est["flops"], hbm["total"], coll["total"])
        rec["roofline"] = terms.to_dict()
        # the reference's key; here the tracer's counts, not a CPU's
        cpu_terms = roofline.terms(est["flops"], est["bytes"],
                                   est["ring_bytes"])
        rec["roofline_cpu_measured"] = cpu_terms.to_dict()
        mf = roofline.model_flops(cfg, shape)
        rec["utilization"] = roofline.utilization(terms, mf, mesh.size)
    return rec


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             *, probes: bool = True, cfg_override=None,
             strategy: str | None = None) -> dict:
    cfg = cfg_override or get_config(arch_id)
    shape = SHAPES[shape_name]
    rules_extra, cfg, strat_name = strategies.strategy_for(
        cfg, shape, strategy or "megatron")
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    chips = mesh.size
    rec: dict = {
        "arch": arch_id, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "chips": int(chips), "kind": shape.kind,
        "strategy": strat_name,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped-by-design"
        rec["why"] = why
        return rec
    return estimate(rec, cfg, shape, mesh, rules_extra, strat_name,
                    probes=probes)


def _compile_probe(cfg, shape, mesh, layers: int, rules_extra=None):
    return trace_step(_probe_cfg(cfg, layers), shape, mesh, rules_extra)


def cell_path(arch_id, shape_name, mesh_name, opt: bool = False) -> Path:
    d = ART / (f"{mesh_name}-opt" if opt else mesh_name)
    d.mkdir(parents=True, exist_ok=True)
    return d / f"{arch_id}__{shape_name}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="use the hillclimbed strategy per cell "
                         "(repro_torch.dist.strategies.OPTIMIZED); results "
                         "go to artifacts/dryrun_torch/<mesh>-opt/")
    ap.add_argument("--strategy", choices=tuple(strategies.STRATEGIES),
                    help="force one strategy for every requested cell")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or not args.arch else (args.arch,)
    shapes = tuple(SHAPES) if args.all or not args.shape else (args.shape,)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)

    failures = []
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                opt = args.opt or bool(args.strategy)
                strategy = args.strategy
                if args.opt and not strategy:
                    strategy = strategies.OPTIMIZED.get((arch, shape))
                    if strategy is None:
                        continue   # --opt touches only hillclimbed cells
                path = cell_path(arch, shape, mesh_name, opt=opt)
                if path.exists() and not args.force:
                    print(f"[skip] {mesh_name}/{arch}/{shape} (cached)")
                    continue
                print(f"[run ] {mesh_name}/{arch}/{shape} "
                      f"strategy={strategy or 'megatron'} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mesh_name == "multi",
                                   probes=not args.no_probes,
                                   strategy=strategy)
                except Exception as e:  # record, keep going
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()[-4000:]}
                    failures.append((mesh_name, arch, shape, repr(e)))
                path.write_text(json.dumps(rec, indent=1, default=str))
                print(f"[done] {mesh_name}/{arch}/{shape}: {rec['status']}"
                      + (f" compile={rec.get('compile_s')}s" if
                         rec.get("compile_s") else ""), flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f)
        raise SystemExit(1)
    print("\nall requested cells ok")


if __name__ == "__main__":
    main()
