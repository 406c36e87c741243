"""Parity of the port's paper model with the reference on the CPU.

`repro_torch.core` (systems, model, provisioning, traffic, roofline,
advisor, sweep), `repro_torch.energy.tco` and `repro_torch.launch.advisor`
are copies of the reference's modules with the H100 datasheet row where
the reference has its TPU row. Each case feeds the same inputs to both
packages and compares every field with `==`. Only the soft (sigmoid)
sweep and its gradients have a tolerance: SOFT_RTOL and GRAD_RTOL, the
relative float32 spread of a sigmoid and of its derivative computed in
another order.

The reference's TPU row is carried into the port's types (`carried`), so
both packages compute from the same inputs; the H100 row, which only the
port has, is fed to the reference's functions as a plain SystemSpec.
Cost sheets and bandwidth-rich prefixes are keyed by system name, so
cases with a carried row pass the reference's tables explicitly.
"""
import dataclasses
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.advisor as radv
import repro.core.model as rmodel
import repro.core.provisioning as rprov
import repro.core.roofline as rroof
import repro.core.sweep as rsweep
import repro.core.systems as rsys
import repro.core.traffic as rtraffic
import repro.energy.tco as rtco
import repro.launch.advisor as rcli
import repro_torch.core as tc
import repro_torch.core.advisor as tadv
import repro_torch.core.model as tmodel
import repro_torch.core.provisioning as tprov
import repro_torch.core.roofline as troof
import repro_torch.core.sweep as tsweep
import repro_torch.core.systems as tsys
import repro_torch.core.traffic as ttraffic
import repro_torch.energy.tco as ttco
import repro_torch.launch.advisor as tcli
from repro.configs import ARCH_IDS, SHAPES as R_SHAPES
from repro.configs import cell_applicable
from repro.configs import get_config as r_config
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import get_config as t_config

SOFT_RTOL = 1e-5
GRAD_RTOL = 1e-4

TiB = 2.0 ** 40
DB, BPQ = 16 * TiB, 0.20 * 16 * TiB      # tests/test_energy.py's workload
DB_SIZES = (1 * TiB, 4 * TiB, 16 * TiB, 64 * TiB)
ACCESS = (0.01, 0.2, 0.5, 1.0)
SLAS = (1e-3, 5e-3, 1e-2, 6e-2, 0.1, 1.0, 10.0)
BUDGETS = (50e3, 250e3, 1e6, 3e6, 10e6)


def carried(spec=rsys.TPU_V5E) -> tsys.AcceleratorSpec:
    """The reference's TPU row in the port's type: its fields with the
    two link fields renamed."""
    d = dataclasses.asdict(spec)
    d["link_bandwidth"] = d.pop("ici_link_bandwidth")
    d["links"] = d.pop("ici_links")
    return tsys.AcceleratorSpec(**d)


def ref_spec(spec: tsys.AcceleratorSpec) -> rsys.TPUSpec:
    """A port accelerator row in the reference's type."""
    d = dataclasses.asdict(spec)
    d["ici_link_bandwidth"] = d.pop("link_bandwidth")
    d["ici_links"] = d.pop("links")
    return rsys.TPUSpec(**d)


def to_ref(s: tsys.SystemSpec) -> rsys.SystemSpec:
    return rsys.SystemSpec(**dataclasses.asdict(s))


H100_PAPER = tsys.as_paper_system(tsys.H100_SXM)
# the port's system and the reference's, the same inputs
SYSTEMS = {
    "traditional": (tsys.TRADITIONAL, rsys.TRADITIONAL),
    "big-memory": (tsys.BIG_MEMORY, rsys.BIG_MEMORY),
    "die-stacked": (tsys.DIE_STACKED, rsys.DIE_STACKED),
    "ddr5-host": (tadv.DDR5_HOST, radv.DDR5_HOST),
    "tpu-carried": (tsys.as_paper_system(carried()),
                    rsys.as_paper_system(rsys.TPU_V5E)),
    "h100": (H100_PAPER, to_ref(H100_PAPER)),
}
# one price table for both packages that names the carried TPU row and
# the H100 row
BOTH_ROWS = rtco.DEFAULT_COSTS.mem_usd_per_gib + (("h100", 40.0),)
T_SHEET = ttco.CostSheet(mem_usd_per_gib=BOTH_ROWS)
R_SHEET = rtco.CostSheet(mem_usd_per_gib=BOTH_ROWS)
BOTH_PREFIXES = rtco.BANDWIDTH_RICH_PREFIXES + ("h100",)


def workloads():
    for db in DB_SIZES:
        for pct in ACCESS:
            yield tmodel.Workload(db, pct), rmodel.Workload(db, pct)


def same_design(a, b):
    assert a.summary() == b.summary()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.holds_workload == b.holds_workload


def raised(fn):
    """(type name, message) of what `fn()` raises."""
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


# --------------------------------------------------------------------------
# systems: Table 1, DDR5, the carried TPU row and the H100 row
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key", sorted(SYSTEMS))
def test_system_rows_equal_reference(key):
    t, r = SYSTEMS[key]
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    for prop in ("modules_per_chip", "chip_capacity", "chip_bandwidth",
                 "chip_peak_perf", "saturating_cores",
                 "bandwidth_capacity_ratio"):
        assert getattr(t, prop) == getattr(r, prop), prop
    for f in (0.5, 8):
        assert dataclasses.asdict(t.with_density(f)) == \
            dataclasses.asdict(r.with_density(f))
        assert dataclasses.asdict(t.with_compute_power(f)) == \
            dataclasses.asdict(r.with_compute_power(f))


def test_accelerator_spec_carries_the_reference_row():
    c = carried()
    assert dataclasses.asdict(ref_spec(c)) == \
        dataclasses.asdict(rsys.TPU_V5E)
    assert c.bandwidth_capacity_ratio == rsys.TPU_V5E.bandwidth_capacity_ratio
    assert c.ridge_intensity == rsys.TPU_V5E.ridge_intensity
    h = tsys.H100_SXM
    assert h.bandwidth_capacity_ratio == ref_spec(h).bandwidth_capacity_ratio
    assert h.ridge_intensity == ref_spec(h).ridge_intensity
    assert dataclasses.asdict(tsys.as_paper_system(h)) == \
        dataclasses.asdict(rsys.as_paper_system(ref_spec(h)))


def test_h100_row_is_the_datasheet():
    h = tsys.H100_SXM
    assert (h.name, h.peak_flops_bf16, h.hbm_bandwidth, h.hbm_capacity) == \
        ("h100-sxm", 989e12, 3.35e12, 80 * 2.0 ** 30)
    assert (h.links, h.link_bandwidth, h.chip_power, h.chips_per_host) == \
        (18, 25e9, 700.0, 8)
    assert h.host_overhead_power == 10200.0 - 8 * 700.0
    p = tsys.as_paper_system()
    assert p.name == "h100-sxm-as-paper"
    assert (p.max_chip_cores, p.module_power, p.blade_chips) == (32, 175.0, 8)
    # Eq. 4 of the mapped chip is its HBM rate: 32 cores x 3.35 TB/s / 32
    assert p.core_perf == 3.35e12 / 32
    assert p.chip_peak_perf == p.chip_bandwidth == 3.35e12
    assert tadv.advise_scan_sla(1e9, 1e8, 0.01).design.system == p


def test_no_reference_tpu_constant_in_the_port():
    port = Path(tsys.__file__).resolve().parents[1]
    text = "\n".join(p.read_text() for p in port.rglob("*.py"))
    for const in ("TPU_V5E", "TPUSpec", "tpu-v5e", "197e12", "819 * GB",
                  "ici_link"):
        assert const not in text, const


# --------------------------------------------------------------------------
# the paper's claims, run against repro_torch.core
# --------------------------------------------------------------------------

CLAIMS_FILE = Path(__file__).with_name("test_paper_claims.py")


def _claims_on_the_port():
    """tests/test_paper_claims.py with its `repro.core` imports pointed at
    `repro_torch.core`: every assertion of it, on the port."""
    src = CLAIMS_FILE.read_text()
    ported = src.replace("from repro.core", "from repro_torch.core")
    assert ported.count("repro_torch.core") == src.count("repro.core") == 2
    mod = types.ModuleType("paper_claims_on_the_port")
    exec(compile(ported, str(CLAIMS_FILE), "exec"), mod.__dict__)
    return mod


PORT_CLAIMS = _claims_on_the_port()
CLAIMS = [(c, m) for c, cls in vars(PORT_CLAIMS).items()
          if c.startswith("Test") and isinstance(cls, type)
          for m in vars(cls) if m.startswith("test_")]


def test_claims_run_on_the_port_only():
    for name in ("BIG_MEMORY", "DIE_STACKED", "TRADITIONAL", "Workload",
                 "power_crossover_sla", "provision_capacity",
                 "provision_performance", "provision_power", "GB", "TiB"):
        assert getattr(PORT_CLAIMS, name) is getattr(tc, name), name
    assert len(CLAIMS) == CLAIMS_FILE.read_text().count("    def test_")


@pytest.mark.parametrize("cls,name", CLAIMS,
                         ids=[f"{c}.{m}" for c, m in CLAIMS])
def test_paper_claim_holds_on_the_port(cls, name):
    getattr(getattr(PORT_CLAIMS, cls)(), name)()


# --------------------------------------------------------------------------
# model and provisioning
# --------------------------------------------------------------------------

@pytest.mark.parametrize("key", sorted(SYSTEMS))
@pytest.mark.parametrize("regime", ("capacity", "performance", "power"))
def test_provisioning_grid_equals_reference(key, regime):
    t, r = SYSTEMS[key]
    for twl, rwl in workloads():
        assert tmodel.capacity_chips(t, twl) == rmodel.capacity_chips(r, rwl)
        if regime == "capacity":
            for cap in (None, twl.db_size * 2, twl.db_size * 10):
                same_design(tprov.provision_capacity(t, twl, cap),
                            rprov.provision_capacity(r, rwl, cap))
        elif regime == "performance":
            for sla in SLAS:
                same_design(tprov.provision_performance(t, twl, sla),
                            rprov.provision_performance(r, rwl, sla))
                bw = twl.bytes_accessed / sla
                for chips in (1, 7, 4096):
                    assert tmodel.cores_for_throughput(t, bw, chips) == \
                        rmodel.cores_for_throughput(r, bw, chips)
        else:
            for budget in BUDGETS:
                same_design(tprov.provision_power(t, twl, budget),
                            rprov.provision_power(r, rwl, budget))


@pytest.mark.parametrize("a,b", [("traditional", "die-stacked"),
                                 ("big-memory", "die-stacked"),
                                 ("traditional", "h100"),
                                 ("ddr5-host", "h100"),
                                 ("ddr5-host", "tpu-carried")])
def test_power_crossover_equals_reference(a, b):
    (ta, ra), (tb, rb) = SYSTEMS[a], SYSTEMS[b]
    for pct in (0.2, 0.5):
        twl, rwl = tmodel.Workload(16 * TiB, pct), rmodel.Workload(16 * TiB,
                                                                   pct)
        assert tprov.power_crossover_sla(ta, tb, twl) == \
            rprov.power_crossover_sla(ra, rb, rwl)
        assert tprov.power_crossover_sla(ta, tb.with_density(8), twl) == \
            rprov.power_crossover_sla(ra, rb.with_density(8), rwl)
    twl, rwl = tmodel.Workload(TiB, 0.01), rmodel.Workload(TiB, 0.01)
    assert tprov.power_crossover_sla(ta, tb, twl, lo=1e-4, hi=1.0,
                                     steps=500) == \
        rprov.power_crossover_sla(ra, rb, rwl, lo=1e-4, hi=1.0, steps=500)


def test_cluster_design_errors_equal_reference():
    t, r = SYSTEMS["die-stacked"]
    twl, rwl = tmodel.Workload(), rmodel.Workload()
    assert dataclasses.asdict(twl) == dataclasses.asdict(rwl)
    for chips, cores in ((0, 1), (1, 0), (1, 33)):
        assert raised(lambda: tmodel.ClusterDesign(t, twl, chips, cores)) \
            == raised(lambda: rmodel.ClusterDesign(r, rwl, chips, cores))


# --------------------------------------------------------------------------
# traffic and roofline
# --------------------------------------------------------------------------

CELLS = [(a, s) for a in ARCH_IDS for s in R_SHAPES
         if cell_applicable(r_config(a), R_SHAPES[s])[0]]
STRATEGIES = ("megatron", "dp", "dp_noremat", "cp", "2d", "2d_splitcache")


def meshes(mod):
    return (mod.MeshShape.production(False), mod.MeshShape.production(True),
            mod.MeshShape(chips=8, tp=2, fsdp=4, dp=4))


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_traffic_equals_reference(arch, shape):
    tcfg, rcfg = t_config(arch), r_config(arch)
    tsh, rsh = T_SHAPES[shape], R_SHAPES[shape]
    assert dataclasses.asdict(tsh) == dataclasses.asdict(rsh)
    assert ttraffic._kv_bytes_per_row(tcfg, tsh.seq_len) == \
        rtraffic._kv_bytes_per_row(rcfg, rsh.seq_len)
    assert ttraffic._state_bytes_per_row(tcfg) == \
        rtraffic._state_bytes_per_row(rcfg)
    assert ttraffic._attention_layers(tcfg) == \
        rtraffic._attention_layers(rcfg)
    for tm, rm in zip(meshes(ttraffic), meshes(rtraffic)):
        assert dataclasses.asdict(tm) == dataclasses.asdict(rm)
        for strat in STRATEGIES:
            tl, rl = ttraffic.layout_for(strat, tm), rtraffic.layout_for(
                strat, rm)
            assert dataclasses.asdict(tl) == dataclasses.asdict(rl)
            assert tl.token_shards == rl.token_shards
            assert ttraffic.hbm_traffic(tcfg, tsh, tm, strat) == \
                rtraffic.hbm_traffic(rcfg, rsh, rm, strat)
            assert ttraffic.collective_traffic(tcfg, tsh, tm, strat) == \
                rtraffic.collective_traffic(rcfg, rsh, rm, strat)
    assert raised(lambda: ttraffic.layout_for("bogus", meshes(ttraffic)[0])) \
        == raised(lambda: rtraffic.layout_for("bogus", meshes(rtraffic)[0]))
    tmf = troof.model_flops(tcfg, tsh)
    assert tmf == rroof.model_flops(rcfg, rsh)
    for spec in (carried(), tsys.H100_SXM):
        hbm = ttraffic.hbm_traffic(tcfg, tsh, meshes(ttraffic)[0])["total"]
        coll = ttraffic.collective_traffic(tcfg, tsh,
                                           meshes(ttraffic)[0])["total"]
        tt = troof.terms(tmf / 256, hbm, coll, spec=spec, collective_links=4)
        rt = rroof.terms(tmf / 256, hbm, coll, tpu=ref_spec(spec),
                         collective_links=4)
        assert tt.to_dict() == rt.to_dict()
        assert troof.utilization(tt, tmf, 256, spec=spec) == \
            rroof.utilization(rt, tmf, 256, tpu=ref_spec(spec))


def test_roofline_terms_equal_reference():
    for spec in (carried(), tsys.H100_SXM):
        for args in ((197e12, 819e9, 0.0), (1e12, 1e9, 500e9),
                     (0.0, 0.0, 0.0), (3e15, 2e12, 7e10)):
            for links in (None, 1, 18):
                t = troof.terms(*args, spec=spec, collective_links=links)
                r = rroof.terms(*args, tpu=ref_spec(spec),
                                collective_links=links)
                assert t.to_dict() == r.to_dict()
                assert (t.serialized_s, t.bound_fraction) == \
                    (r.serialized_s, r.bound_fraction)
                for eff in (0.0, 0.5, 1.0):
                    assert t.overlapped_step_s(eff) == \
                        r.overlapped_step_s(eff)
    assert troof.terms(1e12, 1e9, 5e9) == troof.terms(
        1e12, 1e9, 5e9, spec=tsys.H100_SXM)
    cost_p = {"flops": 10.0, "bytes": 7.5, "ring": 0.0}
    cost_2p = {"flops": 16.0, "bytes": 9.25, "ring": 3.0}
    for layers, p in ((10, 1), (48, 2), (126, 3)):
        assert troof.extrapolate(cost_p, cost_2p, layers, p) == \
            rroof.extrapolate(cost_p, cost_2p, layers, p)


# --------------------------------------------------------------------------
# advisor
# --------------------------------------------------------------------------

ADVISE_SYSTEMS = ("tpu-carried", "die-stacked", "ddr5-host", "h100")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_advice_equals_reference(arch):
    tcfg, rcfg = t_config(arch), r_config(arch)
    for batch, seq in ((128, 32768), (1, 4096)):
        assert dataclasses.asdict(tadv.lm_decode_workload(tcfg, batch, seq)) \
            == dataclasses.asdict(radv.lm_decode_workload(rcfg, batch, seq))
        for key in ADVISE_SYSTEMS:
            t, r = SYSTEMS[key]
            for sla in (0.005, 0.05):
                assert tadv.advise_decode_sla(tcfg, batch, seq, sla,
                                              t).summary() == \
                    radv.advise_decode_sla(rcfg, batch, seq, sla,
                                           r).summary()
            for budget in (50e3, 1e6):
                assert tadv.advise_power(tcfg, batch, seq, budget,
                                         t).summary() == \
                    radv.advise_power(rcfg, batch, seq, budget, r).summary()
            assert tadv.advise_capacity(tcfg, batch, seq, t).summary() == \
                radv.advise_capacity(rcfg, batch, seq, r).summary()
        # defaults: the port's H100 row, the reference's TPU row
        assert tadv.advise_decode_sla(tcfg, batch, seq, 0.02).summary() == \
            radv.advise_decode_sla(rcfg, batch, seq, 0.02,
                                   SYSTEMS["h100"][1]).summary()
        assert tadv.advise_power(tcfg, batch, seq, 1e6).summary() == \
            radv.advise_power(rcfg, batch, seq, 1e6,
                              SYSTEMS["h100"][1]).summary()
        assert tadv.advise_capacity(tcfg, batch, seq).summary() == \
            radv.advise_capacity(rcfg, batch, seq,
                                 SYSTEMS["h100"][1]).summary()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_when_to_use_accelerator_equals_when_to_use_tpu(arch):
    keys = {"accel_chips": "tpu_chips", "accel_power_kw": "tpu_power_kw",
            "accel_wins_power": "tpu_wins_power"}
    for batch, seq in ((128, 32768), (8, 8192)):
        got = tadv.when_to_use_accelerator(t_config(arch), batch, seq,
                                           spec=carried())
        want = radv.when_to_use_tpu(r_config(arch), batch, seq)
        assert [{keys.get(k, k): v for k, v in row.items()}
                for row in got] == want
        slas = (0.001, 0.5, 2.0)
        assert len(tadv.when_to_use_accelerator(t_config(arch), batch, seq,
                                                slas)) == 3
    # the default row is the H100's: the same as advising it by hand
    rows = tadv.when_to_use_accelerator(t_config(arch), 128, 32768)
    for row in rows:
        d = tadv.advise_decode_sla(t_config(arch), 128, 32768,
                                   row["sla_ms"] / 1e3).design
        assert (row["accel_chips"], row["accel_power_kw"]) == \
            (d.compute_chips, d.power / 1e3)


def test_scan_advice_equals_reference():
    for key in ADVISE_SYSTEMS:
        t, r = SYSTEMS[key]
        for db, scanned in ((4.5 * 2 ** 30, 1.125 * 2 ** 30), (16 * TiB, BPQ),
                            (1e9, 5e9)):
            assert dataclasses.asdict(tadv.scan_workload(db, scanned)) == \
                dataclasses.asdict(radv.scan_workload(db, scanned))
            for sla in (0.001, 0.010, 0.100):
                for measured in (None, 2.4e12, 1e9):
                    assert tadv.advise_scan_sla(
                        db, scanned, sla, t,
                        measured_chip_bps=measured).summary() == \
                        radv.advise_scan_sla(
                            db, scanned, sla, r,
                            measured_chip_bps=measured).summary()
            assert dataclasses.asdict(tadv.calibrated_system(t, 2.4e12)) == \
                dataclasses.asdict(radv.calibrated_system(r, 2.4e12))
    for bad in (0.0, -5.0, float("nan"), float("inf")):
        assert raised(lambda: tadv.calibrated_system(tsys.DIE_STACKED, bad)) \
            == raised(lambda: radv.calibrated_system(rsys.DIE_STACKED, bad))
    assert raised(lambda: tadv.scan_workload(0, 1)) == \
        raised(lambda: radv.scan_workload(0, 1))


def tier_split_cases():
    from repro.tier.trace import zipf_hit_curve as r_zipf
    from repro_torch.tier.trace import zipf_hit_curve as t_zipf
    for skew in (0.6, 1.1):
        yield t_zipf(64, skew), r_zipf(64, skew)
    shared = lambda f: min(1.0, 1.5 * f)
    yield shared, shared
    for pts in ({0.25: 0.4038}, {0.25: 0.6, 0.5: 0.8}, {0.0: 0.1, 1.0: 0.5}):
        yield pts, pts


def test_tier_split_equals_reference():
    for t_curve, r_curve in tier_split_cases():
        for fast, cap in ((10.0, 4.0), (190.0, 76.0), (2400.0, 960.0)):
            for sla in (1e-4, 0.010):
                for fs in (None, "h100", "die-stacked"):
                    for fractions in (None, (0.5, 0.1, 0.25)):
                        kw = dict(hit_curve=None, fast_gbps=fast,
                                  capacity_gbps=cap, chips=2,
                                  fractions=fractions)
                        t_fs, r_fs = SYSTEMS[fs] if fs else (None, None)
                        got = tadv.advise_tier_split(
                            1 << 32, 1 << 28, sla, **{**kw,
                                                      "hit_curve": t_curve},
                            fast_system=t_fs)
                        want = radv.advise_tier_split(
                            1 << 32, 1 << 28, sla, **{**kw,
                                                      "hit_curve": r_curve},
                            fast_system=r_fs)
                        assert got == want


def test_tier_split_at_the_card_rate_needs_the_h100_row():
    """The reference's default fast system is the 2016 HBM2 node: Eq. 4
    192 GB/s a chip, below any rate the card measures; the H100 row's
    3.35 TB/s holds it."""
    kw = dict(hit_curve={0.25: 0.4}, fast_gbps=2400.0, capacity_gbps=960.0)
    old = tadv.advise_tier_split(1 << 32, 1 << 28, 0.01, **kw)
    assert old["roofline_gbps"] == 192.0
    assert not old["fast_within_roofline"]
    assert not any(r["within_roofline"] for r in old["rows"])
    new = tadv.advise_tier_split(1 << 32, 1 << 28, 0.01, **kw,
                                 fast_system=H100_PAPER)
    assert new["roofline_gbps"] == 3350.0
    assert new["fast_within_roofline"]
    assert all(r["within_roofline"] for r in new["rows"])


def test_tier_split_errors_equal_reference():
    base = dict(db_bytes=1 << 30, bytes_per_query=1 << 24, sla_s=0.01,
                hit_curve={0.5: 0.5}, fast_gbps=10.0, capacity_gbps=4.0)
    for bad in (dict(db_bytes=0), dict(bytes_per_query=-1), dict(sla_s=0.0),
                dict(fast_gbps=0.0), dict(capacity_gbps=-1.0),
                dict(hit_curve={}), dict(hit_curve={1.5: 0.5})):
        kw = {**base, **bad}
        assert raised(lambda: tadv.advise_tier_split(**kw)) == \
            raised(lambda: radv.advise_tier_split(**kw))


@pytest.fixture(scope="module")
def attribution():
    """The reference's own obs.critical_path.Attribution of a traced
    tiered replay."""
    from repro.db import Table
    from repro.obs import Tracer
    from repro.obs.critical_path import attribute
    from repro.tier import TraceSpec, make_trace, paper_tiers, replay_trace
    table = Table.synthetic("t", 4096, {f"c{i}": 8 for i in range(4)},
                            seed=0)
    tiers = paper_tiers(0.25 * table.nbytes, fast_gbps=0.05)
    tracer = Tracer()
    replay_trace(table, make_trace(table, TraceSpec(n_queries=24, skew=1.1,
                                                    seed=3)),
                 tiers, "cache", chunk_rows=512, tracer=tracer)
    return attribute(tracer), table.nbytes, tiers


def test_whatif_equals_reference(attribution):
    attr, db, tiers = attribution
    assert attr.seconds and attr.queries > 0
    for t_curve, r_curve in tier_split_cases():
        for attr_in in (attr, {"fast_read": 2e-3, "capacity_read": 5e-3,
                               "queue": 1e-3}):
            for sla in (1e-4, 10.0):
                kw = dict(db_bytes=db, bytes_per_query=db / 5, sla_s=sla,
                          current_fraction=0.25, fast_gbps=tiers.fast.gbps,
                          capacity_gbps=tiers.capacity.gbps)
                assert tadv.whatif_fast_fraction(
                    attr_in, hit_curve=t_curve, **kw) == \
                    radv.whatif_fast_fraction(attr_in, hit_curve=r_curve,
                                              **kw)
    kw = dict(db_bytes=1e9, bytes_per_query=1e6, sla_s=0.01,
              hit_curve=lambda f: f, fast_gbps=10.0, capacity_gbps=1.0)
    for attr_in, frac in (({"queue": 5.0}, 0.5), ({"fast_read": 1.0}, 1.5)):
        assert raised(lambda: tadv.whatif_fast_fraction(
            attr_in, current_fraction=frac, **kw)) == \
            raised(lambda: radv.whatif_fast_fraction(
                attr_in, current_fraction=frac, **kw))


def test_advise_cost_equals_reference():
    for sla in (0.005, 0.010, 0.060, 1.0):
        for kw in (dict(), dict(skew=1.1), dict(skew=0.6, fast_gbps=150.0),
                   dict(compression_ratio=8.0),
                   dict(measured_energy_j=3.6e6, measured_latency_s=0.012),
                   dict(skew=1.1, measured_energy_j=10.0,
                        measured_latency_s=sla)):
            for budget in (20e3, 1e6):
                assert tadv.advise_cost(DB, BPQ, sla, budget, **kw) == \
                    radv.advise_cost(DB, BPQ, sla, budget, **kw)
    assert raised(lambda: tadv.advise_cost(DB, BPQ, 0.01, 1e6,
                                           measured_energy_j=1.0)) == \
        raised(lambda: radv.advise_cost(DB, BPQ, 0.01, 1e6,
                                        measured_energy_j=1.0))


# --------------------------------------------------------------------------
# energy.tco
# --------------------------------------------------------------------------

def test_cost_sheet_and_prices_equal_reference():
    assert ttco.DEFAULT_COSTS.mem_usd("h100-sxm-as-paper") == \
        ttco.DEFAULT_COSTS.mem_usd("die-stacked")
    assert "h100-sxm-as-paper".startswith(ttco.BANDWIDTH_RICH_PREFIXES)
    common = [r for r in rtco.DEFAULT_COSTS.mem_usd_per_gib
              if not r[0].startswith("tpu")]
    assert [r for r in ttco.DEFAULT_COSTS.mem_usd_per_gib
            if not r[0].startswith("h100")] == common
    for name in ("quantum-foam", "tpu-v5e-as-paper"):
        assert raised(lambda: ttco.DEFAULT_COSTS.mem_usd(name))[0] == \
            "ValueError"
    assert raised(lambda: T_SHEET.mem_usd("quantum-foam")) == \
        raised(lambda: R_SHEET.mem_usd("quantum-foam"))
    for bad in (dict(chip_usd=-1.0), dict(usd_per_kwh=float("nan")),
                dict(amortize_s=0.0)):
        assert raised(lambda: ttco.CostSheet(**bad)) == \
            raised(lambda: rtco.CostSheet(**bad))
    sheet_t = ttco.CostSheet(usd_per_kwh=0.13, amortize_s=1000.0)
    sheet_r = rtco.CostSheet(usd_per_kwh=0.13, amortize_s=1000.0)
    for args in ((1000.0, 1.0, 0.0), (0.0, 1.0, 3.6e6), (5e6, 0.01, 12.5)):
        assert ttco.usd_per_query(*args, sheet_t) == \
            rtco.usd_per_query(*args, sheet_r)
        assert ttco.usd_per_query(*args) == rtco.usd_per_query(*args)
    for args in ((1.0, 0.0, 1.0), (1.0, 1.0, float("nan")), (-1, 1, 1)):
        assert raised(lambda: ttco.usd_per_query(*args)) == \
            raised(lambda: rtco.usd_per_query(*args))


@pytest.mark.parametrize("key", sorted(SYSTEMS))
def test_evaluate_system_equals_reference(key):
    t, r = SYSTEMS[key]
    for twl, rwl in workloads():
        for sla in SLAS:
            assert ttco.evaluate_system(t, twl, sla, T_SHEET) == \
                rtco.evaluate_system(r, rwl, sla, R_SHEET)
        d = tprov.provision_capacity(t, twl)
        assert ttco.capex_usd(d, T_SHEET) == rtco.capex_usd(
            rprov.provision_capacity(r, rwl), R_SHEET)
    if key != "tpu-carried":
        assert ttco.evaluate_system(t, twl, 0.01) == \
            rtco.evaluate_system(r, rwl, 0.01, R_SHEET)


def test_evaluate_tiered_equals_reference():
    for sla in (0.001, 0.010, 0.060, 1.0):
        for skew in (0.6, 1.1, 1.5):
            for fast in (None, 100.0, 190.0, 500.0):
                for fs in ("die-stacked", "tpu-carried", "h100"):
                    t_fs, r_fs = SYSTEMS[fs]
                    for n_hot in (16, 64):
                        assert ttco.evaluate_tiered(
                            DB, BPQ, sla, skew, T_SHEET, fast_gbps=fast,
                            n_hot_items=n_hot, fast_system=t_fs) == \
                            rtco.evaluate_tiered(
                                DB, BPQ, sla, skew, R_SHEET, fast_gbps=fast,
                                n_hot_items=n_hot, fast_system=r_fs)
                assert ttco.evaluate_tiered(DB, BPQ, sla, skew,
                                            fast_gbps=fast) == \
                    rtco.evaluate_tiered(DB, BPQ, sla, skew, fast_gbps=fast)


def test_card_rate_tiered_candidate_needs_the_h100_row():
    """At a rate the card measures, the default fast system (the 2016
    node, 192 GB/s) drops every tiered row, so cheapest_architecture
    prices no tiered node; the H100 row prices it (as the reference
    would with its own accelerator row)."""
    card = 2400.0
    assert ttco.evaluate_tiered(DB, BPQ, 0.010, 1.1, fast_gbps=card) is None
    cell = ttco.cheapest_architecture(DB, BPQ, 0.010, 1e6, skew=1.1,
                                      fast_gbps=card)
    assert all(c["name"] != "tiered" for c in cell["candidates"])
    t = ttco.evaluate_tiered(DB, BPQ, 0.010, 1.1, fast_gbps=card,
                             fast_system=H100_PAPER)
    assert t is not None and t["measured_rates"] and t["meets_sla"]
    assert t["response_time_s"] <= 0.010 * (1 + 1e-9)
    assert t == rtco.evaluate_tiered(DB, BPQ, 0.010, 1.1, R_SHEET,
                                     fast_gbps=card,
                                     fast_system=SYSTEMS["h100"][1])


@pytest.mark.parametrize("sla", (0.005, 0.010, 0.060, 0.250, 1.0))
def test_cheapest_architecture_equals_reference(sla):
    t_all = tuple(SYSTEMS[k][0] for k in SYSTEMS)
    r_all = tuple(SYSTEMS[k][1] for k in SYSTEMS)
    for budget in (1e3, 20e3, 50e3, 250e3, 1e6, 1e9):
        for skew in (None, 0.6, 1.1):
            for kw in (dict(), dict(compression_ratio=4.0),
                       dict(grouped_mix=0.3), dict(
                           grouped_mix=0.5, grouped_bytes_per_query=BPQ / 3,
                           compression_ratio=2.0), dict(fast_gbps=150.0)):
                assert ttco.cheapest_architecture(
                    DB, BPQ, sla, budget, skew=skew, **kw) == \
                    rtco.cheapest_architecture(DB, BPQ, sla, budget,
                                               skew=skew, **kw)
            got = ttco.cheapest_architecture(
                DB, BPQ, sla, budget, skew=skew, sheet=T_SHEET,
                systems=t_all, bandwidth_rich_prefixes=BOTH_PREFIXES,
                compression_ratio=3.0)
            want = rtco.cheapest_architecture(
                DB, BPQ, sla, budget, skew=skew, sheet=R_SHEET,
                systems=r_all, bandwidth_rich_prefixes=BOTH_PREFIXES,
                compression_ratio=3.0)
            assert got == want
    for bad in (dict(db_bytes=0), dict(sla_s=float("nan")),
                dict(power_budget_w=-5.0), dict(compression_ratio=0.5),
                dict(grouped_mix=1.5), dict(grouped_bytes_per_query=0.0)):
        kw = {**dict(db_bytes=DB, bytes_per_query=BPQ, sla_s=sla,
                     power_budget_w=1e6), **bad}
        assert raised(lambda: ttco.cheapest_architecture(**kw)) == \
            raised(lambda: rtco.cheapest_architecture(**kw))


def test_h100_is_bandwidth_rich_and_priced():
    cell = ttco.cheapest_architecture(
        DB, BPQ, 0.010, 1e6, compression_ratio=4.0,
        systems=(tsys.TRADITIONAL, tsys.DIE_STACKED, H100_PAPER))
    by = {c["name"]: c for c in cell["candidates"]}
    assert by["traditional"]["compressed"]
    assert not by["h100-sxm-as-paper"]["compressed"]
    assert by["h100-sxm-as-paper"]["meets_sla"]


def test_decision_surface_equals_reference():
    for kw in (dict(), dict(slas=(0.010, 1.0), skews=(None, 1.1),
                            power_budgets_w=(50e3, 1e6),
                            compression_ratios=(1.0, 8.0),
                            grouped_mixes=(0.0, 0.25),
                            grouped_bytes_per_query=BPQ / 2),
               dict(fast_gbps=180.0, n_hot_items=16)):
        assert ttco.decision_surface(DB, BPQ, **kw) == \
            rtco.decision_surface(DB, BPQ, **kw)


def test_compression_crossover_equals_reference():
    for sla in (0.005, 0.010, 0.060):
        for budget in (1e6, 5e6):
            for kw in (dict(), dict(skew=1.1), dict(max_ratio=1.5),
                       dict(tol=0.1)):
                assert ttco.compression_crossover_ratio(
                    DB, BPQ, sla, budget, **kw) == \
                    rtco.compression_crossover_ratio(DB, BPQ, sla, budget,
                                                     **kw)


# --------------------------------------------------------------------------
# sweep: torch float32 against the reference's jnp float32
# --------------------------------------------------------------------------

SWEEP_SLAS = np.geomspace(1e-3, 10.0, 64)


@pytest.mark.parametrize("key", sorted(SYSTEMS))
def test_hard_sweep_equals_reference_bit_for_bit(key):
    t, r = SYSTEMS[key]
    for twl, rwl in workloads():
        got = tsweep.sweep_performance(t, twl, SWEEP_SLAS, device="cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        want = np.asarray(rsweep.sweep_performance(r, rwl, SWEEP_SLAS))
        assert np.array_equal(got.numpy(), want)
        # the scalar model, within the reference test's 2%
        for i in (0, 21, 42, 63):
            scalar = tprov.provision_performance(t, twl,
                                                 float(SWEEP_SLAS[i])).power
            assert abs(float(got[i]) - scalar) / scalar < 0.02
        for density, cps in ((1.0, 1.0), (8.0, 0.1)):
            got = tsweep.soft_performance_power(
                t, twl, torch.tensor(SWEEP_SLAS, dtype=torch.float32),
                density, cps, hard=True)
            want = rsweep.soft_performance_power(r, rwl, SWEEP_SLAS,
                                                 density, cps, hard=True)
            assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("key", sorted(SYSTEMS))
def test_soft_sweep_and_gradients_within_tolerance(key):
    t, r = SYSTEMS[key]
    for twl, rwl in workloads():
        got = tsweep.soft_performance_power(t, twl, SWEEP_SLAS,
                                            device="cpu").numpy()
        want = np.asarray(rsweep.soft_performance_power(r, rwl, SWEEP_SLAS))
        assert np.all(np.abs(got - want) <= SOFT_RTOL * np.abs(want))
        for sla in (0.001, 0.01, 0.06, 1.0):
            g = tsweep.power_sensitivity(t, twl, sla, device="cpu")
            if isinstance(r.chip_capacity, int) and r.chip_capacity >= 2**31:
                # DDR5_HOST's capacity is a Python int (2^40 B a chip):
                # times a traced density, jnp takes it as int32 and
                # overflows (ROADMAP queue 3); the port's is float32
                with pytest.raises(OverflowError):
                    rsweep.power_sensitivity(r, rwl, sla)
                assert all(math.isfinite(v) for v in g.values())
                continue
            h = rsweep.power_sensitivity(r, rwl, sla)
            assert g.keys() == h.keys()
            for k in g:
                assert math.isclose(g[k], h[k], rel_tol=GRAD_RTOL), \
                    (k, sla, g[k], h[k])


def test_sweep_signs_and_device():
    """tests/test_core_engines.py::TestSweep on the port."""
    wl = tmodel.Workload(16 * TiB, 0.20)
    hard = tsweep.soft_performance_power(tsys.DIE_STACKED, wl, 0.01,
                                         hard=True, device="cpu")
    soft = tsweep.soft_performance_power(tsys.DIE_STACKED, wl, 0.01,
                                         device="cpu")
    assert abs(float(hard) - float(soft)) / float(hard) < 0.05
    g = tsweep.power_sensitivity(tsys.DIE_STACKED, wl, 0.01, device="cpu")
    assert g["d_power_d_log_density"] < 0
    assert g["d_power_d_log_core_power"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsweep.sweep_performance(tsys.DIE_STACKED, wl, SWEEP_SLAS)


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

@pytest.mark.parametrize("argv", (
    ["--arch", "internlm2-1.8b", "--sla-ms", "20", "--compare-host"],
    ["--arch", "mixtral-8x22b", "--power-kw", "250"],
    ["--arch", "mamba2-1.3b", "--batch", "8", "--seq", "4096",
     "--compare-host"],
    ["--arch", "llama3-405b", "--sla-ms", "20", "--power-kw", "500"]))
def test_cli_prints_the_reference_numbers(argv, monkeypatch, capsys):
    """The port's CLI with the reference's row carried over prints the
    reference CLI's numbers, line for line; only the labels name the
    H100."""
    row = carried()
    monkeypatch.setattr(tadv, "H100_SXM", row)
    monkeypatch.setattr(tadv.when_to_use_accelerator, "__defaults__",
                        (tadv.when_to_use_accelerator.__defaults__[0], row))
    tcli.main(argv)
    got = capsys.readouterr().out.splitlines()
    rcli.main(argv)
    want = capsys.readouterr().out.splitlines()
    assert [a.replace("H100", "TPU").replace("h100", "tpu")
            for a in got] == want


def test_cli_defaults_to_the_h100_row(capsys):
    tcli.main(["--arch", "internlm2-1.8b", "--sla-ms", "20",
               "--compare-host"])
    out = capsys.readouterr().out
    assert '"system": "h100-sxm-as-paper"' in out
    assert "when-to-use (H100 vs DDR5 host)" in out
    rows = tadv.when_to_use_accelerator(t_config("internlm2-1.8b"), 128,
                                        32768)
    for row in rows:
        assert f"{row['accel_power_kw']:9.1f} kW vs host" in out
