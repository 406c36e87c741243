"""When-to-use advisor: the paper's provisioning model applied to
accelerator clusters serving the assigned LM architectures and running
the engine's scans (counterpart of repro/core/advisor.py; the default
system is the H100 datasheet row).

The mapping: LLM decode is the bandwidth-bound "query" — each generated
token touches the active parameters plus the KV cache (the modern `percent
accessed`), and the in-memory "database" is params + cache. An H100 is
the die-stacked node (HBM on the package); a DDR5 host is the traditional
server. The paper's Eqs. 1-10 then answer: how many chips for an SLA, what
does a power budget buy, what does capacity provisioning cost — with the
collective roofline term (which the paper ignored, §6.2) layered on top.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core import traffic
from repro_torch.core.model import ClusterDesign, Workload
from repro_torch.core.provisioning import (provision_capacity,
                                           provision_performance,
                                           provision_power)
from repro_torch.core.systems import (GB, H100_SXM, AcceleratorSpec,
                                      SystemSpec, as_paper_system)

# a 2026 "traditional server" for the comparison set: dual-socket DDR5 host
DDR5_HOST = SystemSpec(
    name="ddr5-host",
    module_capacity=64 * 2**30,      # 64 GiB DIMM
    channel_bandwidth=38.4 * GB,     # DDR5-4800 channel
    memory_channels=8,
    channel_modules=2,
    module_power=10.0,
    blade_chips=2,
    core_perf=12 * GB,               # AVX-512 scan/decode throughput per core
    core_power=5.0,
    max_chip_cores=64,
    blade_overhead=200.0,
)


def lm_decode_workload(cfg: ArchConfig, batch: int, seq_len: int) -> Workload:
    """The paper's (db_size, percent_accessed) for one decode step."""
    params_bytes = 2.0 * cfg.param_count()
    cache_bytes = (traffic._kv_bytes_per_row(cfg, seq_len)
                   + traffic._state_bytes_per_row(cfg)) * batch
    db = params_bytes + cache_bytes
    touched = 2.0 * cfg.active_param_count() + cache_bytes
    return Workload(db_size=db, percent_accessed=min(touched / db, 1.0))


@dataclass(frozen=True)
class Advice:
    design: ClusterDesign
    constraint: str
    value: float

    def summary(self) -> dict:
        d = self.design.summary()
        d["constraint"] = f"{self.constraint}={self.value:g}"
        return d


def advise_decode_sla(cfg: ArchConfig, batch: int, seq_len: int,
                      sla_s: float, system: SystemSpec | None = None
                      ) -> Advice:
    """Chips needed so one batched decode step meets `sla_s` (per-token
    latency SLA)."""
    sys_ = system or as_paper_system(H100_SXM)
    wl = lm_decode_workload(cfg, batch, seq_len)
    return Advice(provision_performance(sys_, wl, sla_s), "sla_s", sla_s)


def advise_power(cfg: ArchConfig, batch: int, seq_len: int, budget_w: float,
                 system: SystemSpec | None = None) -> Advice:
    sys_ = system or as_paper_system(H100_SXM)
    wl = lm_decode_workload(cfg, batch, seq_len)
    return Advice(provision_power(sys_, wl, budget_w), "power_w", budget_w)


def advise_capacity(cfg: ArchConfig, batch: int, seq_len: int,
                    system: SystemSpec | None = None) -> Advice:
    sys_ = system or as_paper_system(H100_SXM)
    wl = lm_decode_workload(cfg, batch, seq_len)
    return Advice(provision_capacity(sys_, wl), "capacity_b", wl.db_size)


def scan_workload(db_bytes: float, bytes_scanned: float) -> Workload:
    """The paper's (db_size, percent accessed) measured by the query engine
    rather than assumed: db = the table's packed footprint, percent = the
    fraction one query actually streams."""
    if db_bytes <= 0:
        raise ValueError(f"db_bytes={db_bytes} must be positive")
    return Workload(db_size=db_bytes,
                    percent_accessed=min(bytes_scanned / db_bytes, 1.0))


def calibrated_system(system: SystemSpec,
                      measured_chip_bps: float) -> SystemSpec:
    """Feed Eq. 4 with *attained* per-chip scan throughput: core_perf is
    rescaled so max_cores * core_perf equals the measured rate. Provisioning
    a cluster from this spec answers the paper's question for the system we
    actually built, not the datasheet."""
    if not math.isfinite(measured_chip_bps) or measured_chip_bps <= 0:
        raise ValueError(
            f"measured_chip_bps={measured_chip_bps} is a degenerate "
            f"calibration (must be a finite positive rate); run at least "
            f"one query before calibrating")
    return dataclasses.replace(
        system, name=f"{system.name}-measured",
        core_perf=measured_chip_bps / system.max_chip_cores)


def advise_scan_sla(db_bytes: float, bytes_per_query: float, sla_s: float,
                    system: SystemSpec | None = None,
                    measured_chip_bps: float | None = None) -> Advice:
    """Chips needed so one scan query meets `sla_s`, optionally from the
    query engine's measured per-chip throughput (the model-vs-measured
    loop)."""
    sys_ = system or as_paper_system(H100_SXM)
    if measured_chip_bps is not None:
        sys_ = calibrated_system(sys_, measured_chip_bps)
    wl = scan_workload(db_bytes, bytes_per_query)
    return Advice(provision_performance(sys_, wl, sla_s), "sla_s", sla_s)


def advise_tier_split(db_bytes: float, bytes_per_query: float, sla_s: float,
                      *, hit_curve, fast_gbps: float, capacity_gbps: float,
                      chips: int = 1, fractions=None,
                      fast_system: SystemSpec | None = None) -> dict:
    """The tiered form of the paper's question: how much die-stacked fast
    tier does this workload need to meet its SLA?

    Searches the fast-tier fraction of the database (`fractions`, default
    5%..100%): at each fraction f, `hit_curve(f)` — the fraction of scanned
    bytes the placement engine serves from the fast tier (measured stats,
    or repro_torch.tier.trace.zipf_hit_curve analytically) — yields a
    blended rate (serve.sla.blended_bps), a per-query response time, and
    the chip count performance-provisioning would need at that rate.
    Every row —
    and the measured fast rate itself — is cross-checked against the
    Eq. 4 roofline of `fast_system`'s *datasheet* (default DIE_STACKED):
    an independent bound, so a mis-measured rate (wrong byte accounting, a
    broken blend) fails the check instead of defining it.

    Returns {"rows": [...], "best": minimal-feasible row or None,
    "roofline_gbps": ..., "fast_within_roofline": bool}.
    """
    from repro_torch.core.systems import DIE_STACKED
    from repro_torch.serve.sla import blended_bps

    if db_bytes <= 0 or bytes_per_query <= 0:
        raise ValueError(f"db_bytes={db_bytes} and bytes_per_query="
                         f"{bytes_per_query} must be positive")
    if sla_s <= 0:
        raise ValueError(f"sla_s={sla_s} must be positive")
    if fast_gbps <= 0 or capacity_gbps <= 0:
        raise ValueError(f"tier rates must be positive, got fast_gbps="
                         f"{fast_gbps} capacity_gbps={capacity_gbps}")
    if not callable(hit_curve):
        pts = sorted(hit_curve.items())     # measured {fraction: hit_rate}
        if not pts:
            raise ValueError("hit_curve dict is empty; measure at least "
                             "one (fast_fraction, hit_rate) point or pass "
                             "an analytic curve (trace.zipf_hit_curve)")
        if any(not 0.0 <= x <= 1.0 for x, _ in pts):
            raise ValueError(f"hit_curve fractions must be in [0, 1], "
                             f"got {[x for x, _ in pts]}")
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        # a zero fast tier hits nothing by definition; beyond the last
        # measured point np.interp clamps to the measured value rather
        # than assuming a perfect 100% hit rate at full residency
        if xs[0] > 0.0:
            xs, ys = [0.0] + xs, [0.0] + ys
        hit_curve = lambda f, xs=xs, ys=ys: float(np.interp(f, xs, ys))
    # ascending order so "best" really is the minimal feasible fraction
    fractions = (sorted(fractions) if fractions is not None
                 else [i / 20 for i in range(1, 21)])

    # Eq. 4 of the datasheet fast system: min(compute, bandwidth) per
    # chip. Independent of the measured rates, so it can actually fail.
    fast_sys = fast_system or DIE_STACKED
    roofline_bps = fast_sys.chip_peak_perf * chips

    rows = []
    for f in fractions:
        h = min(max(float(hit_curve(f)), 0.0), 1.0)
        rate = blended_bps(fast_gbps * 1e9, capacity_gbps * 1e9, h) * chips
        rt = bytes_per_query / rate
        per_chip = rate / chips
        rows.append({
            "fast_fraction": round(float(f), 4),
            "fast_bytes": f * db_bytes,
            "hit_rate": h,
            "blended_gbps": rate / 1e9,
            "response_time_s": rt,
            "meets_sla": rt <= sla_s,
            "chips_for_sla": math.ceil(bytes_per_query
                                       / (sla_s * per_chip)),
            "within_roofline": rate <= roofline_bps * (1 + 1e-9),
        })
    best = next((r for r in rows if r["meets_sla"]), None)
    return {"sla_s": sla_s, "chips": chips, "rows": rows, "best": best,
            "roofline_gbps": roofline_bps / 1e9,
            "fast_within_roofline":
                fast_gbps * 1e9 * chips <= roofline_bps * (1 + 1e-9)}


def whatif_fast_fraction(attribution, *, db_bytes: float,
                         bytes_per_query: float, sla_s: float,
                         current_fraction: float, hit_curve,
                         fast_gbps: float, capacity_gbps: float,
                         chips: int = 1, fractions=None) -> dict:
    """What-if: convert critical-path attribution into the estimated gain
    from raising the fast-tier fraction.

    `attribution` is any object with `.seconds` — category -> total
    path seconds — and `.queries`, such as
    repro_torch.obs.critical_path.Attribution.
    The read-bound categories (fast_read, capacity_read, stream_wait)
    are the seconds a bigger fast tier can move; queue, recovery, and
    throttle are carried over unchanged — the attribution *measured*
    that they are not read-rate-bound, which is exactly the information
    a blended-rate model alone cannot see.

    At each candidate fraction f the measured per-query read time is
    scaled by the analytic blended-time ratio
    `t_model(hit(f)) / t_model(hit(current_fraction))` — so overlap or
    layout effects baked into the measurement are preserved while the
    hit-rate improvement moves it. Every row's analytic response time is
    cross-checked against `advise_tier_split` (the tier decision
    surface, an independent pass through blended_bps + the Eq. 4
    roofline) to 1e-6 relative — a drifted formula raises instead of
    advising from it.
    """
    from repro_torch.serve.sla import blended_bps

    seconds = dict(getattr(attribution, "seconds", attribution))
    queries = max(int(getattr(attribution, "queries", 0)) or 1, 1)
    if not 0.0 <= current_fraction <= 1.0:
        raise ValueError(f"current_fraction={current_fraction} must be "
                         f"in [0, 1]")
    read_cats = ("fast_read", "capacity_read", "stream_wait")
    read_s = sum(seconds.get(c, 0.0) for c in read_cats) / queries
    other_s = (sum(seconds.values()) / queries) - read_s
    if read_s <= 0:
        raise ValueError(
            "attribution has no read-bound path seconds (fast_read/"
            "capacity_read/stream_wait all zero); there is nothing a "
            "bigger fast tier could speed up")

    surface = advise_tier_split(
        db_bytes, bytes_per_query, sla_s, hit_curve=hit_curve,
        fast_gbps=fast_gbps, capacity_gbps=capacity_gbps, chips=chips,
        fractions=fractions)
    curve = (hit_curve if callable(hit_curve)
             else None)

    def model_t(h: float) -> float:
        rate = blended_bps(fast_gbps * 1e9, capacity_gbps * 1e9,
                           h) * chips
        return bytes_per_query / rate

    # current operating point: hit rate via the surface's own curve
    # handling (dict curves get the same interpolation the rows used)
    if curve is not None:
        h0 = min(max(float(curve(current_fraction)), 0.0), 1.0)
    else:
        xs = sorted(hit_curve)
        ys = [hit_curve[x] for x in xs]
        if xs and xs[0] > 0.0:
            xs, ys = [0.0] + xs, [0.0] + ys
        h0 = min(max(float(np.interp(current_fraction, xs, ys)), 0.0),
                 1.0)
    t0 = model_t(h0)

    rows = []
    for srow in surface["rows"]:
        h = srow["hit_rate"]
        t_model = model_t(h)
        # the cross-check: same number through the decision surface
        rel = abs(t_model - srow["response_time_s"]) \
            / max(srow["response_time_s"], 1e-30)
        if rel > 1e-6:
            raise ValueError(
                f"what-if response model disagrees with "
                f"advise_tier_split at fraction "
                f"{srow['fast_fraction']}: {t_model!r} vs "
                f"{srow['response_time_s']!r} (rel {rel:.3g})")
        est_read = read_s * (t_model / t0)
        est_resp = other_s + est_read
        rows.append({
            "fast_fraction": srow["fast_fraction"],
            "hit_rate": h,
            "est_read_s": est_read,
            "est_response_s": est_resp,
            "est_gain_s": read_s - est_read,
            "meets_sla": est_resp <= sla_s,
            "within_roofline": srow["within_roofline"],
        })
    best = next((r for r in rows if r["meets_sla"]), None)
    return {
        "sla_s": sla_s,
        "chips": chips,
        "current": {"fast_fraction": current_fraction, "hit_rate": h0,
                    "read_s": read_s, "other_s": other_s,
                    "response_s": read_s + other_s},
        "rows": rows,
        "best": best,
        "surface": surface,
    }


def advise_cost(db_bytes: float, bytes_per_query: float, sla_s: float,
                power_budget_w: float, *, skew: float | None = None,
                fast_gbps: float | None = None, sheet=None,
                compression_ratio: float = 1.0,
                measured_energy_j: float | None = None,
                measured_latency_s: float | None = None) -> dict:
    """The paper's full three-axis question: given an SLA, a power
    envelope, and a workload, which architecture is cheapest per query?

    Delegates to repro_torch.energy.tco.cheapest_architecture (Table-1
    systems performance-provisioned for the SLA, power-infeasible ones
    excluded, plus — with `skew` — a two-tier node at the zipf hit
    curve's blended rate; `fast_gbps` prices the fast tier from the
    measured autotune sweep; `compression_ratio` — e.g. a measured
    EncodedTable.ratio — shrinks both footprint and traffic, the
    repro_torch.store axis). With
    `measured_energy_j`/`measured_latency_s` from a metered run
    (EnergyMeter + QueryEngine), the winner's $/query is re-priced at
    the *measured* operating point alongside the datasheet figure, the
    same model-vs-measured loop as model_check()/provision().
    """
    from repro_torch.energy import tco

    cell = tco.cheapest_architecture(
        db_bytes, bytes_per_query, sla_s, power_budget_w, skew=skew,
        sheet=sheet or tco.DEFAULT_COSTS, fast_gbps=fast_gbps,
        compression_ratio=compression_ratio)
    if measured_energy_j is not None or measured_latency_s is not None:
        if measured_energy_j is None or measured_latency_s is None:
            raise ValueError(
                "measured re-pricing needs both measured_energy_j and "
                "measured_latency_s (one without the other mixes "
                "datasheet and metered terms in a single $/query)")
        win = next((c for c in cell["candidates"]
                    if c["name"] == cell["winner"]), None)
        if win is not None:
            cell["usd_per_query_measured"] = tco.usd_per_query(
                win["capex_usd"], measured_latency_s, measured_energy_j,
                sheet or tco.DEFAULT_COSTS)
    return cell


def when_to_use_accelerator(cfg: ArchConfig, batch: int, seq_len: int,
                            slas=(0.005, 0.020, 0.100, 0.500),
                            spec: AcceleratorSpec = H100_SXM) -> list[dict]:
    """The paper's Fig. 3 question for the 2020s: at which per-token SLAs
    does the accelerator (die-stacked) cluster use less power than a
    DDR5-host cluster for the same decode workload?"""
    accel = as_paper_system(spec)
    out = []
    for sla in slas:
        a = advise_decode_sla(cfg, batch, seq_len, sla, accel)
        b = advise_decode_sla(cfg, batch, seq_len, sla, DDR5_HOST)
        out.append({
            "sla_ms": sla * 1e3,
            "accel_chips": a.design.compute_chips,
            "accel_power_kw": a.design.power / 1e3,
            "host_chips": b.design.compute_chips,
            "host_power_kw": b.design.power / 1e3,
            "host_overprovision_x": b.design.overprovision_factor,
            "accel_wins_power": a.design.power < b.design.power,
        })
    return out
