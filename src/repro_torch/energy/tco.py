"""Cost-effectiveness: $/query and the paper's decision surface
(counterpart of repro/energy/tco.py).

The paper's bottom line (§7) is neither "die-stacking is fast" nor
"die-stacking is power-hungry" — it is that the *cheapest* architecture
depends on the SLA, the power envelope, and the workload jointly. This
module makes that verdict executable:

- `CostSheet`: capex assumptions ($/GiB per memory technology, $/chip,
  $/blade) plus opex ($/kWh) and a depreciation horizon. The defaults are
  Table-1-era list prices; every number is an input, not a constant.
- `usd_per_query`: amortized capex per served query (the cluster serves
  queries back-to-back at its response time) plus metered energy opex
  (J/query x $/kWh) — the measured path takes the EnergyMeter's joules and
  the engine's attained latency instead of datasheet derivations.
- `cheapest_architecture` / `decision_surface`: sweep SLA x skew x power
  budget, provision each candidate (the paper's Table-1 systems via
  provision_performance, plus a two-tier die-stacked-over-DDR node priced
  from the tier model), drop the power-infeasible ones, and name the
  cheapest $/query per cell — Figures 4/6/7 as one queryable surface.
  With `fast_gbps` from the autotune cache (tier.tiers.measured_fast_gbps)
  the tiered candidate runs at *measured* blended rates instead of
  datasheet numbers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.model import ClusterDesign, Workload
from repro_torch.core.provisioning import provision_performance
from repro_torch.core.systems import (BIG_MEMORY, DIE_STACKED, GiB,
                                      TRADITIONAL, SystemSpec)

_YEAR_S = 365.25 * 86400.0


@dataclass(frozen=True)
class CostSheet:
    """Capex/opex assumptions. `mem_usd_per_gib` maps Table-1 system names
    (prefix-matched, so density/power variants inherit their base price)
    to $/GiB of deployed memory."""

    mem_usd_per_gib: tuple[tuple[str, float], ...] = (
        ("traditional", 10.0),     # commodity DDR4 DIMMs
        ("big-memory", 25.0),      # buffer-on-board appliance memory
        ("die-stacked", 40.0),     # HBM stacks, on-package integration
        ("ddr5-host", 12.0),
        # the H100 row (as_paper_system(H100_SXM)): the price this sheet
        # already gives HBM stacks above, not a quote
        ("h100", 40.0),
    )
    chip_usd: float = 2000.0
    blade_usd: float = 1000.0
    usd_per_kwh: float = 0.10
    amortize_s: float = 3.0 * _YEAR_S     # depreciation horizon

    def __post_init__(self):
        for field_name in ("chip_usd", "blade_usd", "usd_per_kwh",
                           "amortize_s"):
            v = getattr(self, field_name)
            if not math.isfinite(v) or v < 0:
                raise ValueError(f"{field_name}={v} must be finite and "
                                 f"non-negative")
        if self.amortize_s <= 0:
            raise ValueError(f"amortize_s={self.amortize_s} must be "
                             f"positive")

    def mem_usd(self, system_name: str) -> float:
        for prefix, usd in self.mem_usd_per_gib:
            if system_name.startswith(prefix):
                return usd
        raise ValueError(
            f"no $/GiB price for system {system_name!r}; add it to "
            f"CostSheet.mem_usd_per_gib (have "
            f"{[p for p, _ in self.mem_usd_per_gib]})")


DEFAULT_COSTS = CostSheet()

#: Systems (by Table-1 name prefix) whose bandwidth already comes from
#: stacked/on-package memory: on the compression axis of the decision
#: surface they keep the datasheet workload — compression competes with
#: their hardware, it does not stack onto it. Callers passing custom
#: bandwidth-rich specs through `systems=` must list them here (via
#: `cheapest_architecture(bandwidth_rich_prefixes=...)`), or they are
#: treated as capacity-optimized and priced compressed.
BANDWIDTH_RICH_PREFIXES = ("die-stacked", "h100")


def capex_usd(design: ClusterDesign, sheet: CostSheet = DEFAULT_COSTS
              ) -> float:
    """Cluster purchase price: deployed memory + chips + blades."""
    return (design.memory_capacity / GiB * sheet.mem_usd(design.system.name)
            + design.compute_chips * sheet.chip_usd
            + design.blades * sheet.blade_usd)


def usd_per_query(capex: float, response_time_s: float, energy_j: float,
                  sheet: CostSheet = DEFAULT_COSTS) -> float:
    """Amortized capex + energy opex for one query.

    The cluster serves back-to-back queries over the depreciation horizon
    (amortize_s / response_time queries), so each carries
    capex * rt / amortize_s of depreciation, plus its joules at $/kWh.
    """
    for name, v in (("capex", capex), ("response_time_s", response_time_s),
                    ("energy_j", energy_j)):
        if not math.isfinite(v) or v < 0:
            raise ValueError(f"{name}={v} must be finite and non-negative")
    if response_time_s == 0:
        raise ValueError("response_time_s=0: a query that takes no time "
                         "amortizes no capex; pass the attained latency")
    return (capex * response_time_s / sheet.amortize_s
            + energy_j / 3.6e6 * sheet.usd_per_kwh)


# --- candidates ------------------------------------------------------------

def evaluate_system(system: SystemSpec, workload: Workload, sla_s: float,
                    sheet: CostSheet = DEFAULT_COSTS) -> dict:
    """One Table-1 architecture, performance-provisioned for the SLA."""
    d = provision_performance(system, workload, sla_s)
    capex = capex_usd(d, sheet)
    return {
        "name": system.name,
        "chips": d.compute_chips,
        "cores_per_chip": d.cores_per_chip,
        "response_time_s": d.response_time,
        "power_w": d.power,
        "capex_usd": capex,
        "energy_per_query_j": d.energy_per_query,
        "usd_per_query": usd_per_query(capex, d.response_time,
                                       d.energy_per_query, sheet),
        "overprovision_x": d.overprovision_factor,
        "meets_sla": d.response_time <= sla_s * (1 + 1e-9),
    }


def evaluate_tiered(db_bytes: float, bytes_per_query: float, sla_s: float,
                    skew: float, sheet: CostSheet = DEFAULT_COSTS, *,
                    fast_gbps: float | None = None,
                    n_hot_items: int = 64,
                    fast_system: SystemSpec = DIE_STACKED,
                    capacity_system: SystemSpec = TRADITIONAL
                    ) -> dict | None:
    """The two-tier node (die-stacked over DDR) as a cost candidate.

    Searches the fast-tier fraction with core.advisor.advise_tier_split
    against the analytic zipf hit curve at `skew`, then prices each
    feasible fraction: the whole database in capacity-tier DRAM, the fast
    fraction duplicated into die-stacked stacks, chips sized by the
    blended rate. Returns the cheapest feasible fraction's candidate, or
    None when no fraction meets the SLA. With `fast_gbps` (the measured
    autotune rate) both tiers move to the measured scale — the capacity
    tier derated by the Table-1 bandwidth ratio — instead of Eq. 4
    datasheet rates.
    """
    from repro_torch.core.advisor import advise_tier_split
    from repro_torch.tier.tiers import table1_bandwidth_ratio
    from repro_torch.tier.trace import zipf_hit_curve

    if fast_gbps is not None:
        fast = fast_gbps
        cap = fast / table1_bandwidth_ratio(fast_system, capacity_system)
    else:
        fast = fast_system.chip_peak_perf / 1e9       # Eq. 4, not raw BW
        cap = capacity_system.chip_peak_perf / 1e9
    adv = advise_tier_split(
        db_bytes, bytes_per_query, sla_s,
        hit_curve=zipf_hit_curve(n_hot_items, skew),
        fast_gbps=fast, capacity_gbps=cap, fast_system=fast_system)

    best = None
    for row in adv["rows"]:
        if not row["within_roofline"]:
            # a blended rate above the datasheet Eq. 4 roofline means the
            # measured fast rate is mis-measured (advise_tier_split's
            # cross-check); pricing it would let a broken tune-cache
            # entry win the surface at an unattainable operating point.
            # The roofline also bounds per-chip rate by max cores x
            # core_perf, so the cores derivation below cannot truncate.
            continue
        chips = row["chips_for_sla"]
        rate = row["blended_gbps"] * 1e9 * chips / adv["chips"]
        rt = bytes_per_query / rate
        if rt > sla_s * (1 + 1e-9):
            continue
        f = row["fast_fraction"]
        # capacity tier holds the database; fast tier caches f of it
        mem_w = (db_bytes * capacity_system.module_power
                 / capacity_system.module_capacity
                 + f * db_bytes * fast_system.module_power
                 / fast_system.module_capacity)
        per_chip = rate / chips
        cores = max(1, min(fast_system.max_chip_cores,
                           math.ceil(per_chip / fast_system.core_perf)))
        blades = math.ceil(chips / fast_system.blade_chips)
        power = (mem_w + chips * cores * fast_system.core_power
                 + blades * fast_system.blade_overhead)
        capex = (db_bytes / GiB * sheet.mem_usd(capacity_system.name)
                 + f * db_bytes / GiB * sheet.mem_usd(fast_system.name)
                 + chips * sheet.chip_usd + blades * sheet.blade_usd)
        energy_j = power * rt
        cand = {
            "name": "tiered",
            "fast_fraction": f,
            "hit_rate": row["hit_rate"],
            "chips": chips,
            "cores_per_chip": cores,
            "response_time_s": rt,
            "power_w": power,
            "capex_usd": capex,
            "energy_per_query_j": energy_j,
            "usd_per_query": usd_per_query(capex, rt, energy_j, sheet),
            "blended_gbps": rate / 1e9,
            "measured_rates": fast_gbps is not None,
            "meets_sla": True,
        }
        if best is None or cand["usd_per_query"] < best["usd_per_query"]:
            best = cand
    return best


# --- the decision surface --------------------------------------------------

def cheapest_architecture(db_bytes: float, bytes_per_query: float,
                          sla_s: float, power_budget_w: float, *,
                          skew: float | None = None,
                          sheet: CostSheet = DEFAULT_COSTS,
                          systems: tuple[SystemSpec, ...] = (
                              TRADITIONAL, BIG_MEMORY, DIE_STACKED),
                          fast_gbps: float | None = None,
                          n_hot_items: int = 64,
                          compression_ratio: float = 1.0,
                          grouped_mix: float = 0.0,
                          grouped_bytes_per_query: float | None = None,
                          bandwidth_rich_prefixes: tuple[str, ...] =
                          BANDWIDTH_RICH_PREFIXES) -> dict:
    """One cell of the decision surface: every candidate provisioned for
    `sla_s`, power-infeasible ones excluded, cheapest $/query named.

    `skew=None` skips the tiered candidate (the pure Table-1 comparison);
    with a skew the two-tier node competes at the zipf hit curve's blended
    rate.

    `compression_ratio` r is the repro_torch.store logical/physical ratio,
    and
    it frames compression as the *software substitute for die-stacked
    bandwidth*: capacity-optimized candidates (traditional, big-memory)
    scan-over-compressed and so stream and store 1/r of the bytes, while
    the bandwidth-rich candidates — those whose name matches a
    `bandwidth_rich_prefixes` prefix (default: die-stacked and H100
    specs), plus the two-tier node — stay at the datasheet workload: they
    already bought their bandwidth in hardware. Compressing every
    candidate equally would leave the verdict scale-invariant; the
    interesting question is exactly whether a compressed traditional
    system now meets the SLA (and beats the $/query) that used to
    require HBM. Custom bandwidth-rich specs passed via `systems=` must
    be named in `bandwidth_rich_prefixes` or they are priced compressed.

    `grouped_mix` m blends in the relational slice of the workload:
    GroupBy/HashJoin queries touch key + value columns instead of a
    scan's predicate + aggregate set, so they stream
    `grouped_bytes_per_query` physical bytes (measure it with
    engine.bytes_scanned on a grouped trace; defaults to
    bytes_per_query). Every candidate is priced at the blended
    (1-m)*scan + m*grouped bytes — the axis that answers whether a
    rollup-heavy workload moves the die-stacking verdict.
    """
    if db_bytes <= 0 or bytes_per_query <= 0:
        raise ValueError(f"db_bytes={db_bytes} and bytes_per_query="
                         f"{bytes_per_query} must be positive")
    if not (0.0 <= grouped_mix <= 1.0):
        raise ValueError(f"grouped_mix={grouped_mix} must be a fraction "
                         f"in [0, 1] (the grouped share of the stream)")
    if grouped_bytes_per_query is not None and \
            grouped_bytes_per_query <= 0:
        raise ValueError(f"grouped_bytes_per_query="
                         f"{grouped_bytes_per_query} must be positive")
    if grouped_mix > 0.0:
        gb = (bytes_per_query if grouped_bytes_per_query is None
              else grouped_bytes_per_query)
        bytes_per_query = (1.0 - grouped_mix) * bytes_per_query \
            + grouped_mix * gb
    if not math.isfinite(sla_s) or sla_s <= 0:
        raise ValueError(f"sla_s={sla_s} must be a finite positive time")
    if not math.isfinite(power_budget_w) or power_budget_w <= 0:
        raise ValueError(f"power_budget_w={power_budget_w} must be a "
                         f"finite positive power")
    if not math.isfinite(compression_ratio) or compression_ratio < 1.0:
        raise ValueError(
            f"compression_ratio={compression_ratio} must be a finite "
            f"ratio >= 1.0 (logical/physical; the store's selector never "
            f"produces expansion)")
    wl = Workload(db_size=db_bytes,
                  percent_accessed=min(bytes_per_query / db_bytes, 1.0))
    wl_c = Workload(db_size=db_bytes / compression_ratio,
                    percent_accessed=wl.percent_accessed)
    cands = []
    for s in systems:
        compressed = not s.name.startswith(tuple(bandwidth_rich_prefixes))
        c = evaluate_system(s, wl_c if compressed else wl, sla_s, sheet)
        c["compressed"] = compressed and compression_ratio > 1.0
        cands.append(c)
    if skew is not None:
        t = evaluate_tiered(db_bytes, bytes_per_query, sla_s, skew, sheet,
                            fast_gbps=fast_gbps, n_hot_items=n_hot_items)
        if t is not None:
            t["compressed"] = False
            cands.append(t)
    for c in cands:
        c["within_power"] = c["power_w"] <= power_budget_w * (1 + 1e-9)
        c["feasible"] = c["meets_sla"] and c["within_power"]
    feasible = [c for c in cands if c["feasible"]]
    winner = min(feasible, key=lambda c: c["usd_per_query"], default=None)
    return {
        "sla_s": sla_s,
        "skew": skew,
        "power_budget_w": power_budget_w,
        "compression_ratio": compression_ratio,
        "grouped_mix": grouped_mix,
        "winner": winner and winner["name"],
        "usd_per_query": winner and winner["usd_per_query"],
        "candidates": cands,
    }


def decision_surface(db_bytes: float, bytes_per_query: float, *,
                     slas: tuple = (0.010, 0.060, 0.250, 1.0),
                     skews: tuple = (None, 0.6, 1.1),
                     power_budgets_w: tuple = (50e3, 250e3, 1e6),
                     sheet: CostSheet = DEFAULT_COSTS,
                     fast_gbps: float | None = None,
                     n_hot_items: int = 64,
                     compression_ratios: tuple = (1.0,),
                     grouped_mixes: tuple = (0.0,),
                     grouped_bytes_per_query: float | None = None) -> dict:
    """The paper's "when to use" question as a queryable grid: for every
    (SLA, skew, power budget, compression ratio, grouped mix) cell, the
    cheapest feasible architecture.

    Cells where nothing is feasible report winner=None — the honest
    answer the closed-form figures cannot give. The default budgets are
    the paper's Fig. 4 operating points (50 kW / 250 kW / 1 MW); the
    default ratio axis is the uncompressed store and the default grouped
    axis the pure-scan stream (one cell per old cell, so the surface is
    backward-compatible). Passing the measured repro_torch.store ratio
    alongside 1.0 shows which cells compression flips; passing grouped
    mixes with the measured `grouped_bytes_per_query` shows which cells a
    rollup/join-heavy stream flips.
    """
    cells = [
        cheapest_architecture(db_bytes, bytes_per_query, sla, budget,
                              skew=skew, sheet=sheet, fast_gbps=fast_gbps,
                              n_hot_items=n_hot_items,
                              compression_ratio=ratio, grouped_mix=mix,
                              grouped_bytes_per_query=grouped_bytes_per_query)
        for sla in slas for skew in skews for budget in power_budgets_w
        for ratio in compression_ratios for mix in grouped_mixes
    ]
    return {
        "db_bytes": db_bytes,
        "bytes_per_query": bytes_per_query,
        "slas": list(slas),
        "skews": list(skews),
        "power_budgets_w": list(power_budgets_w),
        "compression_ratios": list(compression_ratios),
        "grouped_mixes": list(grouped_mixes),
        "grouped_bytes_per_query": grouped_bytes_per_query,
        "fast_gbps": fast_gbps,
        "cells": cells,
    }


def compression_crossover_ratio(db_bytes: float, bytes_per_query: float,
                                sla_s: float, power_budget_w: float, *,
                                skew: float | None = None,
                                sheet: CostSheet = DEFAULT_COSTS,
                                fast_gbps: float | None = None,
                                n_hot_items: int = 64,
                                max_ratio: float = 64.0,
                                tol: float = 0.01) -> float | None:
    """The headline number compression adds to the paper's verdict: the
    smallest logical/physical ratio at which the *traditional*
    (capacity-optimized, bandwidth-poor) system becomes the cheapest
    feasible architecture for this (SLA, power) cell — i.e. how much the
    store must compress before die-stacking stops paying.

    Returns 1.0 when traditional already wins uncompressed, None when it
    still does not win at `max_ratio`. Bisects to `tol` assuming the win
    region is upward-closed in the ratio (shrinking bytes only ever helps
    the bandwidth-poor candidate)."""

    def traditional_wins(ratio: float) -> bool:
        cell = cheapest_architecture(
            db_bytes, bytes_per_query, sla_s, power_budget_w, skew=skew,
            sheet=sheet, fast_gbps=fast_gbps, n_hot_items=n_hot_items,
            compression_ratio=ratio)
        return (cell["winner"] is not None
                and cell["winner"].startswith("traditional"))

    if traditional_wins(1.0):
        return 1.0
    if not traditional_wins(max_ratio):
        return None
    lo, hi = 1.0, max_ratio
    while hi - lo > tol:
        mid = (lo + hi) / 2
        if traditional_wins(mid):
            hi = mid
        else:
            lo = mid
    return hi
