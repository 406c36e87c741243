"""Tier datasheets: the paper's Table 1 systems as *memory tiers*
(counterpart of repro/tier/tiers.py; plain Python, no device work).

The paper asks when a die-stacked (bandwidth-rich, capacity-poor) node
beats a traditional (capacity-rich, bandwidth-poor) one for a whole
cluster. A tiered node holds both at once: a fast HBM-like tier and a DDR
capacity tier behind it, and the placement engine
(repro_torch.tier.placement)
decides which column chunks live where. This module derives the two
`TierSpec`s from `core.systems.SystemSpec` datasheets so every number —
bandwidth, capacity, per-byte energy, and the fast:capacity bandwidth
ratio — traces back to Table 1, and `TieredBudget` enforces the one hard
constraint that makes the problem interesting: the fast tier does not fit
the database.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from repro_torch.core.systems import DIE_STACKED, TRADITIONAL, SystemSpec
from repro_torch.serve.sla import blended_bps


@dataclass(frozen=True)
class TierSpec:
    """One memory tier of a placement domain.

    Units are deliberately asymmetric, mirroring how a tiered cluster
    works: `bandwidth` is per chip (shards stream their chunks in
    parallel, so callers scale it by the chip count — see
    TierPair.service_s), while `capacity` is the tier's total resident
    bytes across the whole placement domain — one node's stack for a flat
    table, the cluster-aggregate fast tier for a sharded one (placement
    is a single global decision either way). On one card a sharded
    table's shards are virtual (repro_torch.query.sharded), yet each
    counts as a chip here, as the reference counts them, so the ledgers
    stay the reference's.
    """

    name: str
    bandwidth: float            # bytes/s one chip streams from this tier
    capacity: float             # bytes resident across the placement domain
    energy_per_byte: float      # J/byte of streamed access

    def __post_init__(self):
        if self.bandwidth <= 0:
            raise ValueError(f"tier {self.name!r}: bandwidth "
                             f"{self.bandwidth} must be positive")
        if self.capacity < 0:
            raise ValueError(f"tier {self.name!r}: capacity "
                             f"{self.capacity} must be non-negative")

    @property
    def gbps(self) -> float:
        return self.bandwidth / 1e9

    def with_bandwidth(self, bandwidth: float) -> "TierSpec":
        """Same tier calibrated to a measured (not datasheet) rate."""
        return dataclasses.replace(self, bandwidth=bandwidth)

    def as_system(self, cores: int = 32) -> SystemSpec:
        """Express the tier in the paper's Table-1 vocabulary so Eq. 4
        applies unchanged: one module, one channel, cores sized so the
        chip is exactly bandwidth-bound (core_perf * cores == bandwidth),
        the paper's scan regime."""
        return SystemSpec(
            name=f"{self.name}-as-system",
            module_capacity=max(self.capacity, 1.0),
            channel_bandwidth=self.bandwidth,
            memory_channels=1,
            channel_modules=1,
            module_power=self.energy_per_byte * self.bandwidth,
            blade_chips=1,
            core_perf=self.bandwidth / cores,
            max_chip_cores=cores,
        )


def tier_from_system(system: SystemSpec, capacity: float | None = None,
                     bandwidth: float | None = None) -> TierSpec:
    """A Table-1 column as a tier: chip-level bandwidth, capacity
    defaulting to one chip's attached memory (override with the placement
    domain's real budget — e.g. a fraction of the table, times the shard
    count for a sharded cluster), and per-byte energy = module power /
    streamed bandwidth."""
    bw = system.chip_bandwidth if bandwidth is None else bandwidth
    return TierSpec(
        name=system.name,
        bandwidth=bw,
        capacity=system.chip_capacity if capacity is None else capacity,
        energy_per_byte=(system.modules_per_chip * system.module_power)
        / system.chip_bandwidth)


def table1_bandwidth_ratio(fast: SystemSpec = DIE_STACKED,
                           capacity: SystemSpec = TRADITIONAL) -> float:
    """Fast:capacity per-chip bandwidth ratio from Table 1 (2.5x for
    die-stacked vs traditional); derates the capacity tier when the fast
    tier's rate comes from a measured sweep instead of the datasheet."""
    return fast.chip_bandwidth / capacity.chip_bandwidth


@dataclass(frozen=True)
class TierPair:
    """The two-tier memory system one chip scans against."""

    fast: TierSpec
    capacity: TierSpec

    def blended(self, fast_fraction: float, chips: int = 1) -> float:
        """Effective bytes/s when `fast_fraction` of streamed bytes come
        from the fast tier (harmonic blend, Amdahl on bandwidth)."""
        return blended_bps(self.fast.bandwidth, self.capacity.bandwidth,
                           fast_fraction) * chips

    def service_s(self, fast_bytes: float, capacity_bytes: float,
                  chips: int = 1) -> float:
        """Seconds to stream a byte split, each tier at its own rate."""
        return (fast_bytes / (self.fast.bandwidth * chips)
                + capacity_bytes / (self.capacity.bandwidth * chips))

    def energy_components(self, fast_bytes: float, capacity_bytes: float
                          ) -> tuple[float, float]:
        """(fast_j, capacity_j) of a byte split — the one place the
        per-tier pricing formula lives (the EnergyMeter ledger and
        energy_j both build on it)."""
        for name, b in (("fast_bytes", fast_bytes),
                        ("capacity_bytes", capacity_bytes)):
            if not math.isfinite(b) or b < 0:
                raise ValueError(
                    f"{name}={b} must be a finite non-negative byte count; "
                    f"energy charges from broken byte accounting would "
                    f"silently poison the meter's ledger")
        return (fast_bytes * self.fast.energy_per_byte,
                capacity_bytes * self.capacity.energy_per_byte)

    def energy_j(self, fast_bytes: float, capacity_bytes: float) -> float:
        fast_j, capacity_j = self.energy_components(fast_bytes,
                                                    capacity_bytes)
        return fast_j + capacity_j


def paper_tiers(fast_capacity: float, *, fast_gbps: float | None = None,
                fast_system: SystemSpec = DIE_STACKED,
                capacity_system: SystemSpec = TRADITIONAL) -> TierPair:
    """The paper's two-tier node: die-stacked fast tier (capacity capped
    at `fast_capacity` bytes) over a traditional DDR capacity tier.

    With `fast_gbps` (e.g. from the autotuned kernel sweep,
    `measured_fast_gbps`) the fast tier runs at the measured rate and the
    capacity tier is derated by the Table 1 bandwidth ratio, so model and
    measurement stay on one scale.
    """
    if fast_capacity <= 0:
        raise ValueError(f"fast_capacity={fast_capacity} must be positive; "
                         f"a zero fast tier is the flat-memory engine")
    ratio = table1_bandwidth_ratio(fast_system, capacity_system)
    fast_bw = fast_gbps * 1e9 if fast_gbps is not None else None
    fast = tier_from_system(fast_system, capacity=fast_capacity,
                            bandwidth=fast_bw)
    cap_bw = fast.bandwidth / ratio
    cap = tier_from_system(capacity_system, bandwidth=cap_bw)
    return TierPair(fast=fast, capacity=cap)


def measured_fast_gbps(default: float | None = None) -> float | None:
    """Best attained scan rate in the autotune cache
    (repro_torch.kernels.tune): the fast tier priced from the measured
    sweep, not the datasheet.

    Scans `scan_filter`/`scan_aggregate` entries for the current backend
    (`tune.backend()`: the card when there is one); bytes per call are
    recovered from the `rows=` shape key (rows of (rows, LANES)
    int32 word planes, the reference's tiling) times the number of input
    planes the op streams — scan_filter reads one packed array, the fused
    scan_aggregate reads three (pred, agg, valid) — so the two ops'
    attained GB/s are commensurate, and the same cache entries give the
    reference's rate. Returns `default` when nothing has been tuned yet.
    """
    from repro_torch.kernels import tune
    from repro_torch.kernels.aggregate.ops import LANES

    streamed_planes = {"scan_filter": 1, "scan_aggregate": 3}
    backend = tune.backend()
    best = None
    for key, entry in tune.get_cache().entries().items():
        parts = key.split("|")
        if len(parts) != 3 or parts[1] != backend:
            continue
        if parts[0] not in streamed_planes:
            continue
        dims = dict(kv.split("=") for kv in parts[2].split(","))
        us = entry.get("us")
        if "rows" not in dims or not us:
            continue
        nbytes = streamed_planes[parts[0]] * int(dims["rows"]) * LANES * 4
        gbps = nbytes / (us * 1e-6) / 1e9
        best = gbps if best is None else max(best, gbps)
    return best if best is not None else default


class TieredBudget:
    """Fast-tier byte budget the placement engine allocates against.

    The single invariant of the subsystem: resident fast-tier bytes never
    exceed `fast_capacity`. Policies must free (evict) before they alloc
    (admit); over-allocation raises instead of silently overflowing the
    stack.
    """

    def __init__(self, fast_capacity: float):
        if fast_capacity <= 0:
            raise ValueError(
                f"fast_capacity={fast_capacity} must be positive")
        self.fast_capacity = float(fast_capacity)
        self.used = 0.0

    @property
    def remaining(self) -> float:
        return self.fast_capacity - self.used

    def fits(self, nbytes: float) -> bool:
        return nbytes <= self.remaining

    def alloc(self, nbytes: float) -> None:
        if not self.fits(nbytes):
            raise ValueError(
                f"fast-tier overflow: alloc {nbytes} with "
                f"{self.remaining:.0f} of {self.fast_capacity:.0f} free; "
                f"evict before admitting")
        self.used += nbytes

    def free(self, nbytes: float) -> None:
        self.used = max(0.0, self.used - nbytes)
