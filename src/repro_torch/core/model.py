"""The paper's analytical model: Equations 1-10 (Lowe-Power et al., BPOE'16).

A `ClusterDesign` is a fully-specified cluster: a system architecture, a
workload, a number of compute chips, and cores enabled per chip. All of the
paper's outputs (response time, power, energy, capacity, over-provisioning)
are derived properties. The three provisioning regimes in
`repro_torch.core.provisioning` construct `ClusterDesign`s under different
constraints.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.systems import SystemSpec, TiB


@dataclass(frozen=True)
class Workload:
    """Workload-dependent model inputs (paper §4)."""

    db_size: float = 16 * TiB       # bytes that must reside in memory
    percent_accessed: float = 0.20  # fraction touched per query (complexity)

    @property
    def bytes_accessed(self) -> float:
        return self.db_size * self.percent_accessed


@dataclass(frozen=True)
class ClusterDesign:
    system: SystemSpec
    workload: Workload
    compute_chips: int
    cores_per_chip: int

    def __post_init__(self):
        if self.compute_chips < 1:
            raise ValueError("cluster needs at least one chip")
        if not 1 <= self.cores_per_chip <= self.system.max_chip_cores:
            raise ValueError(
                f"cores_per_chip {self.cores_per_chip} outside "
                f"[1, {self.system.max_chip_cores}]")

    # --- structure --------------------------------------------------------
    @property
    def mem_modules(self) -> int:
        """Eq. 1 (applied to the deployed cluster)."""
        return self.compute_chips * self.system.modules_per_chip

    @property
    def blades(self) -> int:
        """Eq. 8."""
        return math.ceil(self.compute_chips / self.system.blade_chips)

    @property
    def memory_capacity(self) -> float:
        return self.mem_modules * self.system.module_capacity

    @property
    def overprovision_factor(self) -> float:
        """Deployed memory vs what the workload needs (paper §5.1)."""
        return self.memory_capacity / self.workload.db_size

    # --- performance ------------------------------------------------------
    @property
    def chip_perf(self) -> float:
        """Eq. 4 with the *enabled* cores."""
        return min(self.cores_per_chip * self.system.core_perf,
                   self.system.chip_bandwidth)

    @property
    def cluster_perf(self) -> float:
        return self.chip_perf * self.compute_chips

    @property
    def aggregate_bandwidth(self) -> float:
        """Raw memory bandwidth (paper §5.3 quotes this, not Eq. 4)."""
        return self.system.chip_bandwidth * self.compute_chips

    @property
    def response_time(self) -> float:
        """Eq. 9 (seconds per query)."""
        return self.workload.bytes_accessed / self.cluster_perf

    # --- power / energy ---------------------------------------------------
    @property
    def mem_power(self) -> float:
        """Eq. 6."""
        return self.mem_modules * self.system.module_power

    @property
    def compute_power(self) -> float:
        """Eq. 7."""
        return self.cores_per_chip * self.system.core_power * self.compute_chips

    @property
    def overhead_power(self) -> float:
        return self.blades * self.system.blade_overhead

    @property
    def power(self) -> float:
        """Eq. 10."""
        return self.mem_power + self.compute_power + self.overhead_power

    @property
    def energy_per_query(self) -> float:
        """Joules per query (paper Fig. 6a): power x response time."""
        return self.power * self.response_time

    # --- feasibility ------------------------------------------------------
    @property
    def holds_workload(self) -> bool:
        return self.memory_capacity >= self.workload.db_size

    def summary(self) -> dict:
        return {
            "system": self.system.name,
            "chips": self.compute_chips,
            "cores_per_chip": self.cores_per_chip,
            "blades": self.blades,
            "mem_modules": self.mem_modules,
            "capacity_TiB": self.memory_capacity / TiB,
            "overprovision_x": self.overprovision_factor,
            "agg_bandwidth_TBps": self.aggregate_bandwidth / 1e12,
            "cluster_perf_TBps": self.cluster_perf / 1e12,
            "response_time_ms": self.response_time * 1e3,
            "power_kW": self.power / 1e3,
            "mem_power_kW": self.mem_power / 1e3,
            "compute_power_kW": self.compute_power / 1e3,
            "overhead_power_kW": self.overhead_power / 1e3,
            "energy_per_query_J": self.energy_per_query,
        }


def capacity_chips(system: SystemSpec, workload: Workload) -> int:
    """Eqs. 1-2: chips needed just to hold the database in memory."""
    modules = math.ceil(workload.db_size / system.module_capacity)
    return max(1, math.ceil(modules / system.modules_per_chip))


def cores_for_throughput(system: SystemSpec, required_bw: float,
                         chips: int) -> int:
    """Eq. 5: cores per chip sized to the *required* per-chip throughput.

    This (not always-max cores) is what produces the paper's 60 ms power
    crossover: at relaxed SLAs the die-stacked system powers few cores.
    """
    per_chip = required_bw / chips
    return max(1, min(system.max_chip_cores,
                      math.ceil(per_chip / system.core_perf)))
