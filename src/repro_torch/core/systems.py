"""System datasheets for the paper's analytical model: Table 1
(counterpart of the first part of repro/core/systems.py).

Unit conventions (recovered from the paper's numbers): capacities are
*binary* (GiB/TiB), bandwidths are *decimal* (GB/s). Using these
conventions the paper's 256x / 60x capacity-provisioned speedups are
reproduced exactly.

Only Table 1 is here: the tier and energy layers price their memory and
compute terms from it. The reference's TPU datasheet rows and the
analytical model come with the paper model (ROADMAP.md, 'Modules to
port', step 7), which brings an H100 row in their place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# --- unit constants -------------------------------------------------------
KB, MB, GB, TB, PB = 1e3, 1e6, 1e9, 1e12, 1e15          # decimal (bandwidth)
KiB, MiB, GiB, TiB, PiB = 2.0**10, 2.0**20, 2.0**30, 2.0**40, 2.0**50  # binary


@dataclass(frozen=True)
class SystemSpec:
    """One column of the paper's Table 1.

    A *module* is the minimum unit of memory that can be added: a DIMM
    (traditional), a buffer-on-board + its DIMMs (big-memory), or one HBM
    stack (die-stacked).
    """

    name: str
    module_capacity: float      # bytes per memory module (binary units)
    channel_bandwidth: float    # bytes/s per memory channel (decimal units)
    memory_channels: int        # channels per compute chip
    channel_modules: int        # modules per channel
    module_power: float         # W per module
    blade_chips: int            # compute chips per blade
    # shared inputs (Table 1, bottom)
    core_perf: float = 6 * GB   # bytes/s of scan throughput per core
    core_power: float = 3.0     # W per core
    max_chip_cores: int = 32    # cores per compute chip (max)
    blade_overhead: float = 100.0  # W of peripherals per blade (paper §6.1)

    # --- derived chip-level quantities (paper §3) -------------------------
    @property
    def modules_per_chip(self) -> int:
        return self.memory_channels * self.channel_modules

    @property
    def chip_capacity(self) -> float:
        """Bytes of memory attached to one compute chip."""
        return self.modules_per_chip * self.module_capacity

    @property
    def chip_bandwidth(self) -> float:
        """Eq. 3: peak memory bandwidth of one compute chip (bytes/s)."""
        return self.memory_channels * self.channel_bandwidth

    @property
    def chip_peak_perf(self) -> float:
        """Eq. 4: min(compute-limited, bandwidth-limited) chip throughput."""
        return min(self.core_perf * self.max_chip_cores, self.chip_bandwidth)

    @property
    def saturating_cores(self) -> int:
        """Eq. 5 at full tilt: cores needed to saturate the chip."""
        import math

        return min(self.max_chip_cores,
                   math.ceil(self.chip_bandwidth / self.core_perf))

    @property
    def bandwidth_capacity_ratio(self) -> float:
        """Fraction of attached memory one chip can stream per second (1/s).

        The paper's Figure 1 metric; uses raw channel bandwidth (not the
        compute-capped Eq. 4 rate), matching the 80x / 341x claims.
        """
        return self.chip_bandwidth / self.chip_capacity

    def with_density(self, factor: float) -> "SystemSpec":
        """Denser DRAM chips (paper §6.1): same bandwidth/power per module,
        `factor`x the capacity per module."""
        return dataclasses.replace(
            self, name=f"{self.name}-x{factor:g}density",
            module_capacity=self.module_capacity * factor)

    def with_compute_power(self, factor: float) -> "SystemSpec":
        """Scaled per-core power (paper §6.1 asks about 10x lower)."""
        return dataclasses.replace(
            self, name=f"{self.name}-x{factor:g}corepower",
            core_power=self.core_power * factor)


# --- the paper's three systems (Table 1) ----------------------------------

TRADITIONAL = SystemSpec(
    name="traditional",          # Dell PowerEdge R930-like, Xeon E7 v3
    module_capacity=32 * GiB,    # DDR4 DIMM
    channel_bandwidth=25.6 * GB,
    memory_channels=4,
    channel_modules=2,           # 2 DIMMs/channel for full DDR bandwidth
    module_power=8.0,
    blade_chips=4,
)

BIG_MEMORY = SystemSpec(
    name="big-memory",           # Oracle SPARC M7-like appliance
    module_capacity=512 * GiB,   # buffer-on-board + 8 DIMMs = one module
    channel_bandwidth=48 * GB,
    memory_channels=4,
    channel_modules=1,
    module_power=100.0,
    blade_chips=1,
)

DIE_STACKED = SystemSpec(
    name="die-stacked",          # HBM 2.0 stack on compute (nanostore-like)
    module_capacity=8 * GiB,     # 8-high stack of 8 Gbit chips
    channel_bandwidth=256 * GB,  # HBM 2.0 per stack
    memory_channels=1,
    channel_modules=1,
    module_power=10.0,
    blade_chips=9,
)

PAPER_SYSTEMS = (TRADITIONAL, BIG_MEMORY, DIE_STACKED)
