"""The paper's three provisioning regimes (§5.1-§5.3).

Each returns a `ClusterDesign`; the claims in the paper's figures fall out of
the designs' derived properties (tests/test_torch_paper_model.py holds the
port to every claim of tests/test_paper_claims.py).
"""
from __future__ import annotations

import math

from repro_torch.core.model import (ClusterDesign, Workload,
                                    capacity_chips, cores_for_throughput)
from repro_torch.core.systems import SystemSpec


def provision_capacity(system: SystemSpec, workload: Workload,
                       capacity: float | None = None) -> ClusterDesign:
    """§5.3: size the cluster to hold `capacity` (default: the database).

    Chips run every core their memory bandwidth can feed (Eq. 4/5 at full
    tilt) — the query is raced to completion.
    """
    wl = workload if capacity is None else Workload(capacity,
                                                    workload.bytes_accessed / capacity)
    chips = capacity_chips(system, wl)
    return ClusterDesign(system, wl, chips, system.saturating_cores)


def provision_performance(system: SystemSpec, workload: Workload,
                          sla: float) -> ClusterDesign:
    """§5.1: size the cluster to answer a query within `sla` seconds.

    The cluster must (a) hold the database and (b) supply
    bytes_accessed / sla of aggregate throughput; whichever needs more chips
    wins. Memory over-provisioning (paper Fig. 3, right) is the byproduct of
    (b) > (a) for low-bandwidth-ratio systems.
    """
    required_bw = workload.bytes_accessed / sla
    chips_bw = math.ceil(required_bw / system.chip_peak_perf)
    chips = max(chips_bw, capacity_chips(system, workload))
    cores = cores_for_throughput(system, required_bw, chips)
    return ClusterDesign(system, workload, chips, cores)


def provision_power(system: SystemSpec, workload: Workload,
                    budget: float) -> ClusterDesign:
    """§5.2: deploy as much cluster as `budget` watts allows.

    Blades are first assumed fully populated (all cores); if even the
    capacity-required blades' memory+overhead cannot fit the budget with one
    core per chip, cores per chip are cut (the paper's 50 kW die-stacked
    cluster runs 1 core/chip).
    """
    full_cores = system.max_chip_cores
    chip_full_power = (system.modules_per_chip * system.module_power
                       + full_cores * system.core_power)
    blade_full_power = (system.blade_chips * chip_full_power
                        + system.blade_overhead)
    cap_chips = capacity_chips(system, workload)
    cap_blades = math.ceil(cap_chips / system.blade_chips)

    blades_affordable = int(budget // blade_full_power)
    if blades_affordable >= cap_blades:
        # budget allows >= the capacity-required cluster, fully populated;
        # extra blades add bandwidth (and over-provisioned capacity).
        blades = max(1, blades_affordable)
        chips = blades * system.blade_chips
        return ClusterDesign(system, workload, chips, full_cores)

    # Budget can't fully populate the capacity-required cluster: keep the
    # capacity (the workload must fit) and spend what's left on cores.
    chips = cap_chips
    fixed = (chips * system.modules_per_chip * system.module_power
             + cap_blades * system.blade_overhead)
    remaining = budget - fixed
    cores = int(remaining // (system.core_power * chips))
    cores = max(1, min(full_cores, cores))
    return ClusterDesign(system, workload, chips, cores)


def power_crossover_sla(system_a: SystemSpec, system_b: SystemSpec,
                        workload: Workload, lo: float = 1e-3,
                        hi: float = 10.0, steps: int = 4000) -> float | None:
    """SLA at which performance-provisioned power of a and b cross
    (paper §5.1: ~60 ms for traditional vs die-stacked; ~170 ms at 50%
    accessed; ~800 ms with 8x-denser die-stacks).

    Scans log-spaced SLAs and returns the first sign change (None if the
    curves never cross in [lo, hi]).
    """
    prev = None
    prev_t = None
    for i in range(steps):
        t = lo * (hi / lo) ** (i / (steps - 1))
        diff = (provision_performance(system_a, workload, t).power
                - provision_performance(system_b, workload, t).power)
        if prev is not None and diff == 0:
            return t
        if prev is not None and (diff < 0) != (prev < 0):
            # linear interpolation in log-t between the two samples
            return math.sqrt(t * prev_t)
        prev, prev_t = diff, t
    return None
