"""Energy on the port: the paper's power axis beside the performance one
(counterpart of repro.energy).

- `meter`:  EnergyMeter — a per-query/per-tenant joules ledger charging
            bytes-moved-per-tier plus compute-power x modeled busy time.
- `caps`:   PowerCap — a sliding-window watt governor that derates
            effective bandwidth (stretches modeled service) so no window
            ever averages above budget, and feeds the derated estimate
            back into EDF admission.
- `tco`:    CostSheet / usd_per_query / decision_surface — capex + metered
            opex per query, and the SLA x skew x power-budget grid naming
            the cheapest architecture per cell.
"""
from repro_torch.energy.caps import PowerCap
from repro_torch.energy.meter import (EnergyCharge, EnergyMeter,
                                      chip_compute_watts)
from repro_torch.energy.tco import (DEFAULT_COSTS, CostSheet, capex_usd,
                                    cheapest_architecture,
                                    compression_crossover_ratio,
                                    decision_surface, evaluate_system,
                                    evaluate_tiered, usd_per_query)

__all__ = [
    "EnergyMeter", "EnergyCharge", "chip_compute_watts",
    "PowerCap",
    "CostSheet", "DEFAULT_COSTS", "capex_usd", "usd_per_query",
    "evaluate_system", "evaluate_tiered", "cheapest_architecture",
    "decision_surface", "compression_crossover_ratio",
]
