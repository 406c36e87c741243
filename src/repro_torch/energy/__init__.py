"""Energy on the port: the paper's power axis beside the performance one
(counterpart of repro.energy's meter and caps).

- `meter`:  EnergyMeter — a per-query/per-tenant joules ledger charging
            bytes-moved-per-tier plus compute-power x modeled busy time.
- `caps`:   PowerCap — a sliding-window watt governor that derates
            effective bandwidth (stretches modeled service) so no window
            ever averages above budget, and feeds the derated estimate
            back into EDF admission.

`tco` ($/query and the decision surface) imports the paper model, so it
comes with ROADMAP.md's step 7.
"""
from repro_torch.energy.caps import PowerCap
from repro_torch.energy.meter import (EnergyCharge, EnergyMeter,
                                      chip_compute_watts)

__all__ = ["EnergyMeter", "EnergyCharge", "chip_compute_watts", "PowerCap"]
