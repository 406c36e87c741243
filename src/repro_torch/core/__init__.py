"""Core contribution of the paper on the port: bandwidth-capacity
provisioning (counterpart of repro.core).

- `systems` / `model` / `provisioning`: the paper's analytical model
  (Eqs. 1-10), its three provisioning regimes, Table 1, and the H100
  datasheet row (`H100_SXM`, `as_paper_system`).
- `traffic` / `roofline`: the analytic per-chip traffic model and the
  three-term roofline that generalize the model to sharded LM steps.
- `advisor`: the paper's "when to use" question answered for accelerator
  clusters and for the query engine's measured scans.
- `sweep`: the model vectorized and differentiable on torch tensors.
"""
from repro_torch.core.model import ClusterDesign, Workload, capacity_chips
from repro_torch.core.provisioning import (power_crossover_sla,
                                           provision_capacity,
                                           provision_performance,
                                           provision_power)
from repro_torch.core.systems import (BIG_MEMORY, DIE_STACKED, GB, GiB,
                                      H100_SXM, KB, KiB, MB, MiB,
                                      PAPER_SYSTEMS, PB, PiB, TB,
                                      TRADITIONAL, AcceleratorSpec,
                                      SystemSpec, TiB, as_paper_system)

__all__ = [
    "ClusterDesign", "Workload", "capacity_chips",
    "provision_capacity", "provision_performance", "provision_power",
    "power_crossover_sla",
    "KB", "MB", "GB", "TB", "PB", "KiB", "MiB", "GiB", "TiB", "PiB",
    "SystemSpec", "AcceleratorSpec", "TRADITIONAL", "BIG_MEMORY",
    "DIE_STACKED", "PAPER_SYSTEMS", "H100_SXM", "as_paper_system",
]
