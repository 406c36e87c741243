"""The paper's Table 1 on the port (counterpart of repro.core's
`systems`).

- `systems`: the unit constants, `SystemSpec` and the paper's three
  systems (traditional, big-memory, die-stacked), which the tier and
  energy layers price from.

The analytical model (`model`, `provisioning`, `advisor`) and an H100
datasheet row are ROADMAP.md's step 7.
"""
from repro_torch.core.systems import (BIG_MEMORY, DIE_STACKED, GB, GiB, KB,
                                      KiB, MB, MiB, PAPER_SYSTEMS, PB, PiB,
                                      TB, TRADITIONAL, SystemSpec, TiB)

__all__ = [
    "KB", "MB", "GB", "TB", "PB", "KiB", "MiB", "GiB", "TiB", "PiB",
    "SystemSpec", "TRADITIONAL", "BIG_MEMORY", "DIE_STACKED",
    "PAPER_SYSTEMS",
]
