"""Where the port's entry points put their tensors.

Entry points (Table.synthetic, BitPackedColumn.from_values,
table_from_arrays, QueryEngine) run on the card unless the caller asks
for the CPU; with no CUDA device they raise instead of carrying on
quietly on the host.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA device when it is None. Raises RuntimeError
    when the default is asked for and no CUDA device exists."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch path on the host")
    return torch.device("cuda", torch.cuda.current_device())
