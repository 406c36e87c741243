"""Meshes of the port: named axes of virtual shards on one device
(counterpart of repro/launch/mesh.py's `make_mesh`).

On one card the shards of a sharded table are not separate chips: every
mesh position maps onto the same device, and a table sharded over an
axis holds its shards as the leading batch axis of the batched kernels
(repro_torch.query.sharded). A mesh over more than one distinct device is
ROADMAP.md's queue-1 item 5b (a shard per card over torch.distributed).
The reference's 256-chip training mesh (`make_production_mesh`) comes
with the training stack, queue-1 step 10.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device


class Mesh:
    """Named axes over one device: `shape` maps axis -> size, `axes` keeps
    their order, `device` is where every position lives."""

    def __init__(self, shape, axes, device: torch.device):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                             f"length")
        if len(set(axes)) != len(axes):
            raise ValueError(f"mesh axes {axes} repeat a name")
        if any(n < 1 for n in shape):
            raise ValueError(f"mesh shape {shape} has an empty axis")
        self.axes = axes
        self.shape = dict(zip(axes, shape))
        # with its index, as the tensors' own .device reads
        self.device = torch.empty(0, device=device).device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of virtual shards for tests and examples. `device` is one
    device (the CUDA device unless the caller passes one), or a sequence
    of them, one a position, which must all be the same device."""
    if isinstance(device, (list, tuple)):
        distinct = {torch.device(d) for d in device}
        if len(distinct) > 1:
            raise NotImplementedError(
                f"a mesh over {len(distinct)} devices is not ported: every "
                f"position of the port's mesh lives on one device; a shard "
                f"per card over torch.distributed is ROADMAP.md, 'Modules "
                f"to port', item 5b")
        device = next(iter(distinct)) if distinct else None
    return Mesh(shape, axes, resolve_device(device))
