"""Meshes of the port (counterpart of repro/launch/mesh.py's `make_mesh`
and `make_production_mesh`), in two forms.

Virtual positions on one device (`make_mesh(shape, axes)`): the positions
of a mesh are not separate chips, every one maps onto the same device. A
table sharded over an axis holds its shards as the leading batch axis of
the batched kernels (repro_torch.query.sharded); a model or train state
sharded by logical axes (repro_torch.dist.sharding) stays whole on the
device, and its NamedShardings record what each position would hold. The
production meshes are the reference's shapes, (16, 16) over ("data",
"model") and (2, 16, 16) with a leading "pod", as virtual positions on
one device.

Ranks of a process group (`make_mesh(shape, axes, group=...)`, a
`RankMesh`): one position a rank, each on its own device (or ranks that
share a card under gloo; repro_torch.dist.world), numbered in row-major
order as jax.make_mesh orders jax.devices(), with one subgroup an axis
for the collectives along it. A sharded table keeps a shard a rank and
combines over the axis's subgroup; the compressed psum reduces over the
"pod" subgroups. Train state is split: under a NamedSharding a rank
holds the block of each leaf that its coordinates select
(`block_index`; repro_torch.dist.sharding.local_block), checkpoints
gather on save and restore a block a rank, and GPipe runs a stage a rank
over send/recv. The train and serve steps
(repro_torch.launch.specs.build_train / build_prefill / build_serve)
hold the parameters (and caches) split and compute tensor- and
expert-parallel over "model", gathering a parameter over "data"/"pod" at
its use; the train step reduces the gradients over the batch's axes
(repro_torch.train.step). A ring split over its slots decodes split-K
and q's rows split over the cp strategy's axes attend as context
parallelism (repro_torch.models.attention).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import world


class Mesh:
    """Named axes over one device: `shape` maps axis -> size, `axes` (and
    `axis_names`, as the reference's meshes read) keeps their order,
    `device` is where every position lives."""

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
    def axis_names(self) -> tuple:
        return self.axes

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def device_set(self) -> set:
        """The distinct devices of the positions: always one."""
        return {self.device}

    group = None                    # a RankMesh's process group

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _line_groups(dims, members, backend) -> list:
    """(axis index, line of positions, group) for every subgroup of a
    mesh of `dims` over `members` (ranks of the default group), made in
    one order: torch.distributed.new_group needs every rank of the
    default group, members of the line or not."""
    import torch.distributed as dist
    grid = np.arange(len(members)).reshape(dims)
    return [(i, line, dist.new_group([members[r] for r in line],
                                     backend=backend))
            for i in range(len(dims))
            for line in np.moveaxis(grid, i, -1).reshape(-1, dims[i])]


class RankMesh(Mesh):
    """Named axes over the ranks of a process group, one position a rank.
    `shape` and `size` are global; `device` is this rank's, `rank` its
    rank in `group` and `coords` its position (axis -> index).
    `axis_group(axis)` is the subgroup of the ranks that differ from this
    one only along `axis`, in coordinate order."""

    def __init__(self, shape, axes, group, device: torch.device):
        import torch.distributed as dist
        super().__init__(shape, axes, device)
        n = dist.get_world_size(group)
        if self.size != n:
            raise ValueError(f"a mesh of shape {tuple(shape)} has "
                             f"{self.size} positions, the group {n} ranks")
        self.group = group
        self.rank = dist.get_rank(group)
        dims = tuple(self.shape.values())
        self.coords = {a: int(c) for a, c in
                       zip(self.axes, np.unravel_index(self.rank, dims))}
        self._groups = {}
        for i, line, sub in _line_groups(
                dims, dist.get_process_group_ranks(group),
                dist.get_backend(group)):
            if self.rank in line:
                self._groups[self.axes[i]] = sub

    def axis_group(self, axis: str):
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}; axes are "
                             f"{self.axes}")
        return self._groups[axis]

    def axis_ranks(self, axis: str) -> list:
        """The default group's ranks of axis_group(axis), in coordinate
        order (what point-to-point calls name as peers)."""
        import torch.distributed as dist
        return dist.get_process_group_ranks(self.axis_group(axis))

    def block_index(self, axes) -> int:
        """This rank's block along a dim split over `axes` (a spec
        entry's axes, in order): its coordinates row-major over them."""
        index = 0
        for a in axes:
            index = index * self.shape[a] + self.coords[a]
        return index

    def __repr__(self) -> str:
        return (f"RankMesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device})")


def make_mesh(shape, axes, device=None, *, group=None, members=None):
    """A mesh of virtual shards, or with `group` (a torch.distributed
    process group, e.g. torch.distributed.group.WORLD) a RankMesh over
    its ranks, which every rank of the default group calls alike. With
    `members` (ranks of the default group) instead, every rank of the
    default group calls it alike too: it makes the members' group and
    the mesh's subgroups, and returns the RankMesh on the members and
    None on the other ranks.

    Virtual: `device` is one device (the CUDA device unless the caller
    passes one), or a sequence of them, one a position, which must all
    be the same device. Ranks: `device` is this rank's device (by default
    the one repro_torch.dist.world.init gave it)."""
    if members is not None:
        import torch.distributed as dist
        members = list(members)
        if group is not None or math.prod(shape) != len(members):
            raise ValueError(f"a mesh of shape {tuple(shape)} over members "
                             f"{members} (and no group)")
        backend = dist.get_backend()
        group = dist.new_group(members, backend=backend)
        if dist.get_rank() not in members:
            _line_groups(tuple(shape), members, backend)
            return None
    if group is not None:
        if isinstance(device, (list, tuple)):
            raise ValueError("a rank mesh takes this rank's device, not a "
                             "device a position")
        return RankMesh(shape, axes, group, world.device()
                        if device is None else torch.device(device))
    if isinstance(device, (list, tuple)):
        distinct = {torch.device(d) for d in device}
        if len(distinct) > 1:
            raise NotImplementedError(
                f"a mesh of virtual positions over {len(distinct)} devices: "
                f"every position of a single process's mesh lives on one "
                f"device; a mesh a position a device is the rank form, "
                f"make_mesh(shape, axes, group=...) over the ranks of a "
                f"process group (repro_torch.dist.world)")
        device = next(iter(distinct)) if distinct else None
    return Mesh(shape, axes, resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 = 256 positions per pod; the multi-pod mesh stacks 2 pods on
    a leading "pod" axis (512 positions). Virtual positions on one device
    (the card unless the caller passes one)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)
