"""Logical-axis sharding: name -> mesh-axis resolution + constraint helpers
(counterpart of repro/dist/sharding.py).

Models annotate tensors with *logical* axis names ("embed", "heads", ...);
this module resolves them against a rule table and a mesh into concrete
PartitionSpecs. Resolution is the reference's, rule for rule, so one rule
table works across every (arch x shape x mesh) cell:

- rules may map a name to one mesh axis, a tuple of axes, or None;
- axes absent from the mesh are silently dropped (a "pod" rule is harmless
  on a single-pod mesh);
- an axis is never used twice within one array (first dim wins);
- a dim that is not divisible by its axis-group product drops axes from the
  end of the group until it is (even shards).

How distribution works on one card: every position of a
repro_torch.launch.mesh.Mesh lives on one device. A NamedSharding records
what each position *would* hold (`shard_shape`); a "sharded" tensor stays
whole on `mesh.device`, and nothing is copied, split or gathered to
satisfy a spec. `logical_constraint` is therefore the identity: under
`use_rules(mesh, rules)` it resolves the spec (so a rule that cannot apply
fails here as it would in the reference), checks that the tensor lives
on the mesh's device and hands the spec to `mesh_constraint`, whose
subscribers (the dry run's cost tracer) see the layout change; outside a
`use_rules` context it does nothing, so model code runs with zero
distribution setup. Numerically, sharding is a deployment detail: the
same step on a (2, 4) mesh and on a one-position mesh gives the same
bits.

Over the ranks of a process group (a launch.mesh.RankMesh) a split leaf
is real: a rank holds the block of the global leaf that its coordinates
select (`local_block`), `shard_shape(global)` in size. Along a dimension
whose spec entry names several axes, ("data", "pod") say, the block
index runs row-major over those axes in the entry's order, as JAX lays
out such a dimension. `gather` rebuilds the global leaf from the blocks
with all_gather_into_tensor over each axis's subgroup (float leaves
only: integer leaves are never split). A sharding made by
`sharding_tree` records its leaf's global shape, so `check_placed` and
`position_bytes` read a rank's tree of blocks against it.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch

# Default logical-name -> mesh-axis rules. Names absent from the table
# resolve to None (replicated); per-cell overrides come from
# repro_torch.launch.specs.rules_for and repro_torch.dist.strategies.
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "embed": "data",             # FSDP: weights gathered over data
    "mlp": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",          # EP when the expert count divides |model|
    "expert_mlp": "model",       # expert-TP fallback when EP drops
    "head_dim": None,
    "seq": None,
    "kv_seq": None,
    "act_embed": None,
    "layers": None,
    "state": None,
    "conv_kernel": None,
}

_SCALAR = "_scalar_"

# logical_constraint calls made under use_rules (read by the chip smoke to
# show that a sharded step resolves its constraints); not counted inside
# `uncounted()`, where a rematerialised block runs its forward again
CONSTRAINT_CALLS = 0
_uncounted = 0


class PartitionSpec(tuple):
    """One entry a leading dimension: None, a mesh axis, or a tuple of mesh
    axes. Immutable; equal to another spec, and to a tuple, entry by
    entry. Trailing Nones are trimmed by resolve_spec, as the
    reference's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding:
    """A spec over a mesh. `device` is where the tensor lives (whole on a
    virtual mesh, this rank's block on a rank mesh);
    `shard_shape(global_shape)` is what one position holds.
    `global_shape`, where known (sharding_tree records it), is the shape
    of the whole leaf."""

    def __init__(self, mesh, spec, global_shape=None):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else \
            PartitionSpec(*spec)
        self.global_shape = (None if global_shape is None else
                             tuple(int(n) for n in global_shape))

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def device_set(self) -> set:
        return self.mesh.device_set

    def _group(self, entry) -> tuple:
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def shard_shape(self, global_shape) -> tuple:
        """The per-position shape of a `global_shape` tensor; raises
        ValueError where a sharded dim does not divide evenly."""
        global_shape = tuple(int(n) for n in global_shape)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"{self.spec} has more entries than the "
                             f"{len(global_shape)} dims of {global_shape}")
        out = list(global_shape)
        for i, entry in enumerate(self.spec):
            n = math.prod(self.mesh.shape[a] for a in self._group(entry))
            if out[i] % n:
                raise ValueError(f"dim {i} of {global_shape} does not divide "
                                 f"into {n} shards ({self.spec})")
            out[i] //= n
        return tuple(out)

    def dim_axes(self, dim: int) -> tuple:
        """The mesh axes that split dim `dim` (() where none do)."""
        return self._group(self.spec[dim] if dim < len(self.spec) else None)

    def splits(self) -> list:
        """(dim, axes of its entry) for each dim split over more than one
        position."""
        return [(i, self._group(e)) for i, e in enumerate(self.spec)
                if math.prod(self.mesh.shape[a] for a in self._group(e)) > 1]

    def stacked(self, n: int) -> "NamedSharding":
        """The sharding of `n` such leaves stacked on a new leading,
        unsplit dim (the reference's stacked layer groups)."""
        shape = (None if self.global_shape is None
                 else (n,) + self.global_shape)
        return NamedSharding(self.mesh, PartitionSpec(None, *self.spec),
                             shape)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _names_of(names):
    """Normalize an axes annotation (tuple | 'a b _' string) to a tuple."""
    if names is None:
        return ()
    if isinstance(names, str):
        if names == _SCALAR:
            return ()
        return tuple(None if n == "_" else n for n in names.split())
    return tuple(names)


def resolve_spec(shape, names, mesh, rules) -> PartitionSpec:
    """Resolve logical `names` for a tensor of `shape` to a PartitionSpec.

    mesh only needs `.shape` (axis -> size mapping) and `.axis_names`.
    """
    names = _names_of(names)
    rules = dict(DEFAULT_RULES, **rules)   # callers pass only overrides
    mesh_axes = set(mesh.axis_names)
    sizes = dict(mesh.shape)
    claimed: set = set()
    entries = []
    for dim, name in zip(shape, names):
        rule = rules.get(name) if name is not None else None
        if rule is None:
            entries.append(None)
            continue
        group = [rule] if isinstance(rule, str) else list(rule)
        group = [a for a in group if a in mesh_axes and a not in claimed]
        # even shards: shed axes from the end until divisible
        while group and dim % math.prod(sizes[a] for a in group):
            group.pop()
        if not group:
            entries.append(None)
            continue
        claimed.update(group)
        entries.append(group[0] if len(group) == 1 else tuple(group))
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def _children(node):
    """(key, child) pairs of a tree node: an nn.Module is a dict of its
    named parameters (the axes trees key it so); None for a leaf."""
    if isinstance(node, torch.nn.Module):
        return list(node.named_parameters())
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def tree_map2(fn, tree, twin):
    """fn(leaf, twin_leaf) over `tree`'s leaves, `twin` read in the same
    structure (a module's parameters by name). Returns dicts for dicts and
    modules, lists and tuples as they are."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, twin)
    if isinstance(tree, (list, tuple)):
        if len(twin) != len(tree):
            raise ValueError(f"a tree of {len(tree)} entries against "
                             f"{len(twin)}")
        return type(tree)(tree_map2(fn, v, twin[i]) for i, v in kids)
    if set(k for k, _ in kids) != set(twin):
        raise ValueError(f"tree keys {sorted(k for k, _ in kids)[:6]} ... "
                         f"against {sorted(twin)[:6]} ...")
    return {k: tree_map2(fn, v, twin[k]) for k, v in kids}


def sharding_tree(tree, axes, mesh, rules):
    """Twin-tree map: (tensors, axes strings) -> NamedShardings; a module
    in `tree` pairs with a dict of its parameter names in `axes`. The
    leaves are the global ones (whole, or on the meta device): each
    sharding records its leaf's shape as the global shape."""
    def one(leaf, ax):
        shape = tuple(getattr(leaf, "shape", ()))
        return NamedSharding(mesh, resolve_spec(shape, ax, mesh, rules),
                             shape)
    return tree_map2(one, tree, axes)


def _on_ranks(sh) -> bool:
    return getattr(sh.mesh, "group", None) is not None


def check_placed(tree, shardings):
    """What the reference's in_shardings do: every tensor of `tree` lives
    on its sharding's device. On a virtual mesh it is the whole leaf and
    its shape divides as the spec says; on a rank mesh it is this rank's
    block, `shard_shape` of the sharding's global shape. Returns `tree`;
    raises ValueError otherwise."""
    def one(leaf, sh):
        if not isinstance(leaf, torch.Tensor):
            raise ValueError(f"{leaf!r} is not a tensor")
        if leaf.device != sh.device:
            raise ValueError(f"a tensor on {leaf.device}, its sharding on "
                             f"{sh.device}")
        if not _on_ranks(sh):
            sh.shard_shape(leaf.shape)
            return
        if sh.global_shape is None:
            raise ValueError(f"{sh} records no global shape: a rank "
                             f"mesh's shardings come from sharding_tree "
                             f"over the global leaves")
        want = sh.shard_shape(sh.global_shape)
        if tuple(leaf.shape) != want:
            raise ValueError(f"a rank holds {tuple(leaf.shape)} of a "
                             f"{sh.global_shape} leaf whose block under "
                             f"{sh.spec} is {want}")
    tree_map2(one, tree, shardings)
    return tree


def position_bytes(tree, shardings) -> int:
    """Bytes one position holds of `tree` (tensors, on any device, meta
    included; whole leaves, or a rank's blocks where the shardings record
    the global shapes) under `shardings`: each leaf's shard_shape times
    its element size, summed. On a rank mesh, the bytes a rank holds."""
    total = []
    tree_map2(lambda leaf, sh: total.append(
        math.prod(sh.shard_shape(sh.global_shape or leaf.shape))
        * leaf.element_size()), tree, shardings)
    return sum(total)


# --------------------------------------------------------------------------
# blocks over ranks
# --------------------------------------------------------------------------

def local_block(x: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's block of the global tensor `x` (a view of it) under
    `sharding` over a rank mesh; `x` itself over a virtual mesh, where
    every position holds the whole. Raises ValueError where a split dim
    does not divide."""
    if not _on_ranks(sharding):
        return x
    sharding.shard_shape(x.shape)               # divides, or raises
    mesh = sharding.mesh
    for dim, axes in sharding.splits():
        size = x.shape[dim] // math.prod(mesh.shape[a] for a in axes)
        x = x.narrow(dim, mesh.block_index(axes) * size, size)
    return x


def gather(block: torch.Tensor, sharding) -> torch.Tensor:
    """The global tensor from every rank's block under `sharding` (every
    rank of the mesh calls it alike): all_gather_into_tensor over the
    subgroup of each split axis, the entry's last axis first. `block`
    itself where nothing is split, or on a virtual mesh."""
    splits = sharding.splits() if _on_ranks(sharding) else []
    if not splits:
        return block
    if not block.is_floating_point():
        raise ValueError(f"a {block.dtype} leaf split over ranks: only "
                         f"float leaves are split and gathered")
    from repro_torch.dist import world
    mesh = sharding.mesh
    out = block
    for dim, axes in splits:
        for axis in reversed(axes):
            n = mesh.shape[axis]
            if n == 1:
                continue
            parts = world.all_gather(out, mesh.axis_group(axis))
            shape = list(out.shape)
            shape[dim] *= n
            out = parts.movedim(0, dim).reshape(shape)
    return out


# --------------------------------------------------------------------------
# constraints inside a step
# --------------------------------------------------------------------------

_ACTIVE = threading.local()


@contextmanager
def use_rules(mesh, rules, split=None):
    """Activate (mesh, rules) for logical_constraint within this thread.
    `split` maps a logical name to the mesh axes over which the tensors
    of this rank hold only a block of that dim (on a rank mesh, the
    batch's axes): logical_constraint resolves specs against the global
    size there. current_rules() gives back the arguments given."""
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    stack.append((mesh, rules) + ((dict(split),) if split else ()))
    try:
        yield
    finally:
        stack.pop()


def current_rules():
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


@contextmanager
def uncounted():
    """logical_constraint calls inside the block add nothing to
    CONSTRAINT_CALLS; they still resolve and run CONSTRAINT_HOOKS. The
    recompute of a checkpointed block runs under it, as the reference
    traces such a block once (repro_torch.models.remat)."""
    global _uncounted
    _uncounted += 1
    try:
        yield
    finally:
        _uncounted -= 1


def logical_constraint(x, names):
    """The reference's with_sharding_constraint by logical names. Returns
    `x` itself: outside a use_rules context it does nothing; inside, it
    resolves the spec against `x`'s global shape (its own, times the
    positions of the axes that `use_rules(split=)` names for a dim's
    logical name) and checks that `x` lives on the mesh's device."""
    active = current_rules()
    if active is None:
        return x
    global CONSTRAINT_CALLS
    if not _uncounted:
        CONSTRAINT_CALLS += 1
    mesh, rules = active[:2]
    shape = tuple(x.shape)
    if len(active) > 2:             # dims of which x is this rank's block
        split = active[2]
        shape = tuple(n * math.prod(mesh.shape[a] for a in split.get(name,
                                                                      ()))
                      for n, name in zip(shape, _names_of(names)
                                         + (None,) * x.ndim))
    spec = resolve_spec(shape, names, mesh, rules)
    if x.device != mesh.device:
        raise ValueError(f"a tensor on {x.device} under a mesh on "
                         f"{mesh.device} ({spec})")
    if spec == PartitionSpec():
        return x      # the reference constrains nothing fully replicated
    return mesh_constraint(x, spec)


# subscribers to layout changes: callables hook(x, spec); the dry run's
# cost tracer (repro_torch.launch._trace) subscribes while it runs
CONSTRAINT_HOOKS: list = []


def mesh_constraint(x, spec):
    """`x` is laid out as `spec` (a PartitionSpec of mesh axes) from here
    on. Returns `x` itself: on one card nothing moves; each subscriber of
    CONSTRAINT_HOOKS sees the layout change."""
    for hook in CONSTRAINT_HOOKS:
        hook(x, spec)
    return x
