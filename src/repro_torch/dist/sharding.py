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
fails here as it would in the reference) and checks that the tensor lives
on the mesh's device; outside a `use_rules` context it does nothing, so
model code runs with zero distribution setup. Numerically, sharding is a
deployment detail: the same step on a (2, 4) mesh and on a one-position
mesh gives the same bits.
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
# show that a sharded step resolves its constraints)
CONSTRAINT_CALLS = 0


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
    """A spec over a mesh. `device` is where the tensor lives whole;
    `shard_shape(global_shape)` is what one position would hold."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else \
            PartitionSpec(*spec)

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
    in `tree` pairs with a dict of its parameter names in `axes`."""
    return tree_map2(
        lambda leaf, ax: NamedSharding(
            mesh, resolve_spec(tuple(getattr(leaf, "shape", ())), ax, mesh,
                               rules)),
        tree, axes)


def check_placed(tree, shardings):
    """What the reference's in_shardings do, on one card: every tensor of
    `tree` lives on its sharding's device, and its shape divides as the
    spec says. Returns `tree`; raises ValueError otherwise."""
    def one(leaf, sh):
        if not isinstance(leaf, torch.Tensor):
            raise ValueError(f"{leaf!r} is not a tensor")
        if leaf.device != sh.device:
            raise ValueError(f"a tensor on {leaf.device}, its sharding on "
                             f"{sh.device}")
        sh.shard_shape(leaf.shape)
    tree_map2(one, tree, shardings)
    return tree


def position_bytes(tree, shardings) -> int:
    """Bytes one position holds of `tree` (tensors, on any device, meta
    included) under `shardings`: each leaf's shard_shape times its element
    size, summed."""
    total = []
    tree_map2(lambda leaf, sh: total.append(
        math.prod(sh.shard_shape(leaf.shape)) * leaf.element_size()),
        tree, shardings)
    return sum(total)


# --------------------------------------------------------------------------
# constraints inside a step
# --------------------------------------------------------------------------

_ACTIVE = threading.local()


@contextmanager
def use_rules(mesh, rules):
    """Activate (mesh, rules) for logical_constraint within this thread."""
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    stack.append((mesh, rules))
    try:
        yield
    finally:
        stack.pop()


def current_rules():
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


def logical_constraint(x, names):
    """The reference's with_sharding_constraint by logical names. Returns
    `x` itself: outside a use_rules context it does nothing; inside, it
    resolves the spec and checks that `x` lives on the mesh's device."""
    active = current_rules()
    if active is None:
        return x
    global CONSTRAINT_CALLS
    CONSTRAINT_CALLS += 1
    mesh, rules = active
    spec = resolve_spec(x.shape, names, mesh, rules)
    if x.device != mesh.device:
        raise ValueError(f"a tensor on {x.device} under a mesh on "
                         f"{mesh.device} ({spec})")
    return x
