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

A step over ranks computes on the blocks (the serve and train steps,
repro_torch.launch.specs): `use_rules(..., leaves=)` names each
parameter's sharding, and the model reads a parameter through `at_use`
(models.common.Params), which gathers its split over every axis but
COMPUTE_AXES ("data" and "pod", FSDP's) and keeps the "model" split, so
a rank never holds a "model"-split leaf whole. The model reads that
split from the leaf (`split_axes`, `block_start`) and runs a collective
exactly where it contracts a split dim: `reduce_over` (all_reduce, in
fp32 for half types) after a row-parallel product, `gather_over`
(all_gather_into_tensor) where a split output must be whole (the
vocabulary's logits, the router's), and `enter_over` where a tensor
that every rank of the axes holds alike meets a block split over them
(Megatron's "f": the identity forward). `mean_over` averages statistics
over the batch's ranks (MoE's load and importance). All four are the
identity without a rank mesh or over axes of one rank, so the
one-position and virtual paths run as before.

The caches' layout inside a serve step: `use_rules(..., rings=)` names
each cache leaf's sharding (a rank's ring blocks), and `split_axes` /
`block_start` read a ring leaf as they read a parameter: which axes
split its slots ("kv_seq") and where the rank's block starts. k/v and
pos may split differently (a kv-head dim claims an axis that pos, which
has none, gives to its slots). `constraint_axes` reads which axes the
rules split a dim of an activation over (context parallelism's
"cp_seq"), and `combine_over` folds the ranks' partial softmaxes of a
split ring: an all-reduce of the max, then one of the rescaled outputs
and sums, in fp32.

Under autograd each is a torch.autograd.Function with the adjoint its
docstring states: downstream of a reduce or a gather the compute is
replicated over those ranks, so every rank receives the same gradient
and a reduce passes it on as it is, a gather gives each rank its slice,
and `enter_over` sums the partial gradients of its input over the ranks.
`at_use` inside a train step returns a tensor whose backward adds its
gradient, this rank's "model" block whole over the gathered axes and
from this rank's rows, to its parameter (`use_grad` takes it): the step
then reduces it over the batch's axes and cuts its block
(`local_block(..., axes=)`). Under torch.no_grad() every op computes
what the serve step computed before it had adjoints.
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

# mesh axes whose split of a parameter the compute keeps (tensor and
# expert parallelism); a parameter's split over any other axis is gathered
# where it is used (at_use)
COMPUTE_AXES = ("model",)

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

    def without(self, axes) -> "NamedSharding":
        """This sharding with `axes` taken out of every entry: the layout
        of the leaf once gather(..., axes=axes) has run."""
        entries = []
        for e in self.spec:
            kept = tuple(a for a in self._group(e) if a not in axes)
            entries.append(None if not kept else
                           kept[0] if len(kept) == 1 else kept)
        while entries and entries[-1] is None:
            entries.pop()
        return NamedSharding(self.mesh, PartitionSpec(*entries),
                             self.global_shape)

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

def local_block(x: torch.Tensor, sharding, axes=None) -> torch.Tensor:
    """This rank's block of the global tensor `x` (a view of it) under
    `sharding` over a rank mesh; `x` itself over a virtual mesh, where
    every position holds the whole. Raises ValueError where a split dim
    does not divide. With `axes`, `x` is this rank's block under
    `sharding.without(axes)` (what gather(..., axes=axes) returns) and
    the result its block over those axes: gather's inverse."""
    if not _on_ranks(sharding):
        return x
    mesh = sharding.mesh
    if axes is None:
        sharding.shard_shape(x.shape)           # divides, or raises
        splits = sharding.splits()
    else:
        splits = [(dim, tuple(a for a in entry if a in axes))
                  for dim, entry in sharding.splits()]
    for dim, axes_ in splits:
        if not axes_:
            continue
        size = x.shape[dim] // math.prod(mesh.shape[a] for a in axes_)
        x = x.narrow(dim, mesh.block_index(axes_) * size, size)
    return x


def gather(block: torch.Tensor, sharding, axes=None) -> torch.Tensor:
    """The global tensor from every rank's block under `sharding` (every
    rank of the mesh calls it alike): all_gather_into_tensor over the
    subgroup of each split axis, the entry's last axis first. `block`
    itself where nothing is split, or on a virtual mesh. With `axes`, only
    the splits over those mesh axes are gathered: the result is the block
    under `sharding.without(axes)`, which needs the gathered axes of an
    entry to end it (the block index runs row-major over the entry)."""
    splits = sharding.splits() if _on_ranks(sharding) else []
    if axes is not None:
        for dim, entry in splits:
            gone = [a in axes for a in entry]
            if any(gone) and gone != sorted(gone):
                raise ValueError(f"gathering {tuple(axes)} of dim {dim} "
                                 f"split over {entry}: only an entry's "
                                 f"last axes gather to a block")
        splits = [(dim, tuple(a for a in entry if a in axes))
                  for dim, entry in splits]
    if not any(axes_ for _, axes_ in splits):
        return block
    if not block.is_floating_point():
        raise ValueError(f"a {block.dtype} leaf split over ranks: only "
                         f"float leaves are split and gathered")
    out = block
    for dim, axes_ in splits:
        out = _gather_dim(out, dim, axes_, sharding.mesh)
    return out


def _gather_dim(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """`x` concatenated along `dim` over the ranks of `axes` (a spec
    entry's axes, row-major), the last axis first."""
    from repro_torch.dist import world
    for axis in reversed(tuple(axes)):
        n = mesh.shape[axis]
        if n == 1:
            continue
        parts = world.all_gather(x, mesh.axis_group(axis))
        shape = list(x.shape)
        shape[dim] *= n
        x = parts.movedim(0, dim).reshape(shape)
    return x


# --------------------------------------------------------------------------
# constraints inside a step
# --------------------------------------------------------------------------

_ACTIVE = threading.local()


@contextmanager
def use_rules(mesh, rules, split=None, leaves=None, rings=None):
    """Activate (mesh, rules) for logical_constraint within this thread.
    `split` maps a logical name to the mesh axes over which the tensors
    of this rank hold only a block of that dim (on a rank mesh, the
    batch's axes): logical_constraint resolves specs against the global
    size there. `leaves` ({id(parameter): NamedSharding}) names the
    parameters that a step over ranks reads as blocks (at_use); a
    parameter that requires grad, read with grad enabled, takes its
    gradient at its use (use_grad). `rings` ({id(tensor): NamedSharding})
    names the caches' leaves, this rank's blocks, whose layout the step
    reads with split_axes / block_start (ring_sharding).
    current_rules() gives back the arguments given, without trailing
    Nones."""
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    args = [mesh, rules, dict(split) if split else None, leaves, rings]
    while args[-1] is None:
        args.pop()
    stack.append(tuple(args))
    try:
        yield
    finally:
        stack.pop()


def current_rules():
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


def _active(i: int):
    """The i-th argument of the active use_rules (None where not given)."""
    active = current_rules()
    return active[i] if active is not None and len(active) > i else None


# --------------------------------------------------------------------------
# compute on blocks over ranks
# --------------------------------------------------------------------------

class _AtUse(torch.autograd.Function):
    """The parameter block `p` gathered over the mesh axes `fsdp` (a new
    tensor, `p`'s values where nothing is gathered). Adjoint: the
    incoming gradient (this rank's block over the axes not gathered,
    whole over `fsdp`, from this rank's rows) is added to `p`'s gradient
    at its use (use_grad); `p` itself receives none. The train step over
    ranks reduces it over the batch's axes and cuts the block."""

    @staticmethod
    def forward(ctx, p, sh, fsdp):
        ctx.param = p
        return gather(p, sh, axes=fsdp) if fsdp else p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        p = ctx.param
        prev = getattr(p, "_use_grad", None)
        p._use_grad = g if prev is None else prev + g
        return None, None, None


def at_use(t):
    """A parameter as a step over ranks computes with it: where the
    active use_rules names its sharding (`leaves`), its split over every
    axis but COMPUTE_AXES gathered (one leaf, here, at its use), a new
    tensor object that records the sharding left (`split_axes`), made by
    _AtUse, whose backward (with grad enabled and `t` requiring grad)
    leaves the gradient for use_grad. Anything else, `t` itself."""
    leaves = _active(3)
    sh = leaves.get(id(t)) if leaves is not None else None
    if sh is None:
        return t
    fsdp = tuple(a for _, entry in sh.splits() for a in entry
                 if a not in COMPUTE_AXES)
    out = _AtUse.apply(t, sh, fsdp)
    out._sharding = sh.without(fsdp)
    return out


def reads_blocks() -> bool:
    """Whether the active use_rules names the parameters' shardings
    (`leaves`): a step over ranks reads them as blocks (at_use)."""
    return _active(3) is not None


def use_grad(p):
    """The gradient that the uses of parameter `p` (at_use) have left
    since the last call, summed over the uses, and forget it; None where
    the loss did not reach it."""
    g = getattr(p, "_use_grad", None)
    p._use_grad = None
    return g


def ring_sharding(t: torch.Tensor):
    """The sharding of `t` where the active use_rules names it a cache
    leaf (`rings`), else None."""
    rings = _active(4)
    return rings.get(id(t)) if rings is not None else None


def _sharding_of(t: torch.Tensor):
    sh = getattr(t, "_sharding", None)
    return sh if sh is not None else ring_sharding(t)


def split_axes(t: torch.Tensor, dim: int) -> tuple:
    """The mesh axes of more than one rank that split dim `dim` of `t`, a
    parameter read by at_use or a cache leaf named by use_rules(rings=)
    on a rank mesh, in its spec entry's order; () for anything else."""
    sh = _sharding_of(t)
    if sh is None or not _on_ranks(sh):
        return ()
    return tuple(a for a in sh.dim_axes(dim % t.ndim)
                 if sh.mesh.shape[a] > 1)


def block_start(t: torch.Tensor, dim: int) -> int:
    """The global index of this rank's first element along dim `dim` of
    `t` (as split_axes reads it); 0 where the dim is whole."""
    axes = split_axes(t, dim)
    return _sharding_of(t).mesh.block_index(axes) * t.shape[dim] \
        if axes else 0


def constraint_axes(shape, names, dim: int) -> tuple:
    """The mesh axes of more than one rank over which the active rules
    split dim `dim` of a tensor of this rank's `shape` annotated `names`
    (logical_constraint's resolution); () without a rank mesh. A step
    over ranks computes only its block of such a dim (context
    parallelism: the "cp_seq" rows of attention's q)."""
    mesh = _rank_mesh()
    if mesh is None:
        return ()
    spec = _resolve_active(shape, names)
    entry = spec[dim] if dim < len(spec) else None
    group = () if entry is None else \
        (entry,) if isinstance(entry, str) else tuple(entry)
    return tuple(a for a in group if mesh.shape[a] > 1)


def split_of(name: str) -> tuple:
    """The mesh axes over which the active use_rules' `split` says this
    rank holds a block of logical dim `name` (the batch's, on ranks)."""
    split = _active(2)
    return tuple(split.get(name, ())) if split else ()


def _rank_mesh():
    mesh = _active(0)
    return mesh if getattr(mesh, "group", None) is not None else None


def _over(axes):
    """(the active rank mesh, `axes` as a tuple of its axes of more than
    one rank), or (None, ()) where nothing is split."""
    mesh = _rank_mesh()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if mesh is None:
        return None, ()
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    return (mesh, axes) if axes else (None, ())


def _all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of `x` over the ranks of `axes`: all_reduce over each
    axis's subgroup, half types in fp32 and cast back once."""
    import torch.distributed as dist
    dtype = x.dtype
    out = x.to(torch.float32 if x.element_size() < 4 else dtype,
               memory_format=torch.contiguous_format, copy=True)
    for a in axes:
        dist.all_reduce(out, group=mesh.axis_group(a))
    return out.to(dtype)


class _ReduceOver(torch.autograd.Function):
    """Forward: the sum over the ranks of `axes`. Adjoint: the identity;
    the output is replicated over those ranks, and so is everything
    downstream, so every rank receives the same gradient, which is its
    partial product's."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherOver(torch.autograd.Function):
    """Forward: the concatenation along `dim` over the ranks of `axes`
    (row-major). Adjoint: this rank's slice of the incoming gradient,
    which every rank receives alike (the output is replicated)."""

    @staticmethod
    def forward(ctx, x, dim, axes, mesh):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.start = mesh.block_index(axes) * x.shape[dim]
        return _gather_dim(x, dim, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.size), None, None, None


class _EnterOver(torch.autograd.Function):
    """Forward: the identity (`x` is the same on every rank of `axes`).
    Adjoint: the sum of the incoming gradients over those ranks (fp32
    for half types), since each rank's holds only its block's part of
    the split product that `x` enters."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _MeanOver(torch.autograd.Function):
    """Forward: the sum over the ranks of `axes` divided by their count.
    Adjoint: the same, the sum of the incoming gradients over the ranks
    divided by their count; every rank's loss carries the whole term that
    reads the mean, and the train step divides the summed gradients by
    the batch's blocks again."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.n = math.prod(mesh.shape[a] for a in axes)
        return _all_reduce(x, mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes) / ctx.n, None, None


def reduce_over(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of `x` over the ranks of mesh `axes` (a name or a tuple)
    of the active rank mesh (_ReduceOver: its adjoint is the identity).
    `x` itself without a rank mesh or over axes of one rank."""
    mesh, axes = _over(axes)
    return x if mesh is None else _ReduceOver.apply(x, mesh, axes)


def gather_over(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """`x` concatenated along `dim` over the ranks of mesh `axes` (a name
    or a spec entry's tuple, row-major) of the active rank mesh:
    all_gather_into_tensor over each axis's subgroup (_GatherOver: its
    adjoint is this rank's slice). `x` itself without a rank mesh or
    over axes of one rank."""
    mesh, axes = _over(axes)
    return x if mesh is None else _GatherOver.apply(x, dim % x.ndim, axes,
                                                     mesh)


def enter_over(x: torch.Tensor, axes) -> torch.Tensor:
    """`x`, the same on every rank of mesh `axes`, as it enters a product
    whose other operand is split over them; under autograd its gradient
    is summed over those ranks (_EnterOver). `x` itself without a rank
    mesh, over axes of one rank, or where no gradient is taken."""
    mesh, axes = _over(axes)
    if mesh is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _EnterOver.apply(x, mesh, axes)


def combine_over(out: torch.Tensor, m: torch.Tensor, l_: torch.Tensor,
                 axes) -> torch.Tensor:
    """The softmax over every rank's block of a dim split over mesh `axes`
    from each rank's partial: `out` (..., D) normalised over its block,
    `m` (...) its largest score and `l_` (...) its sum of exp(score - m).
    An all-reduce of the max, then one of the rescaled outputs and sums
    (l exp(m - max m)), in fp32; a block masked whole (m = -1e30 beside
    a finite max) weighs nothing. Returns fp32; under torch.no_grad()
    only (decode). `out` itself, in fp32, without a rank mesh or over
    axes of one rank."""
    import torch.distributed as dist
    mesh, axes = _over(axes)
    if mesh is None:
        return out.float()
    big = m.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    for a in axes:
        dist.all_reduce(big, op=dist.ReduceOp.MAX, group=mesh.axis_group(a))
    w = l_.float() * torch.exp(m.float() - big)
    both = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
    both = _all_reduce(both, mesh, axes)
    return both[..., :-1] / both[..., -1:].clamp_min(1e-30)


def mean_over(x: torch.Tensor, axes) -> torch.Tensor:
    """The mean of `x` over the ranks of mesh `axes` (the batch's: each
    rank's statistic over its rows, the global batch's where the blocks
    are equal), _MeanOver under autograd. `x` itself without a rank mesh
    or over axes of one rank."""
    mesh, axes = _over(axes)
    return x if mesh is None else _MeanOver.apply(x, mesh, axes)


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


def _resolve_active(shape, names) -> PartitionSpec:
    """resolve_spec under the active use_rules for a tensor of this rank's
    `shape`: resolved against its global shape (its own, times the
    positions of the axes that `use_rules(split=)` names for a dim's
    logical name)."""
    mesh, rules = current_rules()[:2]
    split = _active(2)
    if split:                       # dims of which x is this rank's block
        shape = tuple(n * math.prod(mesh.shape[a] for a in split.get(name,
                                                                      ()))
                      for n, name in zip(shape, _names_of(names)
                                         + (None,) * len(shape)))
    return resolve_spec(shape, names, mesh, rules)


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
    mesh = active[0]
    spec = _resolve_active(tuple(x.shape), names)
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
