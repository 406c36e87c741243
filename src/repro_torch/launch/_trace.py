"""The dry run's cost tracer: one step on meta tensors, costed per mesh
position (repro_torch.launch.dryrun's source of flops, bytes, live memory
and collectives, where the reference reads XLA's cost_analysis,
memory_analysis and the partitioned HLO).

`CostTracer(mesh)` is a TorchDispatchMode. Every tensor carries a spec:
per dim, the tuple of mesh axes it is split over (() = whole on every
position). Specs are seeded from the step's arguments' NamedShardings
(`seed`) and from every `dist.sharding.logical_constraint` /
`mesh_constraint` call, and propagated op by op:

- pointwise ops (and casts, clones, in-place updates) take their operands'
  common spec; an operand laid out otherwise moves to it (`_move`): an
  axis it drops is an all-gather, an axis moved to another dim an
  all-to-all, an axis swapped for another of the same size on the same
  dim a collective-permute, an axis added a local slice (no bytes). An
  in-place op keeps its destination's spec;
- matmuls (mm, addmm, bmm, baddbmm: what linear and einsum lower to): a
  contracted dim split on the same axis in both operands makes a partial
  result, an all-reduce over that axis; split on one side only, that
  operand is all-gathered; an output dim that would reuse an axis drops
  it, and its operand is all-gathered over it;
- reductions (and softmax, argmax, logsumexp) over a split dim are an
  all-reduce of the result;
- views, reshapes and permutes carry the spec by the dims they map to;
  a part of a split dim (a partial slice, split) is spread over the same
  axes again by a collective-permute when it divides evenly, else
  all-gathered; a select on a split dim all-gathers the selected part;
- picks along a split dim (index, gather) are a masked local pick plus an
  all-reduce of the result; an accumulating write (index_put with
  accumulate, scatter_add) from split operands into an unsplit
  destination is an all-reduce of the destination;
- a roll along a split dim (the gpipe carry) is a collective-permute;
- ops local to a dim (cumsum, sort, topk, flip, tril) keep the spec when
  that dim is unsplit;
- any other op gathers its split operands and yields replicated results,
  and is counted by name in `unruled`.

Per position it sums flops (torch.utils.flop_counter's formulas, divided
by the product of the axes the op's work is split over: the output's and
a partial's), bytes (each non-view op's tensor operands read and outputs
written, at their per-position shapes) and the live bytes of the
intermediates (a storage counts from the op that makes it until its last
tensor is freed, so autograd's saved tensors count until the backward
drops them; the arguments count nothing): `peak` is the high-water mark.
Each collective is a core.hlo.CollectiveOp with the reference's kind
names, its per-position result bytes and its group size.
"""
from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core.hlo import CollectiveOp
from repro_torch.dist import sharding as shlib


def _entry(e) -> tuple:
    if e is None:
        return ()
    return e if isinstance(e, tuple) else (e,)


def spec_of(partition, ndim: int) -> tuple:
    """A PartitionSpec (or tuple of entries) as the tracer's spec: one
    tuple of mesh axes a dim, `ndim` of them."""
    entries = [_entry(e) for e in tuple(partition)]
    return tuple(entries + [()] * (ndim - len(entries)))


class Merged(tuple):
    """The axes of a dim that a reshape merged from several, with
    `factors`, the (size, axes) of each merged dim in order, so that a
    reshape splitting it again gives each part its own axes back (an axis
    of a minor part is not a block split of the merged dim)."""

    def __new__(cls, factors):
        factors = tuple((n, tuple(ax)) for n, ax in factors
                        if n != 1 or ax)
        obj = super().__new__(cls, [a for _, ax in factors for a in ax])
        obj.factors = factors
        return obj


def _entry_of(factors) -> tuple:
    """One dim's entry from (size, axes) factors: plain when one factor,
    or none but the leading one, carries axes."""
    factors = [(n, tuple(ax)) for n, ax in factors if n != 1 or ax]
    if all(not ax for _, ax in factors[1:]):
        return factors[0][1] if factors else ()
    return Merged(factors)


def _minus(e, used) -> tuple:
    """Entry `e` without the axes in `used` (its factors kept)."""
    if not any(a in used for a in e):
        return e
    factors = getattr(e, "factors", None)
    if factors is None:
        return tuple(a for a in e if a not in used)
    return _entry_of([(n, tuple(a for a in ax if a not in used))
                      for n, ax in factors])


def _dedupe(spec) -> tuple:
    """An axis splits one dim at most: later dims lose it."""
    seen: set = set()
    out = []
    for e in spec:
        keep = _minus(e, seen)
        seen.update(keep)
        out.append(keep)
    return tuple(out)


def _dim(d: int, ndim: int) -> int:
    return d + ndim if d < 0 else d


def tensors_of(tree) -> list:
    """The tensors of an op's arguments or results, or of a step's (nested
    lists, tuples, dicts and modules' parameters), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out: list = []
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, (list, tuple)):
            stack.extend(reversed(node))
        elif isinstance(node, dict):
            stack.extend(reversed(list(node.values())))
        elif isinstance(node, torch.nn.Module):
            stack.extend(reversed(list(node.parameters())))
    return out


class CostTracer(TorchDispatchMode):
    """Per-position costs of everything dispatched while active; see the
    module docstring. Read `flops`, `bytes`, `peak`, `ops` (collectives)
    and `unruled` after the run."""

    def __init__(self, mesh):
        super().__init__()
        self.sizes = dict(mesh.shape)
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.ops: list = []
        self.unruled: dict = {}
        self._specs: dict = {}       # storage id -> {geometry: spec}
        self._counted: dict = {}     # storage id -> live bytes it holds
        self._groups: dict = {}      # axes -> positions they span

    # ---------------------------------------------------------------- specs
    def _storage(self, t) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._counted:
            self._counted[key] = 0
            weakref.finalize(st, self._drop, key)
        return key

    def _drop(self, key) -> None:
        self.live -= self._counted.pop(key, 0)
        self._specs.pop(key, None)

    @staticmethod
    def _geometry(t) -> tuple:
        return (tuple(t.shape), t.stride(), t.storage_offset())

    def spec(self, t) -> tuple:
        got = self._specs.get(t.untyped_storage()._cdata)
        if got is not None:
            s = got.get(self._geometry(t))
            if s is not None:
                return s
        return ((),) * t.dim()

    def set_spec(self, t, spec) -> None:
        key = self._storage(t)
        spec = tuple(spec)
        if len(spec) != t.dim():
            raise ValueError(f"spec {spec} for a {t.dim()}-dim tensor")
        self._specs.setdefault(key, {})[self._geometry(t)] = spec

    def seed(self, tree, shardings) -> None:
        """The step's arguments: each leaf's NamedSharding gives its
        spec; their storages count no live bytes."""
        def one(leaf, sh):
            if isinstance(leaf, torch.Tensor):
                self.set_spec(leaf, spec_of(sh.spec, leaf.dim()))
        shlib.tree_map2(one, tree, shardings)

    def group(self, axes) -> int:
        axes = tuple(axes)
        g = self._groups.get(axes)
        if g is None:
            g = self._groups[axes] = math.prod(self.sizes[a] for a in axes)
        return g

    def position_bytes(self, t, spec=None) -> int:
        spec = self.spec(t) if spec is None else spec
        n = 1
        for size, e in zip(t.shape, spec):
            n *= -(-size // self.group(e)) if e else size
        return n * t.element_size()

    # ---------------------------------------------------------- collectives
    def collective(self, kind: str, nbytes: int, axes, what: str) -> None:
        g = self.group(axes)
        if g <= 1:
            return
        self.ops.append(CollectiveOp(
            kind, int(nbytes), g, f"{kind} over {tuple(axes)}: {what}"))

    def move(self, t, src, dst, what: str) -> None:
        """Collectives that relay `t` out from layout `src` into `dst`
        (same rank)."""
        src_at = {a: i for i, e in enumerate(src) for a in e}
        dst_at = {a: i for i, e in enumerate(dst) for a in e}
        gathered = [a for a in src_at if a not in dst_at]
        added = [a for a in dst_at if a not in src_at]
        moved = [a for a in src_at if a in dst_at and dst_at[a] != src_at[a]]
        pp = self.position_bytes(t, src)
        for i in range(len(src)):
            g = [a for a in gathered if src_at[a] == i]
            n = [a for a in added if dst_at[a] == i]
            if g and n and self.group(g) == self.group(n):
                self.collective("collective-permute", pp, g, what)
                gathered = [a for a in gathered if a not in g]
        if moved:
            self.collective("all-to-all", pp, moved, what)
        if gathered:
            self.collective("all-gather", pp * self.group(gathered),
                            gathered, what)

    def constrain(self, x, partition) -> None:
        """CONSTRAINT_HOOKS subscriber: `x` takes `partition` from here."""
        if not isinstance(x, torch.Tensor):
            return
        new = spec_of(partition, x.dim())
        self.move(x, self.spec(x), new, "constraint")
        self.set_spec(x, new)

    def __enter__(self):
        shlib.CONSTRAINT_HOOKS.append(self.constrain)
        return super().__enter__()

    def __exit__(self, *exc):
        shlib.CONSTRAINT_HOOKS.remove(self.constrain)
        return super().__exit__(*exc)

    # -------------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule, name, view, formula = _op_info(func)
        if rule is None:
            specs, split = self._unruled(func, name, args, kwargs, out)
        else:
            specs, split = rule(self, func, name, args, kwargs, out)
        outs = tensors_of(out)
        fresh = not view
        ins = tensors_of((args, kwargs))
        for t, s in zip(outs, specs):
            mutated = any(t is x for x in ins)
            self.set_spec(t, s)
            if fresh and not mutated:
                key = self._storage(t)
                nb = self.position_bytes(t, s)
                self._counted[key] += nb
                self.live += nb
        if self.live > self.peak:
            self.peak = self.live
        if fresh:
            self.bytes += sum(self.position_bytes(x) for x in ins) + sum(
                self.position_bytes(t, s) for t, s in zip(outs, specs))
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out) / split
        return out

    def _unruled(self, func, name, args, kwargs, out):
        self.unruled[name] = self.unruled.get(name, 0) + 1
        for x in tensors_of((args, kwargs)):
            s = self.spec(x)
            self.move(x, s, ((),) * x.dim(), f"{name} (unruled)")
        return [((),) * t.dim() for t in tensors_of(out)], 1

    def split_of(self, spec) -> int:
        return self.group([a for e in spec for a in e])


# --------------------------------------------------------------------------
# rules: rule(tracer, func, name, args, kwargs, out) -> (output specs in
# the order of the output's tensors, the flops divisor)
# --------------------------------------------------------------------------

def _common(tr, operands, shape, keep_first: bool = False) -> tuple:
    """The spec of a broadcast result of `shape`: per dim, the first
    operand that is not broadcast there and is split there (the first
    operand alone with keep_first: an in-place op's destination); every
    operand moves to it."""
    nd = len(shape)
    entries = [()] * nd
    for k, x in enumerate(operands):
        if keep_first and k:
            break
        s = tr.spec(x)
        off = nd - x.dim()
        for j, e in enumerate(s):
            if e and not entries[off + j] and x.shape[j] == shape[off + j]:
                entries[off + j] = e
    out = _dedupe(entries)
    for x in operands:
        off = nd - x.dim()
        want = tuple(out[off + j] if x.shape[j] == shape[off + j] else ()
                     for j in range(x.dim()))
        tr.move(x, tr.spec(x), want, "operand")
    return out


def _mutates_self(func) -> bool:
    a = func._schema.arguments
    return bool(a) and a[0].alias_info is not None and a[0].alias_info.is_write


def pointwise(tr, func, name, args, kwargs, out):
    ins = tensors_of((args, kwargs))
    outs = tensors_of(out)
    if not ins:
        return [((),) * t.dim() for t in outs], 1
    spec = _common(tr, ins, tuple(outs[0].shape), _mutates_self(func))
    return [spec for _ in outs], tr.split_of(spec)


def creation(tr, func, name, args, kwargs, out):
    return [((),) * t.dim() for t in tensors_of(out)], 1


def like(tr, func, name, args, kwargs, out):
    return [tr.spec(args[0]) for _ in tensors_of(out)], 1


def copy_(tr, func, name, args, kwargs, out):
    dst, src = args[0], args[1]
    want = tr.spec(dst)
    off = dst.dim() - src.dim()
    tr.move(src, tr.spec(src), tuple(
        want[off + j] if src.shape[j] == dst.shape[off + j] else ()
        for j in range(src.dim())), "copy_")
    return [want], 1


def matmul(tr, func, name, args, kwargs, out):
    bias = args[0] if name in ("addmm", "baddbmm") else None
    a, b = (args[1], args[2]) if bias is not None else (args[0], args[1])
    sa, sb = tr.spec(a), tr.spec(b)
    common = tuple(x for x in sa[-1] if x in sb[-2])
    ga = {x for x in sa[-1] if x not in common}      # a all-gathered over
    gb = {x for x in sb[-2] if x not in common}
    used = set(common)
    entries = []
    if a.dim() == 3:                                 # bmm's batch dim
        lead = _minus(sa[0] or sb[0], used)
        ga.update(x for x in sa[0] if x not in lead)
        gb.update(x for x in sb[0] if x not in lead)
        used.update(lead)
        entries.append(lead)
    for e, g in ((sa[-2], ga), (sb[-1], gb)):
        keep = _minus(e, used)
        g.update(x for x in e if x in used)
        used.update(keep)
        entries.append(keep)
    spec = tuple(entries)
    for x, sx, g in ((a, sa, ga), (b, sb, gb)):
        if g:
            g = [y for e in sx for y in e if y in g]
            tr.collective("all-gather", tr.position_bytes(x, sx) *
                          tr.group(g), g, f"{name} operand")
    o = tensors_of(out)[0]
    if common:
        tr.collective("all-reduce", tr.position_bytes(o, spec), common,
                      f"{name} partial sum")
    if bias is not None:
        off = o.dim() - bias.dim()
        tr.move(bias, tr.spec(bias), tuple(
            spec[off + j] if bias.shape[j] == o.shape[off + j] else ()
            for j in range(bias.dim())), f"{name} bias")
    return [spec], tr.split_of(spec) * tr.group(common)


def _reduced_dims(x, args, kwargs, at: int = 1) -> list:
    dims = kwargs.get("dim", args[at] if len(args) > at else None)
    if dims is None or dims == []:
        return list(range(x.dim()))
    if isinstance(dims, int):
        dims = [dims]
    return [_dim(d, x.dim()) for d in dims]


def reduction(tr, func, name, args, kwargs, out):
    x = args[0]
    dims = _reduced_dims(x, args, kwargs)
    keep = kwargs.get("keepdim", args[2] if len(args) > 2 and
                      isinstance(args[2], bool) else False)
    s = tr.spec(x)
    axes = [a for d in dims for a in s[d]]
    spec = tuple(() if d in dims else e for d, e in enumerate(s)
                 if keep or d not in dims)
    outs = tensors_of(out)
    for t in outs:
        if axes and t.dim() == len(spec):
            tr.collective("all-reduce", tr.position_bytes(t, spec), axes,
                          f"{name} over a split dim")
    return [spec if t.dim() == len(spec) else ((),) * t.dim()
            for t in outs], 1


def softmax(tr, func, name, args, kwargs, out):
    x = args[0]
    d = _dim(args[1], x.dim())
    s = tr.spec(x)
    if s[d]:
        row = tr.position_bytes(x, s) // max(
            1, -(-x.shape[d] // tr.group(s[d])))
        for _ in range(1 if "backward" in name else 2):    # max, then sum
            tr.collective("all-reduce", row, s[d], f"{name} over a split dim")
    return [s], tr.split_of(s)


def softmax_backward(tr, func, name, args, kwargs, out):
    s = _common(tr, [args[0], args[1]], tuple(args[0].shape))
    d = _dim(args[2], args[0].dim())
    if s[d]:
        row = tr.position_bytes(args[0], s) // max(
            1, -(-args[0].shape[d] // tr.group(s[d])))
        tr.collective("all-reduce", row, s[d], f"{name} over a split dim")
    return [s], tr.split_of(s)


def _local_dims(name, x, args, kwargs) -> list:
    if name in ("flip",):
        return [_dim(d, x.dim()) for d in args[1]]
    if name in ("tril", "triu"):
        return [x.dim() - 2, x.dim() - 1]
    if name == "topk":
        d = kwargs.get("dim", args[2] if len(args) > 2 else -1)
    elif name == "sort":
        d = kwargs.get("dim", args[1] if len(args) > 1 and
                       isinstance(args[1], int) and not isinstance(
                           args[1], bool) else -1)
    else:
        d = kwargs.get("dim", args[1] if len(args) > 1 else -1)
    return [_dim(d, x.dim())]


def dim_local(tr, func, name, args, kwargs, out):
    x = args[0]
    s = tr.spec(x)
    if any(s[d] for d in _local_dims(name, x, args, kwargs)):
        return tr._unruled(func, name, args, kwargs, out)
    return [s for _ in tensors_of(out)], tr.split_of(s)


def roll(tr, func, name, args, kwargs, out):
    x = args[0]
    s = tr.spec(x)
    dims = args[2] if len(args) > 2 else kwargs.get("dims", [])
    dims = [dims] if isinstance(dims, int) else list(dims)
    axes = [a for d in dims for a in s[_dim(d, x.dim())]]
    if not dims:
        axes = [a for e in s for a in e]
    if axes:
        tr.collective("collective-permute", tr.position_bytes(x, s), axes,
                      "roll along a split dim")
    return [s], 1


# views -------------------------------------------------------------------

def _groups(a: tuple, b: tuple) -> list:
    """Runs of dims of `a` and `b` with equal products, in order."""
    i = j = 0
    out = []
    while i < len(a) or j < len(b):
        i0, j0 = i, j
        if j < len(b) and b[j] == 1:          # a unit dim is its own run
            out.append((range(i, i), range(j, j + 1)))
            j += 1
            continue
        if i < len(a) and a[i] == 1:
            out.append((range(i, i + 1), range(j, j)))
            i += 1
            continue
        pi = pj = 1
        if i < len(a):
            pi, i = a[i], i + 1
        if j < len(b):
            pj, j = b[j], j + 1
        while pi != pj and (i < len(a) or j < len(b)):
            if (pi < pj and i < len(a)) or j == len(b):
                pi, i = pi * a[i], i + 1
            else:
                pj, j = pj * b[j], j + 1
        out.append((range(i0, i), range(j0, j)))
    return out


def _reshape(tr, x, in_shape, out_shape, s) -> tuple:
    """Carry `s` from `in_shape` to `out_shape` by the runs of dims of
    equal product, at the level of the merged dims' factors: a merge
    keeps each part's axes (`Merged`); a split gives a dim's axes to its
    leading parts while they divide; an axis that fits nowhere is
    all-gathered."""
    fin = []
    for size, e in zip(in_shape, s):
        fin += list(getattr(e, "factors", None) or [(size, tuple(e))])
    out = [()] * len(out_shape)
    gathered = []
    for ins, outs in _groups(tuple(n for n, _ in fin), out_shape):
        if len(outs) == 1:
            out[outs[0]] = _entry_of([fin[i] for i in ins])
            continue
        if not outs:
            gathered += [a for i in ins for a in fin[i][1]]
            continue
        axes = [a for i in ins for a in fin[i][1]]
        for d in outs:
            keep = []
            while axes and out_shape[d] % tr.group(keep + axes[:1]) == 0:
                keep.append(axes.pop(0))
            out[d] = tuple(keep)
        gathered += axes
    if gathered:
        tr.collective("all-gather", tr.position_bytes(x, s) * tr.group(
            gathered), gathered, "reshape of a split dim")
    return tuple(out)


def view(tr, func, name, args, kwargs, out):
    x = args[0]
    o = tensors_of(out)[0]
    return [_reshape(tr, x, tuple(x.shape), tuple(o.shape),
                     tr.spec(x))], 1


def same_view(tr, func, name, args, kwargs, out):
    return [tr.spec(args[0])], 1


def permute(tr, func, name, args, kwargs, out):
    s = tr.spec(args[0])
    return [tuple(s[_dim(d, len(s))] for d in args[1])], 1


def transpose(tr, func, name, args, kwargs, out):
    s = list(tr.spec(args[0]))
    if name == "t":
        d0, d1 = 0, len(s) - 1
    else:
        d0, d1 = _dim(args[1], len(s)), _dim(args[2], len(s))
    s[d0], s[d1] = s[d1], s[d0]
    return [tuple(s)], 1


def unsqueeze(tr, func, name, args, kwargs, out):
    s = list(tr.spec(args[0]))
    s.insert(_dim(args[1], len(s) + 1), ())
    return [tuple(s)], 1


def squeeze(tr, func, name, args, kwargs, out):
    x = args[0]
    s = tr.spec(x)
    if len(args) > 1:
        dims = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
        dims = {_dim(d, x.dim()) for d in dims}
    else:
        dims = set(range(x.dim()))
    return [tuple(e for d, e in enumerate(s)
                  if not (d in dims and x.shape[d] == 1))], 1


def expand(tr, func, name, args, kwargs, out):
    x = args[0]
    o = tensors_of(out)[0]
    s = tr.spec(x)
    off = o.dim() - x.dim()
    return [((),) * off + tuple(
        e if x.shape[j] == o.shape[off + j] else ()
        for j, e in enumerate(s))], 1


def select(tr, func, name, args, kwargs, out):
    x = args[0]
    d = _dim(args[1], x.dim())
    s = tr.spec(x)
    if s[d]:
        o = tensors_of(out)[0]
        tr.collective("all-gather", tr.position_bytes(o, s[:d] + s[d + 1:]),
                      s[d], "select on a split dim")
    return [s[:d] + s[d + 1:]], 1


def _part_spec(tr, o, s, d, what) -> tuple:
    """The spec of `o`, a part of dim d of a tensor laid out as `s`: the
    part is spread over d's axes again when it divides evenly (a
    collective-permute of its shards), else all-gathered (replicated on
    d)."""
    if not s[d]:
        return s
    if o.shape[d] % tr.group(s[d]) == 0:
        tr.collective("collective-permute", tr.position_bytes(o, s), s[d],
                      what)
        return s
    part = s[:d] + ((),) + s[d + 1:]
    tr.collective("all-gather", tr.position_bytes(o, part), s[d], what)
    return part


def slice_(tr, func, name, args, kwargs, out):
    x = args[0]
    d = _dim(args[1] if len(args) > 1 else 0, x.dim())
    s = tr.spec(x)
    o = tensors_of(out)[0]
    if o.shape[d] == x.shape[d]:
        return [s], 1
    return [_part_spec(tr, o, s, d, "slice of a split dim")], 1


def split(tr, func, name, args, kwargs, out):
    x = args[0]
    d = _dim(args[2] if len(args) > 2 else kwargs.get("dim", 0), x.dim())
    s = tr.spec(x)
    outs = tensors_of(out)
    if len(outs) == 1:
        return [s], 1
    return [_part_spec(tr, o, s, d, "split of a split dim")
            for o in outs], 1


def unbind(tr, func, name, args, kwargs, out):
    x = args[0]
    d = _dim(args[1] if len(args) > 1 else 0, x.dim())
    s = tr.spec(x)
    outs = tensors_of(out)
    rest = s[:d] + s[d + 1:]
    if s[d]:
        for o in outs:
            tr.collective("all-gather", tr.position_bytes(o, rest), s[d],
                          "unbind of a split dim")
    return [rest for _ in outs], 1


# joins, picks and writes ----------------------------------------------

def cat(tr, func, name, args, kwargs, out):
    o = tensors_of(out)[0]
    d = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0), o.dim())
    if name == "stack":
        spec = list(_common(tr, list(args[0]), tuple(args[0][0].shape)))
        spec.insert(d, ())
        return [tuple(spec)], 1
    ins = [t for t in args[0] if t.dim() == o.dim()]   # legacy empties
    entries = [()] * o.dim()
    for x in ins:
        for j, e in enumerate(tr.spec(x)):
            if j != d and e and not entries[j]:
                entries[j] = e
    spec = _dedupe(entries)
    for x in ins:      # a split of the joined dim is gathered
        tr.move(x, tr.spec(x), tuple(() if j == d else spec[j]
                                     for j in range(x.dim())), "cat operand")
    return [spec], 1


def index(tr, func, name, args, kwargs, out):
    """x[i0, i1, ...]: the index tensors' broadcast dims replace the
    indexed dims (in place when these are adjacent, else in front)."""
    x, indices = args[0], list(args[1])
    o = tensors_of(out)[0]
    s = tr.spec(x)
    at = [i for i, t in enumerate(indices) if t is not None]
    nb = o.dim() - (x.dim() - len(at))
    front = at != list(range(at[0], at[-1] + 1))
    start = 0 if front else at[0]
    bshape = tuple(o.shape[start:start + nb])
    merged = [()] * nb
    for i in at:
        t = indices[i]
        off = nb - t.dim()
        for j, e in enumerate(tr.spec(t)):
            if e and not merged[off + j] and t.shape[j] == bshape[off + j]:
                merged[off + j] = e
    rest = [d for d in range(x.dim()) if d not in at]
    before = [] if front else [d for d in rest if d < at[0]]
    after = [d for d in rest if d not in before]
    spec = _dedupe([s[d] for d in before] + merged + [s[d] for d in after])
    kept = dict(zip(before, spec[:len(before)]))
    kept.update(zip(after, spec[len(before) + nb:]))
    tr.move(x, s, tuple(kept.get(d, s[d]) for d in range(x.dim())),
            "index source")
    used = {a for e in spec for a in e}
    picked = [a for d in at for a in s[d] if a not in used]
    if picked:
        tr.collective("all-reduce", tr.position_bytes(o, spec), picked,
                      "index along a split dim")
    return [spec], 1


def index_put(tr, func, name, args, kwargs, out):
    x, values = args[0], args[2]
    accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate",
                                                           False)
    s = tr.spec(x)
    have = {a for e in s for a in e}
    extra = [a for e in tr.spec(values) for a in e if a not in have]
    for t in [t for t in args[1] if t is not None]:
        extra += [a for e in tr.spec(t) for a in e
                  if a not in have and a not in extra]
    if extra and accumulate:
        tr.collective("all-reduce", tr.position_bytes(x, s), extra,
                      "accumulating write from split values")
    elif extra:
        tr.collective("all-gather", tr.position_bytes(values) *
                      tr.group(extra), extra, "write of split values")
    return [s], 1


def gather(tr, func, name, args, kwargs, out):
    x, d, idx = args[0], _dim(args[1], args[0].dim()), args[2]
    sx, si = tr.spec(x), tr.spec(idx)
    entries = [si[j] or (sx[j] if j != d and x.shape[j] == idx.shape[j]
                         else ()) for j in range(idx.dim())]
    spec = _dedupe(entries)
    tr.move(x, sx, tuple(sx[j] if j == d else (spec[j] if x.shape[j] ==
                                                idx.shape[j] else ())
                         for j in range(x.dim())), "gather source")
    tr.move(idx, si, spec, "gather index")
    picked = [a for a in sx[d] if a not in {z for e in spec for z in e}]
    if picked:
        tr.collective("all-reduce", tr.position_bytes(
            tensors_of(out)[0], spec), picked, "gather along a split dim")
    return [spec], 1


def scatter(tr, func, name, args, kwargs, out):
    """scatter / scatter_add: in place the destination keeps its spec;
    out of place the result also takes the index's and source's splits
    of the other dims (a replicated destination is sliced)."""
    x, d = args[0], _dim(args[1], args[0].dim())
    others = tensors_of(args[2:])
    s = tr.spec(x)
    if not _mutates_self(func):
        entries = list(s)
        for t in others:
            for j, e in enumerate(tr.spec(t)):
                if j != d and e and not entries[j] and \
                        t.shape[j] == x.shape[j]:
                    entries[j] = e
        s = _dedupe(entries)
    have = {a for e in s for a in e}
    extra = []
    for t in others:
        extra += [a for e in tr.spec(t) for a in e
                  if a not in have and a not in extra]
    if extra and name.startswith("scatter_add"):
        tr.collective("all-reduce", tr.position_bytes(x, s), extra,
                      "accumulating scatter from split operands")
    elif extra:
        tr.collective("all-gather", tr.position_bytes(others[-1]) *
                      tr.group(extra), extra, "scatter of split operands")
    return [s], 1


def select_backward(tr, func, name, args, kwargs, out):
    s = list(tr.spec(args[0]))
    s.insert(_dim(args[2], len(s) + 1), ())
    return [tuple(s)], 1


def slice_backward(tr, func, name, args, kwargs, out):
    g = args[0]
    s = tr.spec(g)
    d = _dim(args[2], g.dim())
    return [s[:d] + ((),) + s[d + 1:]], 1


_BY_NAME = {
    "mm": matmul, "addmm": matmul, "bmm": matmul, "baddbmm": matmul,
    "sum": reduction, "mean": reduction, "amax": reduction,
    "amin": reduction, "argmax": reduction, "argmin": reduction,
    "logsumexp": reduction, "prod": reduction, "any": reduction,
    "all": reduction, "var_mean": reduction, "var": reduction,
    "std": reduction, "max": reduction, "min": reduction,
    "_softmax": softmax, "_log_softmax": softmax,
    "_softmax_backward_data": softmax_backward,
    "_log_softmax_backward_data": softmax_backward,
    "cumsum": dim_local, "cumprod": dim_local, "sort": dim_local,
    "topk": dim_local, "flip": dim_local, "tril": dim_local,
    "triu": dim_local, "roll": roll,
    "view": view, "_unsafe_view": view, "reshape": view,
    "_reshape_alias": view,
    "permute": permute, "transpose": transpose, "t": transpose,
    "unsqueeze": unsqueeze, "squeeze": squeeze, "expand": expand,
    "detach": same_view, "alias": same_view, "lift_fresh": same_view,
    "select": select, "slice": slice_, "split": split,
    "split_with_sizes": split, "unbind": unbind,
    "cat": cat, "stack": cat, "index": index, "index_put": index_put,
    "index_put_": index_put, "gather": gather, "scatter": scatter,
    "scatter_": scatter, "scatter_add": scatter, "scatter_add_": scatter,
    "select_backward": select_backward, "slice_backward": slice_backward,
    "copy_": copy_, "_to_copy": pointwise, "clone": pointwise,
    "copy": pointwise, "softplus_backward": pointwise,
    "threshold_backward": pointwise, "masked_fill": pointwise,
    "masked_fill_": pointwise, "where": pointwise,
    "zeros": creation, "ones": creation, "full": creation,
    "empty": creation, "empty_strided": creation, "arange": creation,
    "scalar_tensor": creation, "new_zeros": creation, "new_ones": creation,
    "new_full": creation, "new_empty": creation, "new_empty_strided":
    creation, "zeros_like": like, "ones_like": like, "full_like": like,
    "empty_like": like,
}
_CACHE: dict = {}


def _op_info(func) -> tuple:
    """(rule or None, name, is a view, flop formula or None) of an aten
    overload, looked up once."""
    got = _CACHE.get(func)
    if got is None:
        name = str(func.overloadpacket).split(".")[-1]
        rule = _BY_NAME.get(name)
        if rule is None and torch.Tag.pointwise in func.tags:
            rule = pointwise
        got = _CACHE[func] = (rule, name, func.is_view,
                              flop_registry.get(func.overloadpacket))
    return got
