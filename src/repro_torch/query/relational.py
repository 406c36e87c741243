"""Relational operators on a torch device: grouped aggregation and hash
join (counterpart of repro/query/relational.py).

The compile target for `plan.GroupBy` / `plan.HashJoin`. This module owns
what every execution surface (plain tables here, the compressed store in
store/exec.py) shares:

- bind/validation with actionable errors (unknown column, aggregate over
  the key, join-key width mismatch naming both columns and widths, a
  build side on another device),
- the group-domain choice: a dense arange when the observed or
  FOR-framed key span stays under `DENSE_MAX_GROUPS`, the sorted distinct
  build keys for a join, or the fallback above the cutoff,
- predicate-tree evaluation over unpacked int32 code tensors,
- the host-partial algebra: `(G, 3)` accumulator planes become exact
  Python-int partial dicts (FOR base fix-up applied per plane), merged
  associatively and finalized into
  `{"groups": {key: {"count", "sums"}}, "count": total}`.

The fallback and the oracle group rows in int64 torch on the table's
device (a histogram over the selected key span: codes are below 2^16), in
slices, so neither copies a column to the host. Every path (kernel, plain
version, fallback) lands in the same partial algebra, which is what keeps
them bit-identical to each other and to the reference.
"""
from __future__ import annotations

import operator

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.group_aggregate import ops as gops
from repro_torch.kernels.group_aggregate.ops import DENSE_MAX_GROUPS
from repro_torch.kernels.scan_filter.ref import unpack
from repro_torch.query import physical
from repro_torch.query.plan import And, HashJoin, Pred, columns_of

_OPS = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
        "ge": operator.ge, "eq": operator.eq, "ne": operator.ne}

SLICE_ROWS = 1 << 24      # rows per step of the fallback


# --------------------------------------------------------------------------
# bind / validation
# --------------------------------------------------------------------------

def bind_check(query, columns) -> None:
    """Validate a GroupBy/HashJoin against a table's columns before any
    work: unknown columns (key, aggregates, plan), join-key width
    mismatches and a build side on another device raise ValueErrors."""
    physical.bind_check(query.plan(), query.aggregates, columns)
    if isinstance(query, HashJoin):
        probe = columns[query.probe]
        build = query.build.columns[query.on]
        if probe.code_bits != build.code_bits:
            raise ValueError(
                f"HashJoin key width mismatch: probe column "
                f"{query.probe!r} is {probe.code_bits}-bit but build column "
                f"{query.on!r} is {build.code_bits}-bit; join keys compare "
                f"dictionary codes, so both sides must share one code "
                f"width — re-encode the narrower side")
        if None not in (probe.device, build.device) \
                and probe.device != build.device:
            raise ValueError(
                f"HashJoin build column {query.on!r} lives on "
                f"{build.device} but probe column {query.probe!r} lives on "
                f"{probe.device}; build the dimension table on the same "
                f"device")


def _codes(col) -> torch.Tensor:
    """A BitPackedColumn's logical rows as int32 codes on its device."""
    return unpack(col.words, col.code_bits)[:col.num_rows]


def build_keys(join: HashJoin) -> torch.Tensor:
    """Sorted distinct codes of the build side's join column, int64 on its
    device: the table this join broadcasts (a sorted array: membership
    and group slots resolve by binary search)."""
    return torch.unique(_codes(join.build.columns[join.on])).to(torch.int64)


def group_domain(query, kmin: int, kmax: int, device=None) -> torch.Tensor:
    """Candidate group keys (int64) given the observed or FOR-framed key
    code range [kmin, kmax]: a dense arange on `device` for GroupBy, the
    build side's distinct keys clipped to the range for HashJoin."""
    if isinstance(query, HashJoin):
        bk = build_keys(query)
        return bk[(bk >= kmin) & (bk <= kmax)]
    if kmax < kmin:                      # zero-row table
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.arange(kmin, kmax + 1, dtype=torch.int64, device=device)


def dense_ok(domain) -> bool:
    return len(domain) <= DENSE_MAX_GROUPS


# --------------------------------------------------------------------------
# predicate trees over code tensors
# --------------------------------------------------------------------------

def eval_plan_codes(plan, cols: dict):
    """Evaluate a Pred/And/Or tree over unpacked code tensors of one shape
    -> boolean selection of that shape."""
    if isinstance(plan, Pred):
        return _OPS[plan.op](cols[plan.column], plan.constant)
    parts = [eval_plan_codes(c, cols) for c in plan.children]
    out = parts[0]
    for p in parts[1:]:
        out = (out & p) if isinstance(plan, And) else (out | p)
    return out


def key_only_pred(query, code_bits: int):
    """If the query's plan is a single Pred on the group key (the
    tautology included), return its canonical (prim, const, invert)
    triple, which the RLE kernel evaluates on run values; return False for
    any other plan shape."""
    from repro_torch.kernels.scan_filter.ops import canonical_pred
    plan = query.plan()
    if not isinstance(plan, Pred) or plan.column != query.key:
        return False
    return canonical_pred(plan.op, plan.constant, code_bits)


# --------------------------------------------------------------------------
# host-partial algebra (exact Python ints)
# --------------------------------------------------------------------------

def new_partial() -> dict:
    return {}


def absorb_plane(partial: dict, domain, plane, col: str | None,
                 base: int = 0, key_base: int = 0,
                 count_source: bool = False) -> dict:
    """Fold one (G, 3) accumulator plane into a host partial.

    domain: the plane's group keys; key_base shifts them back to logical
    codes (FOR delta keys); base is the value column's FOR base fix-up
    (sum += base * count, exact). Counts are added only when count_source
    (one plane per launch carries them: every value column's launch
    returns the same counts)."""
    keys, sums, counts = gops.finalize_grouped(domain, plane, base)
    for k, s, c in zip(keys.tolist(), sums.tolist(), counts.tolist()):
        if c == 0:
            continue
        entry = partial.setdefault(k + key_base, [0, {}])
        if count_source:
            entry[0] += c
        if col is not None:
            entry[1][col] = entry[1].get(col, 0) + s
    return partial


def fallback_groups(key_codes, val_cols: dict, sel) -> tuple:
    """The fallback strategy: group the selected rows of 1-D code tensors
    in int64 torch on their device (a histogram over the selected key
    span, in slices of SLICE_ROWS rows). Returns (keys, counts, {name:
    sums}), int64 tensors of the non-empty groups, keys ascending. No
    kernel launch."""
    k = key_codes.reshape(-1)
    sel = sel.reshape(-1)
    if not bool(sel.any()):
        none = torch.zeros(0, dtype=torch.int64, device=k.device)
        return none, none, {name: none for name in val_cols}
    big = torch.iinfo(k.dtype).max
    kmin = int(torch.where(sel, k, big).min())
    kmax = int(torch.where(sel, k, -1).max())
    span = kmax - kmin + 1
    counts = torch.zeros(span + 1, dtype=torch.int64, device=k.device)
    sums = {name: torch.zeros_like(counts) for name in val_cols}
    for lo in range(0, k.numel(), SLICE_ROWS):
        hi = lo + SLICE_ROWS
        idx = torch.where(sel[lo:hi], k[lo:hi].to(torch.int64) - kmin, span)
        counts += torch.bincount(idx, minlength=span + 1)
        for name, v in val_cols.items():
            sums[name].index_add_(0, idx,
                                  v.reshape(-1)[lo:hi].to(torch.int64))
    hit = torch.nonzero(counts[:span]).reshape(-1)
    return hit + kmin, counts[hit], {name: t[hit] for name, t in sums.items()}


def absorb_groups(partial: dict, keys, counts, sums: dict) -> dict:
    """Fold (keys, counts, {name: sums}) groups into a host partial."""
    keys = keys.tolist()
    cnt = counts.tolist()
    s = {name: t.tolist() for name, t in sums.items()}
    for i, key in enumerate(keys):
        entry = partial.setdefault(key, [0, {}])
        entry[0] += cnt[i]
        for name in sums:
            entry[1][name] = entry[1].get(name, 0) + s[name][i]
    return partial


def absorb_fallback(partial: dict, key_codes, val_cols: dict,
                    sel) -> dict:
    """`fallback_groups` folded into the partial."""
    return absorb_groups(partial, *fallback_groups(key_codes, val_cols, sel))


def combine(a: dict, b: dict) -> dict:
    """Merge two host partials (associative, commutative, exact)."""
    for k, (c, sums) in b.items():
        entry = a.setdefault(k, [0, {}])
        entry[0] += c
        for name, s in sums.items():
            entry[1][name] = entry[1].get(name, 0) + s
    return a


def restrict(partial: dict, keys) -> dict:
    """Keep only groups whose key is in `keys` (join semantics when a
    fallback grouped every key it saw)."""
    allowed = set(torch.as_tensor(keys).tolist())
    return {k: v for k, v in partial.items() if k in allowed}


def finalize(partial: dict) -> dict:
    """Host partial -> the engine's grouped result: groups sorted by key,
    zero-count groups dropped, `count` the total selected rows."""
    groups = {}
    total = 0
    for k in sorted(partial):
        c, sums = partial[k]
        if c == 0:
            continue
        groups[k] = {"count": c, "sums": dict(sorted(sums.items()))}
        total += c
    return {"groups": groups, "count": total}


def empty_result() -> dict:
    return {"groups": {}, "count": 0}


# --------------------------------------------------------------------------
# plain-table execution
# --------------------------------------------------------------------------

def _needed(query) -> set:
    return set(query.aggregates) | columns_of(query.plan())


def execute_grouped_oracle(query, table) -> dict:
    """The oracle: decode, select, group every row with the fallback on the
    table's device; the ground truth every kernel path must match bit for
    bit."""
    bind_check(query, table.columns)
    cols = {n: _codes(table.columns[n]) for n in _needed(query)}
    key = cols[query.key]
    sel = eval_plan_codes(query.plan(), cols) if table.num_rows \
        else torch.zeros_like(key, dtype=torch.bool)
    if isinstance(query, HashJoin):
        sel = sel & torch.isin(key, build_keys(query))
    part = absorb_fallback(new_partial(), key,
                           {a: cols[a] for a in query.aggs}, sel)
    return finalize(part)


def execute_grouped(query, table, mode=None) -> dict:
    """GroupBy/HashJoin over a plain bit-packed table through the
    group_aggregate kernel (dense strategy: the whole column is one chunk;
    the fallback above the dense cutoff). Returns the finalized grouped
    result."""
    bind_check(query, table.columns)
    n = table.num_rows
    if n == 0:
        return empty_result()
    # columns of different widths unpack to different padded lengths;
    # truncating to the logical rows puts every plane on one row axis
    planes = {name: _codes(table.columns[name]) for name in _needed(query)}
    key = planes[query.key]
    sel = eval_plan_codes(query.plan(), planes)
    kmin, kmax = (int(x) for x in torch.aminmax(key))
    domain = group_domain(query, kmin, kmax, device=key.device)
    part = new_partial()
    if not dense_ok(domain):
        dispatch.count_launch("group_aggregate_fallback")
        if isinstance(query, HashJoin):
            sel = sel & torch.isin(key, build_keys(query))
        absorb_fallback(part, key, {a: planes[a] for a in query.aggs}, sel)
        if isinstance(query, HashJoin):
            part = restrict(part, build_keys(query))
        return finalize(part)
    if len(domain) == 0:
        return empty_result()
    sel_i = sel.to(torch.int32)
    value_cols = query.aggs if query.aggs else (None,)
    for i, name in enumerate(value_cols):
        vals = planes[name] if name is not None else torch.zeros_like(key)
        plane = gops.group_sum_count(key, vals, sel_i, domain, mode=mode)
        absorb_plane(part, domain, plane, name, count_source=(i == 0))
    return finalize(part)
