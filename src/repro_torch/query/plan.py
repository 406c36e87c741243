"""Logical query plans: predicate trees + multi-column aggregates.

WideTable's observation (Li & Patel, VLDB'14) — most analytic queries are
predicate scans feeding aggregates — generalized beyond the seed's
conjunction-of-one-width: predicates compose with AND/OR across columns of
*different* code widths (the physical layer repacks masks automatically),
and one query aggregates any number of columns over the same selection.

Plans are frozen, hashable dataclasses, so executions can be cached per
plan shape. (Counterpart of repro/query/plan.py; GroupBy and HashJoin are
declared here and executed by query/relational.py, on the plain table and
on the compressed store.)
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.kernels.scan_filter.ref import OPS


class Plan:
    """Base predicate-tree node; composes with `&` and `|`."""

    def __and__(self, other: "Plan") -> "And":
        return And.of(self, other)

    def __or__(self, other: "Plan") -> "Or":
        return Or.of(self, other)


@dataclass(frozen=True)
class Pred(Plan):
    """column <op> constant over dictionary codes (op: lt|le|gt|ge|eq|ne)."""
    column: str
    op: str
    constant: int

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(
                f"unknown predicate op {self.op!r}; expected one of {OPS}")
        if self.constant < 0:
            raise ValueError(
                f"predicate constant {self.constant} is negative; codes are "
                f"unsigned dictionary indices")


def _flatten(cls, children):
    out = []
    for c in children:
        out.extend(c.children if isinstance(c, cls) else (c,))
    return tuple(out)


@dataclass(frozen=True)
class And(Plan):
    children: tuple

    def __post_init__(self):
        if not self.children:
            raise ValueError("And() needs at least one child predicate")

    @classmethod
    def of(cls, *children: Plan) -> "And":
        return cls(_flatten(cls, children))


@dataclass(frozen=True)
class Or(Plan):
    children: tuple

    def __post_init__(self):
        if not self.children:
            raise ValueError("Or() needs at least one child predicate")

    @classmethod
    def of(cls, *children: Plan) -> "Or":
        return cls(_flatten(cls, children))


Predicate = Pred       # legacy name (repro_torch.db.queries)


def normalize(where) -> Plan:
    """Accept a Plan node, a single Pred, or the legacy list-of-Preds
    (implicit AND) and return a Plan tree."""
    if isinstance(where, Plan):
        return where
    if isinstance(where, (list, tuple)):
        if not where:
            raise ValueError("need at least one predicate")
        bad = [p for p in where if not isinstance(p, Plan)]
        if bad:
            raise ValueError(f"predicates must be Plan nodes, got {bad!r}")
        return where[0] if len(where) == 1 else And.of(*where)
    raise ValueError(f"cannot build a plan from {type(where).__name__!r}; "
                     f"pass a Pred/And/Or tree or a list of Preds")


def columns_of(plan: Plan) -> set[str]:
    if isinstance(plan, Pred):
        return {plan.column}
    out: set[str] = set()
    for c in plan.children:
        out |= columns_of(c)
    return out


@dataclass(frozen=True)
class Query:
    """SELECT <aggregates> WHERE <where>: the engine's unit of admission.

    where: a Plan tree (or legacy list of Preds, normalized lazily);
    aggregates: columns whose (sum, count, min, max) are computed over the
    selection.
    """
    where: Plan | tuple
    aggregates: tuple[str, ...]

    def __post_init__(self):
        # normalize eagerly so a Query is hashable (jit-cache key) and
        # malformed trees fail at construction, not execution
        object.__setattr__(self, "where", normalize(self.where))
        object.__setattr__(self, "aggregates", tuple(self.aggregates))
        if not self.aggregates:
            raise ValueError("query needs at least one aggregate column")

    def plan(self) -> Plan:
        return self.where


def _normalize_keys(node: str, keys) -> tuple[str, ...]:
    ks = (keys,) if isinstance(keys, str) else tuple(keys)
    if len(ks) != 1:
        raise ValueError(
            f"{node} supports exactly one group-key column, got "
            f"{len(ks)}: {list(ks)!r}; compose single-key queries (or "
            f"widen the dictionary to a composite code) instead")
    if not isinstance(ks[0], str):
        raise ValueError(f"{node} key must be a column name, got "
                         f"{ks[0]!r}")
    return ks


@dataclass(frozen=True)
class GroupBy:
    """SELECT key, count(*), sum(agg)... GROUP BY key [WHERE ...].

    keys: one group-key column (a 1-tuple or bare name); aggs: value
    columns whose per-group exact sums are computed (may be empty — a
    pure histogram); where: optional Plan tree filtering the rows.

    Like Query, a frozen/hashable admission unit: `.plan()` and
    `.aggregates` expose the scanned plan tree and columns so the
    engine's byte/chunk accounting and bind checks work unchanged.
    """
    keys: tuple[str, ...]
    aggs: tuple[str, ...] = ()
    where: Plan | None = None

    def __post_init__(self):
        object.__setattr__(self, "keys", _normalize_keys("GroupBy",
                                                         self.keys))
        object.__setattr__(self, "aggs", (self.aggs,) if isinstance(
            self.aggs, str) else tuple(self.aggs))
        for a in self.aggs:
            if a in self.keys:
                raise ValueError(
                    f"GroupBy aggregates {a!r}, which is the group key: "
                    f"per-group sums of the key are its key * count; drop "
                    f"the aggregate or group by a different column")
        if self.where is not None:
            object.__setattr__(self, "where", normalize(self.where))

    @property
    def key(self) -> str:
        return self.keys[0]

    def plan(self) -> Plan:
        # the tautology keeps every grouped query a plan tree, so the
        # translate/accounting/guard machinery needs no special case
        return self.where if self.where is not None \
            else Pred(self.key, "ge", 0)

    @property
    def aggregates(self) -> tuple[str, ...]:
        """Columns scanned beyond the plan tree: the value columns plus
        the key itself (charged like any other scanned column)."""
        return self.aggs + self.keys


@dataclass(frozen=True, eq=False)
class HashJoin:
    """Probe-side grouped semi-join: group the engine table's rows whose
    `probe` key appears in `build`'s `on` column, aggregating probe value
    columns per join key.

    build: a small dimension table (repro_torch.db.columnar.Table) hashed once
    and broadcast to every shard; probe: the fact-side key column on the
    engine's table; on: the build-side key column. eq=False keeps the
    node hashable-by-identity even though the build table is not, so
    jitted per-shard executions still cache per join instance.
    """
    build: object
    probe: str
    on: str
    aggs: tuple[str, ...] = ()
    where: Plan | None = None

    def __post_init__(self):
        object.__setattr__(self, "aggs", (self.aggs,) if isinstance(
            self.aggs, str) else tuple(self.aggs))
        cols = getattr(self.build, "columns", None)
        if not isinstance(cols, dict) or self.on not in cols:
            have = sorted(cols) if isinstance(cols, dict) else type(
                self.build).__name__
            raise ValueError(
                f"HashJoin build side has no column {self.on!r}; build "
                f"must be a Table carrying the join key (has: {have})")
        for a in self.aggs:
            if a == self.probe:
                raise ValueError(
                    f"HashJoin aggregates {a!r}, which is the probe join "
                    f"key: per-group sums of the key are its key * count; "
                    f"drop the aggregate or aggregate a value column")
        if self.where is not None:
            object.__setattr__(self, "where", normalize(self.where))

    @property
    def key(self) -> str:
        return self.probe

    def plan(self) -> Plan:
        return self.where if self.where is not None \
            else Pred(self.probe, "ge", 0)

    @property
    def aggregates(self) -> tuple[str, ...]:
        return self.aggs + (self.probe,)


def is_grouped(query) -> bool:
    """True for the relational admission units (GroupBy/HashJoin)."""
    return isinstance(query, (GroupBy, HashJoin))
