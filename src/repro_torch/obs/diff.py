"""Trace-diff: explain a performance delta by span category per shape.

Two runs of the same workload rarely differ uniformly — a regression
lives somewhere: capacity reads grew, the prefetch overlap stopped
hiding streams, recovery time doubled. This module turns "the headline
dropped 30%" into "capacity_read seconds per query grew 41% on grouped
queries":

- `digest(engine, tracer=None)` — a JSON-safe per-run summary: a pruned
  `unified_snapshot` plus per-(shape, category) critical-path seconds.
  With a `Tracer` the categories are the exact per-query critical paths
  (`obs.critical_path`); without one they are derived from the byte
  ledgers at tier rates (coarser, marked ``exact: false``). A benchmark
  row carries this digest under ``rec["obs"]``.
- `diff_digests(base, new)` / `diff_traces(a, b)` — attribute the
  per-query wall-time delta across categories, normalized per query so
  rows with different query counts still compare.
- a regression gate uses the result to *name* the dominant regressing
  category when it trips, instead of just failing.

Category keys serialize as ``"<shape>/<category>"`` (JSON objects need
string keys); shapes are the engine's "scan" | "grouped" | "join", or
"all" for derived digests that cannot split by shape.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.obs.critical_path import CATEGORIES, attribute
from repro_torch.obs.metrics import unified_snapshot

DIGEST_VERSION = 1

# snapshot scalars worth carrying into a trajectory row: enough to
# explain a delta, small enough to live in JSON forever
_SNAPSHOT_KEYS = (
    "engine.queries", "engine.bytes_scanned", "engine.logical_bytes",
    "engine.seconds",
    "tier.policy", "tier.hit_rate", "tier.fast_bytes",
    "tier.capacity_bytes", "tier.recovery_bytes",
    "prefetch.streamed_bytes", "prefetch.wasted_bytes",
    "energy.total_j", "energy.recovery_j", "energy.prefetch_j",
    "sla.served", "sla.rejected", "sla.degraded", "sla.attainment",
)


def trace_category_seconds(tracer) -> dict:
    """Exact per-("<shape>/<category>") critical-path seconds across a
    traced run (string keys, JSON-ready)."""
    attr = attribute(tracer)
    return {f"{shape}/{cat}": s
            for (shape, cat), s in sorted(attr.shape_seconds.items())}


def _derived_categories(engine) -> dict:
    """No-tracer fallback: byte ledgers priced at tier rates. Coarse on
    purpose — it cannot split by shape or see overlap, but it moves when
    the same ledgers move, which is what a regression explainer needs."""
    pe = engine.tiered
    if pe is None:
        # a flat engine measures wall time; there is no modeled ledger
        # to attribute, so the digest diffs on snapshot scalars alone
        return {}
    chips = engine.n_shards
    fast_bw = pe.tiers.fast.bandwidth * chips
    cap_bw = pe.tiers.capacity.bandwidth * chips
    out = {
        "all/fast_read": pe.fast_bytes_total / fast_bw,
        "all/capacity_read": pe.capacity_bytes_total / cap_bw,
    }
    if pe.recovery_bytes_total:
        # recovery bytes already sit inside the fast/capacity totals;
        # surface them as their own signal too (overlapping views, not
        # a partition — digests are diffed per key, never summed)
        out["all/recovery"] = pe.recovery_bytes_total / cap_bw
    if pe.prefetch_streamed_bytes_total:
        out["all/stream_wait"] = (pe.prefetch_streamed_bytes_total
                                  / cap_bw)
    if engine.power_cap is not None:
        out["all/throttle"] = engine.power_cap.throttle_s_total
    return {k: v for k, v in sorted(out.items())}


def digest(engine, tracer=None) -> dict:
    """The per-run summary a benchmark row carries (JSON-safe)."""
    snap = unified_snapshot(engine)
    kept = {k: snap[k] for k in _SNAPSHOT_KEYS if k in snap}
    for k in sorted(snap):
        if k.startswith("launches."):
            kept[k] = snap[k]
    if tracer is not None and len(tracer.queries):
        attr = attribute(tracer)
        cats = trace_category_seconds(tracer)
        exact = attr.ok
        queries = attr.queries
    else:
        cats = _derived_categories(engine)
        exact = False
        queries = len(engine.reports)
    return {"v": DIGEST_VERSION, "queries": queries, "exact": exact,
            "snapshot": kept, "categories": cats}


@dataclass(frozen=True)
class DiffRow:
    """One category's per-query seconds in both runs."""

    shape: str
    category: str
    base_s: float            # per-query seconds in the baseline run
    new_s: float             # per-query seconds in the new run
    delta_s: float           # new - base; positive = slower

    @property
    def key(self) -> str:
        return f"{self.shape}/{self.category}"

    @property
    def ratio(self) -> float:
        if self.base_s > 0:
            return self.new_s / self.base_s
        return float("inf") if self.new_s > 0 else 1.0


@dataclass
class DiffReport:
    """Attributed wall-time delta between two digests."""

    rows: list               # DiffRow, sorted most-regressing first
    base_queries: int
    new_queries: int
    base_total_s: float      # per-query category seconds, baseline
    new_total_s: float
    exact: bool              # both sides carried exact trace paths
    snapshot_deltas: dict = field(default_factory=dict)

    @property
    def delta_total_s(self) -> float:
        return self.new_total_s - self.base_total_s

    def dominant(self):
        """The top *regressing* row (largest positive per-query delta),
        or None when nothing got slower."""
        for row in self.rows:
            if row.delta_s > 0:
                return row
        return None

    def render(self) -> str:
        kind = "exact critical-path" if self.exact else "ledger-derived"
        lines = [f"trace diff ({kind} categories, per-query seconds): "
                 f"{self.base_total_s:.6g} -> {self.new_total_s:.6g} s "
                 f"({self.delta_total_s:+.3g} s)"]
        for row in self.rows:
            lines.append(
                f"  {row.key:<24s} {row.base_s:>12.6g} -> "
                f"{row.new_s:>12.6g} s  ({row.delta_s:+.3g} s, "
                f"x{row.ratio:.3g})")
        dom = self.dominant()
        if dom is not None:
            lines.append(f"  dominant regression: {dom.key} "
                         f"({dom.delta_s:+.3g} s/query)")
        else:
            lines.append("  no category regressed")
        for key, (b, n) in sorted(self.snapshot_deltas.items()):
            lines.append(f"  snapshot {key}: {b!r} -> {n!r}")
        return "\n".join(lines)


def diff_digests(base: dict, new: dict) -> DiffReport:
    """Attribute the per-query delta between two `digest()` dicts."""
    qb = max(int(base.get("queries", 0)), 1)
    qn = max(int(new.get("queries", 0)), 1)
    bc = base.get("categories", {})
    nc = new.get("categories", {})
    rows = []
    for key in sorted(set(bc) | set(nc)):
        shape, _, cat = key.partition("/")
        b = bc.get(key, 0.0) / qb
        n = nc.get(key, 0.0) / qn
        rows.append(DiffRow(shape=shape, category=cat, base_s=b,
                            new_s=n, delta_s=n - b))
    rows.sort(key=lambda r: (-r.delta_s, r.key))
    deltas = {}
    bs, ns = base.get("snapshot", {}), new.get("snapshot", {})
    for key in sorted(set(bs) | set(ns)):
        if bs.get(key) != ns.get(key):
            deltas[key] = (bs.get(key), ns.get(key))
    return DiffReport(
        rows=rows, base_queries=qb, new_queries=qn,
        base_total_s=sum(r.base_s for r in rows),
        new_total_s=sum(r.new_s for r in rows),
        exact=bool(base.get("exact")) and bool(new.get("exact")),
        snapshot_deltas=deltas)


def diff_traces(tracer_base, tracer_new) -> DiffReport:
    """Diff two traced runs directly (both sides exact)."""
    base = {"queries": len(tracer_base.queries), "exact": True,
            "categories": trace_category_seconds(tracer_base)}
    new = {"queries": len(tracer_new.queries), "exact": True,
           "categories": trace_category_seconds(tracer_new)}
    return diff_digests(base, new)


__all__ = ["CATEGORIES", "DIGEST_VERSION", "DiffRow", "DiffReport",
           "digest", "diff_digests", "diff_traces",
           "trace_category_seconds"]
