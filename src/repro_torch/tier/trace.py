"""Seeded skewed query traces: the workload that makes tiering matter
(counterpart of repro/tier/trace.py).

"Processing Data Where It Makes Sense" (Mutlu et al., PAPERS.md): placement
must follow access skew. A production analytics service with millions of
users produces exactly that — a few dashboards (columns) absorb most of
the scans. This module generates that stream reproducibly:

- column popularity is zipfian with exponent `skew`, over a *scrambled*
  rank->column permutation (YCSB-style), so the hot set is not the first
  columns in table order and STATIC first-fit pinning cannot win by
  accident;
- each query is a predicate scan + aggregate whose constant is drawn from
  a selectivity mix (point-ish, medium, broad), with a fraction of
  two-column conjunctions;
- queries carry a tenant id — interleaved multi-tenant streams share the
  global hot set but differ in query mix (even tenants run selective
  probes, odd tenants broad rollups).

Everything is driven by one numpy Generator seeded from `TraceSpec.seed`,
drawn in the reference's order: the same spec always yields the same
trace, the reference's query for query, so placement-policy comparisons
and bit-exactness tests are reproducible in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.query.plan import GroupBy, HashJoin, Pred, Query


@dataclass(frozen=True)
class TraceSpec:
    n_queries: int = 200
    skew: float = 1.1            # zipf exponent over column popularity
    seed: int = 0
    tenants: int = 4
    selectivities: tuple = (0.1, 0.5, 0.9)
    p_compound: float = 0.25     # fraction of two-predicate AND queries
    # relational mix: fractions of the stream that are GroupBy rollups /
    # HashJoin probes (0.0 keeps old traces byte-identical — the grouped
    # rng draws only happen when a fraction is positive)
    p_grouped: float = 0.0
    p_join: float = 0.0


@dataclass(frozen=True)
class TracedQuery:
    tenant: int
    query: Query


def zipf_weights(n: int, skew: float) -> np.ndarray:
    """Normalized zipfian popularity over ranks 0..n-1 (skew=0: uniform)."""
    if n < 1:
        raise ValueError(f"need at least one item, got n={n}")
    w = 1.0 / np.arange(1, n + 1, dtype=float) ** skew
    return w / w.sum()


def zipf_hit_curve(n: int, skew: float):
    """fraction-of-items-resident -> fraction-of-accesses-hit, for a
    zipfian popularity with the hottest items resident (the analytic
    best-case curve advise_tier_split searches against)."""
    cum = np.concatenate([[0.0], np.cumsum(zipf_weights(n, skew))])

    def hit(fraction: float) -> float:
        k = min(max(fraction, 0.0), 1.0) * n
        lo = int(k)
        if lo >= n:
            return 1.0
        return float(cum[lo] + (k - lo) * (cum[lo + 1] - cum[lo]))

    return hit


def make_trace(table, spec: TraceSpec = TraceSpec()) -> list[TracedQuery]:
    """A skewed multi-tenant stream of Query objects over `table`.

    Popularity is assigned to a seeded permutation of the columns; each
    query draws its predicate column and aggregate column from that
    distribution (so chunk heat concentrates on the zipf head), a
    selectivity from the mix, and a tenant id round-robin-ish at random.
    """
    cols = list(table.columns)
    if len(cols) < 2:
        raise ValueError("trace needs a table with >= 2 columns")
    rng = np.random.default_rng(spec.seed)
    scrambled = list(rng.permutation(cols))          # rank r -> column
    weights = zipf_weights(len(cols), spec.skew)
    p_rel = spec.p_grouped + spec.p_join
    dims: dict = {}

    def dim_for(name: str):
        """One of a small seeded pool (3 variants per probe column) of
        dimension tables: sorted distinct keys at the probe's code width,
        zipf-skewed toward small codes so join hit rates track the same
        head the placement policies chase; built on the probe table's
        device."""
        from repro_torch.db.columnar import BitPackedColumn, Table
        k = (name, int(rng.integers(3)))
        if k not in dims:
            bits = table.columns[name].code_bits
            vmax = (1 << (bits - 1)) - 1
            nk = int(min(8, vmax + 1))
            pool = np.arange(min(vmax + 1, 4 * nk))
            keys = rng.choice(pool, size=nk, replace=False,
                              p=zipf_weights(len(pool), spec.skew))
            d = Table(f"dim-{name}-{k[1]}")
            d.add(BitPackedColumn.from_values(name, np.sort(keys), bits,
                                              device=table.device))
            dims[k] = d
        return dims[k]

    out: list[TracedQuery] = []
    for _ in range(spec.n_queries):
        tenant = int(rng.integers(spec.tenants))
        # even tenants probe selectively, odd tenants run broad rollups
        mix = (spec.selectivities[:1 + len(spec.selectivities) // 2]
               if tenant % 2 == 0 else spec.selectivities)
        sel = float(rng.choice(mix))
        ranks = rng.choice(len(cols), size=min(3, len(cols)),
                           replace=False, p=weights)
        pred_col, agg_col = scrambled[ranks[0]], scrambled[ranks[1]]
        vmax = (1 << (table.columns[pred_col].code_bits - 1)) - 1
        plan = Pred(pred_col, "lt", max(1, round(sel * (vmax + 1))))
        if len(ranks) > 2 and rng.random() < spec.p_compound:
            c2 = scrambled[ranks[2]]
            v2 = (1 << (table.columns[c2].code_bits - 1)) - 1
            plan = plan & Pred(c2, "le", max(1, round(0.9 * v2)))
        if p_rel > 0 and (r := rng.random()) < p_rel:
            # grouped/join slice of the mix: the predicate column doubles
            # as the group/join key (its zipf draw is the key skew), the
            # aggregate column is the rolled-up value; a third of the
            # rollups are pure histograms (count-only — the fused RLE
            # path on pre-grouped keys)
            aggs = () if rng.random() < 1 / 3 else (agg_col,)
            if r < spec.p_join:
                q = HashJoin(dim_for(pred_col), pred_col, pred_col,
                             aggs=aggs, where=plan)
            else:
                q = GroupBy(pred_col, aggs, where=plan)
            out.append(TracedQuery(tenant, q))
            continue
        out.append(TracedQuery(tenant, Query(plan, aggregates=(agg_col,))))
    return out


def replay_trace(table, trace, tiers, policy, *, sla_s: float | None = None,
                 chunk_rows: int = 1024, warmup_fraction: float = 1 / 3,
                 mode: str = "auto", compute_w: float = 0.0,
                 power_cap=None, chaos=None, prefetch_bytes: int = 0,
                 tracer=None, monitor=None):
    """Closed-loop replay of a trace against a tiered QueryEngine — the
    one attainment methodology of the tier layer.

    The engine runs on the table's device. `mode` defaults to "auto", the
    port's idiom: the Hopper kernels on a CUDA table, their plain PyTorch
    versions on a CPU table (the reference defaults to "xla_ref", its
    plain path). The mode never moves the accounting: placement, the
    energy ledger, the power cap and attainment depend only on the trace
    and the table's chunk bytes.

    With `sla_s`, the first `warmup_fraction` of the trace runs
    deadline-free (a cold cache admission-rejecting its own warmup would
    measure the rejection spiral, not the policy) and attainment is
    measured on the rest, counting admission rejections as misses.
    Returns (placement_engine, query_engine, attainment); without
    `sla_s` the whole trace replays deadline-free and attainment is None
    (there was no SLA to attain — not 0%).

    Each query's tenant id tags its line on the energy meter; `compute_w`
    adds the per-chip compute term (repro_torch.energy.meter) and
    `power_cap` a sliding-window watt governor (repro_torch.energy.caps) —
    power-throttled service then counts against the same deadlines, so
    attainment reports the SLA cost of the cap.

    `prefetch_bytes` > 0 attaches a repro_torch.tier.PrefetchPipeline
    with that in-flight staging budget (carved out of the fast tier):
    misses overlap with scans, service per stage is max(scan, stream)
    instead of the sum, and in-flight chunks are counted as fast by
    admission projections (never double-charged). Reach it as
    `eng.prefetch`.

    `tracer` (a repro_torch.obs.Tracer) records every query's span tree
    on the replay's VirtualClock.

    `chaos` (fault injection) and `monitor` (SLO burn-rate alerts) raise
    NotImplementedError: they are ROADMAP.md's steps 6b and 6c.
    """
    from repro_torch.energy.meter import EnergyMeter
    from repro_torch.query import QueryEngine
    from repro_torch.serve.sla import VirtualClock
    from repro_torch.tier.placement import PlacementEngine
    from repro_torch.tier.prefetch import PrefetchPipeline

    pe = PlacementEngine.for_table(table, tiers, policy,
                                   chunk_rows=chunk_rows,
                                   meter=EnergyMeter(tiers, compute_w))
    pf = (PrefetchPipeline(pe, prefetch_bytes) if prefetch_bytes > 0
          else None)
    clk = VirtualClock()
    eng = QueryEngine(table, mode=mode, tiered=pe, clock=clk,
                      power_cap=power_cap, chaos=chaos, prefetch=pf,
                      tracer=tracer, monitor=monitor, device=table.device)
    warmup = int(len(trace) * warmup_fraction) if sla_s is not None else \
        len(trace)
    met = offered = 0
    for i, tq in enumerate(trace):
        measured = i >= warmup
        deadline = clk() + sla_s if measured else float("inf")
        offered += measured
        if eng.submit(tq.query, deadline=deadline,
                      tenant=tq.tenant) is None:
            continue
        met += sum(r.met for r in eng.run() if measured)
    return pe, eng, met / offered if offered else None
