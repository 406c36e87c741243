"""Tiered-memory placement on the port: the paper's die-stacked-vs-DDR
question made executable inside the query path (counterpart of
repro.tier).

- `tiers`: TierSpecs derived from core.systems Table-1 datasheets (fast
  HBM-like tier, DDR capacity tier, calibration to the measured scan
  rate of the card's kernels) and the fast-tier TieredBudget.
- `placement`: chunk-granular placement of a table's packed columns across
  the two tiers under STATIC / CACHE / MEMCACHE policies (Bakhshalipour et
  al.'s memory / cache / memcache designs), with host-side numpy state.
- `prefetch`: the double-buffered capacity -> fast read pipeline model.
- `trace`: seeded zipfian multi-tenant query streams that exercise the
  hot/cold structure placement exists to exploit.

QueryEngine(table, tiered=PlacementEngine..., clock=VirtualClock()) wires
it into execution: answers stay bit-exact (the kernels run as in flat
mode), latency is charged per chunk at each tier's rate, and admission
feasibility uses the blended rate.
"""
from repro_torch.tier.placement import Access, PlacementEngine, Policy
from repro_torch.tier.prefetch import PrefetchPipeline, PrefetchPlan
from repro_torch.tier.tiers import (TieredBudget, TierPair, TierSpec,
                                    measured_fast_gbps, paper_tiers,
                                    table1_bandwidth_ratio, tier_from_system)
from repro_torch.tier.trace import (TracedQuery, TraceSpec, make_trace,
                                    replay_trace, zipf_hit_curve,
                                    zipf_weights)

__all__ = [
    "Access", "PlacementEngine", "Policy",
    "PrefetchPipeline", "PrefetchPlan",
    "TierSpec", "TierPair", "TieredBudget", "paper_tiers",
    "tier_from_system", "table1_bandwidth_ratio", "measured_fast_gbps",
    "TraceSpec", "TracedQuery", "make_trace", "replay_trace",
    "zipf_weights", "zipf_hit_curve",
]
