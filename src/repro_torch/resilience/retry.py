"""SLA-aware retry for tiered chunk reads: timeout, capped backoff, budget
(counterpart of repro/resilience/retry.py).

A stalled fast-tier read can either ride to completion (stall_factor x
nominal — the no-recovery baseline) or be abandoned at `timeout_s`,
backed off, and re-issued. Every re-issued read is *real traffic*: its
bytes are charged into the PlacementEngine ledger and the EnergyMeter,
and its joules land in the PowerCap window, so retrying under load costs
watts the governor sees. The policy is also priced at admission
(ChaosHarness.inflate_estimate): a query whose retry-inflated service
estimate no longer fits its deadline or watt budget is rejected at
submit — the SLA story stays honest under faults.

Backoff is capped exponential: attempt k waits
`min(backoff_s * growth**k, backoff_cap_s)`. `max_retries` bounds the
per-chunk re-issue budget; an exhausted budget fails over to the
capacity tier (the durable copy), which this model treats as stable.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields


@dataclass(frozen=True)
class RetryPolicy:
    """Per-chunk-read retry contract on the modeled clock."""

    timeout_s: float               # abandon a stalled read after this
    backoff_s: float = 0.0         # base backoff before re-issue
    backoff_cap_s: float = math.inf
    growth: float = 2.0            # exponential base
    max_retries: int = 3           # re-issues per chunk before failover

    def __post_init__(self):
        if not math.isfinite(self.timeout_s) or self.timeout_s <= 0:
            raise ValueError(f"timeout_s={self.timeout_s} must be a finite "
                             f"positive duration")
        if not math.isfinite(self.backoff_s) or self.backoff_s < 0:
            raise ValueError(f"backoff_s={self.backoff_s} must be finite "
                             f"and non-negative")
        if math.isnan(self.backoff_cap_s) or self.backoff_cap_s < 0:
            raise ValueError(f"backoff_cap_s={self.backoff_cap_s} must be "
                             f"non-negative (inf = uncapped)")
        if not math.isfinite(self.growth) or self.growth < 1.0:
            raise ValueError(f"growth={self.growth} must be >= 1")
        if self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries} must be >= 0")

    def backoff(self, attempt: int) -> float:
        """Seconds to wait before re-issue number `attempt` (0-based)."""
        if attempt < 0:
            raise ValueError(f"attempt={attempt} must be >= 0")
        return min(self.backoff_s * self.growth ** attempt,
                   self.backoff_cap_s)

    def worst_case_extra_s(self) -> float:
        """Upper bound on extra modeled seconds one chunk's recovery can
        cost: every attempt times out, every backoff is taken, and the
        read fails over (capacity read priced by the caller)."""
        budget = self.max_retries
        return budget * self.timeout_s + sum(
            self.backoff(k) for k in range(budget))

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}
