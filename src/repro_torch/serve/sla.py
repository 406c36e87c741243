"""Shared SLA machinery: deadline queues + latency/attainment summaries.

The paper provisions clusters against a response-time SLA; two runtime
subsystems enforce that contract at serving time — the LM request scheduler
(repro.serve.scheduler, not ported yet) and the analytic query engine
(repro_torch.query.engine).
Both share this module:

- `DeadlineQueue`: earliest-deadline-first ordering with feasibility-based
  admission control. `est_service_s(item)` estimates how long an item needs
  (tokens / decode rate for LM requests, bytes / measured scan rate for
  queries); items that cannot finish by their deadline even if started now
  are rejected at push, and items that became hopeless while queued are
  dropped at pop so a busy server never spends capacity on guaranteed
  misses.
- `SLAReport` / `summarize`: attained-vs-promised latency (p50/p99 and
  attainment fraction), the numbers the provisioning model's predictions
  are checked against in production.
- `blended_bps` / `VirtualClock`: tiered-memory service estimation. When a
  table spans a fast (die-stacked) and a capacity (DDR) tier, admission
  feasibility must be priced at the *blended* rate the placement engine
  attains, not either tier's datasheet rate; `VirtualClock` lets the
  tiered latency model drive deadlines deterministically in benchmarks
  and tests.
"""
from __future__ import annotations

import heapq
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np


@dataclass(order=True)
class _Entry:
    deadline: float
    seq: int
    item: Any = field(compare=False)


@dataclass
class SLAReport:
    """One served item's attained latency vs its promised deadline."""
    rid: int
    deadline: float
    submitted_at: float
    finished_at: float
    work: float = 0.0            # tokens generated / bytes scanned
    degraded: bool = False       # typed-degraded answer (resilience):
    #                              served, but the SLA's promise — a full,
    #                              exact answer in time — was not kept

    @property
    def latency_s(self) -> float:
        return self.finished_at - self.submitted_at

    @property
    def met(self) -> bool:
        return self.finished_at <= self.deadline and not self.degraded


class DeadlineQueue:
    """EDF queue with feasibility admission and hopeless-item shedding."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 est_service_s: Callable[[Any], float] = lambda item: 0.0):
        self.clock = clock
        self.est_service_s = est_service_s
        self._heap: list[_Entry] = []
        self._seq = 0
        self.rejected: list[Any] = []

    def __len__(self) -> int:
        return len(self._heap)

    def feasible(self, item, deadline: float) -> bool:
        return self.clock() + self.est_service_s(item) <= deadline

    def push(self, item, deadline: float) -> bool:
        """Admit iff the item could still meet its deadline; rejected items
        are recorded, not silently served late."""
        if not self.feasible(item, deadline):
            self.rejected.append(item)
            return False
        self.requeue(item, deadline)
        return True

    def requeue(self, item, deadline: float) -> None:
        """Re-insert without re-checking feasibility (an admitted item that
        could not be placed keeps its admission)."""
        self._seq += 1
        heapq.heappush(self._heap, _Entry(deadline, self._seq, item))

    def _prune(self) -> None:
        while self._heap and not self.feasible(self._heap[0].item,
                                               self._heap[0].deadline):
            self.rejected.append(heapq.heappop(self._heap).item)

    def peek(self):
        """(item, deadline) of the earliest still-feasible entry, or None."""
        self._prune()
        if not self._heap:
            return None
        return self._heap[0].item, self._heap[0].deadline

    def pop(self):
        """Pop the earliest still-feasible entry as (item, deadline)."""
        self._prune()
        if not self._heap:
            return None
        e = heapq.heappop(self._heap)
        return e.item, e.deadline

    def ordered_items(self) -> list:
        """Queued items in deadline order (inspection/tests only)."""
        return [e.item for e in sorted(self._heap)]


def blended_bps(fast_bps: float, capacity_bps: float,
                fast_fraction: float) -> float:
    """Effective service rate when `fast_fraction` of the bytes stream
    from the fast tier and the rest from the capacity tier (harmonic
    blend — time adds, bandwidth doesn't). This is the rate admission
    control must use for a tiered table: pricing feasibility at the fast
    tier's rate admits queries the capacity tier then misses."""
    if not (math.isfinite(fast_bps) and math.isfinite(capacity_bps)) \
            or fast_bps <= 0 or capacity_bps <= 0:
        raise ValueError(f"tier rates must be finite and positive, got "
                         f"fast={fast_bps} capacity={capacity_bps}")
    if not math.isfinite(fast_fraction):
        raise ValueError(f"fast_fraction={fast_fraction} must be finite; "
                         f"a NaN hit rate means the byte accounting "
                         f"upstream is broken")
    f = min(max(fast_fraction, 0.0), 1.0)
    return 1.0 / (f / fast_bps + (1.0 - f) / capacity_bps)


class VirtualClock:
    """A manually-advanced clock with the same callable interface as
    time.monotonic: deadline machinery (DeadlineQueue, QueryEngine) runs
    on modeled service times instead of wall time, so tier placement
    experiments are deterministic and CPU-speed-independent."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        if not math.isfinite(dt) or dt < 0:
            # a NaN dt would pass a bare `dt < 0` check and silently
            # poison every later deadline comparison
            raise ValueError(f"cannot advance a clock by {dt} s; dt must "
                             f"be finite and non-negative")
        self.now += dt
        return self.now


def latency_percentile(latencies, q: float) -> float:
    """np.percentile with the edge cases pinned (regression-tested in
    tests/test_obs_analysis.py):

    - empty input  -> 0.0 (no latency evidence; a NaN would poison every
      downstream comparison, and "no queries" is not "slow queries")
    - one sample   -> that sample, for every q (the only order statistic)
    - all-equal    -> that value exactly (linear interpolation between
      equal order statistics introduces no float error)
    """
    lat = np.asarray(latencies, float)
    if lat.size == 0:
        return 0.0
    return float(np.percentile(lat, q))


def summarize(reports: list[SLAReport], rejected: int = 0) -> dict:
    """Attainment + latency percentiles for a batch of SLAReports."""
    lat = [r.latency_s for r in reports]
    met = sum(1 for r in reports if r.met)
    return {
        "served": len(reports),
        "rejected": rejected,
        "degraded": sum(1 for r in reports if r.degraded),
        "sla_attainment": met / len(reports) if reports else 1.0,
        "latency_p50_s": latency_percentile(lat, 50),
        "latency_p99_s": latency_percentile(lat, 99),
    }
