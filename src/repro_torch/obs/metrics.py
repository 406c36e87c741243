"""Scoped counter/gauge/histogram registry: one metrics namespace per scope.

`kernels.dispatch` used to keep launch counters in module-global state, so
two engines in one process polluted each other's counts and a test could
only assert launches by resetting the world. This module replaces that
with explicit `MetricsRegistry` scopes on a dynamic stack:

- the *default* registry sits at the bottom of the stack forever and
  accumulates everything — `dispatch.launch_counts()` & friends are shims
  over it, so every existing assert keeps its exact behavior;
- a `scoped(registry)` context pushes a second registry; increments land
  in **every** active scope, so an engine that wraps its execution in its
  own scope sees only its own launches while the global view still adds
  up.

The registry also names the canonical cross-subsystem byte keys:
`unified_snapshot(engine)` folds the per-subsystem `stats()` dicts
(placement, prefetch, energy, SLA) into one flat dotted-key namespace and
*cross-checks* the overlapping sources (e.g. the placement engine's
prefetch byte totals vs the pipeline's `stats()`), so a renamed or
double-counted key fails loudly instead of telling two stories.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Counter:
    """A monotonically increasing integer."""
    name: str
    value: int = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r}: inc({n}) — counters "
                             f"only go up; use a gauge for levels")
        self.value += n


@dataclass
class Gauge:
    """A level that can move both ways."""
    name: str
    value: float = 0.0

    def set(self, v: float) -> None:
        if not math.isfinite(v):
            raise ValueError(f"gauge {self.name!r}: set({v}) must be finite")
        self.value = float(v)


@dataclass
class Histogram:
    """Streaming summary of observed values (count/sum/min/max)."""
    name: str
    count: int = 0
    total: float = 0.0
    vmin: float = math.inf
    vmax: float = -math.inf

    def observe(self, v: float) -> None:
        if not math.isfinite(v):
            raise ValueError(f"histogram {self.name!r}: observe({v}) must "
                             f"be finite")
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def as_dict(self) -> dict:
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "min": self.vmin if self.count else None,
                "max": self.vmax if self.count else None}


_LAUNCH_PREFIX = "launches/"


@dataclass
class MetricsRegistry:
    """One named metrics scope. Get-or-create accessors, cheap snapshot."""

    name: str = "default"
    counters: dict = field(default_factory=dict)
    gauges: dict = field(default_factory=dict)
    histograms: dict = field(default_factory=dict)

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h

    # --- kernel-launch accounting (the dispatch shims' substrate) ---------
    def count_launch(self, family: str, n: int = 1) -> None:
        self.counter(_LAUNCH_PREFIX + family).inc(n)

    def launch_counts(self) -> dict[str, int]:
        """Per-family launch counts — the exact dict the old module-global
        `dispatch.launch_counts()` returned."""
        return {k[len(_LAUNCH_PREFIX):]: c.value
                for k, c in self.counters.items()
                if k.startswith(_LAUNCH_PREFIX) and c.value}

    def total_launches(self) -> int:
        return sum(self.launch_counts().values())

    def reset_launches(self) -> None:
        for k in [k for k in self.counters if k.startswith(_LAUNCH_PREFIX)]:
            del self.counters[k]

    def snapshot(self) -> dict:
        return {
            "scope": self.name,
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.as_dict()
                           for k, h in sorted(self.histograms.items())},
        }


# --------------------------------------------------------------------------
# the scope stack
# --------------------------------------------------------------------------

_DEFAULT = MetricsRegistry("default")
_STACK: list[MetricsRegistry] = [_DEFAULT]


def default_registry() -> MetricsRegistry:
    """The always-active bottom-of-stack scope (the old global state)."""
    return _DEFAULT


def active_scopes() -> tuple[MetricsRegistry, ...]:
    return tuple(_STACK)


@contextmanager
def scoped(registry: MetricsRegistry):
    """Push `registry` onto the scope stack: increments inside the block
    land in it *and* in every scope below (the default keeps the global
    view; the pushed scope isolates one engine's counts)."""
    _STACK.append(registry)
    try:
        yield registry
    finally:
        _STACK.remove(registry)


def count_launch(family: str, n: int = 1) -> None:
    """Record `n` kernel dispatches for `family` in every active scope."""
    for reg in _STACK:
        reg.count_launch(family, n)


def record_batch(family: str, width: int, n_chunks: int) -> None:
    """Record one *batched* launch covering `n_chunks` chunks at the
    unified payload width `width` — the width-group attribution the trace
    launch spans carry (counters `batch/<family>/w<width>` and
    `batch_chunks/<family>/w<width>` in every active scope)."""
    for reg in _STACK:
        reg.counter(f"batch/{family}/w{width}").inc(1)
        reg.counter(f"batch_chunks/{family}/w{width}").inc(n_chunks)


# --------------------------------------------------------------------------
# the unified snapshot (satellite: one canonical byte-key namespace)
# --------------------------------------------------------------------------

def unified_snapshot(engine) -> dict:
    """One flat dotted-key snapshot over every subsystem the engine
    carries — the canonical names the per-subsystem `stats()` dicts map
    into. Overlapping sources are cross-checked, not duplicated:

    - ``tier.recovery_bytes``     == PlacementEngine.recovery_bytes_total
                                  == PlacementEngine.stats()["recovery_bytes"]
    - ``prefetch.streamed_bytes`` == PlacementEngine
                                     .prefetch_streamed_bytes_total
                                  == PrefetchPipeline.stats()
                                     ["streamed_bytes"]
    - ``prefetch.wasted_bytes``   likewise for cancelled-stream waste

    A mismatch between the placement engine's totals and the pipeline's
    view raises ValueError — the byte accounting upstream broke.
    """
    out: dict = {
        "engine.queries": len(engine.results),
        "engine.bytes_scanned": int(engine.bytes_total),
        "engine.logical_bytes": int(engine.logical_bytes_total),
        "engine.seconds": engine.seconds_total,
    }
    for family, n in sorted(engine.metrics.launch_counts().items()):
        out[f"launches.{family}"] = n
    pe = engine.tiered
    if pe is not None:
        out["tier.policy"] = pe.policy.value
        out["tier.fast_bytes"] = int(pe.fast_bytes_total)
        out["tier.capacity_bytes"] = int(pe.capacity_bytes_total)
        out["tier.recovery_bytes"] = int(pe.recovery_bytes_total)
        out["tier.hit_rate"] = pe.hit_rate
        out["tier.chunk_hits"] = pe.hits_total
        out["tier.chunk_misses"] = pe.misses_total
        out["tier.demoted"] = pe.demoted
        out["prefetch.reserved_bytes"] = int(pe.prefetch_reserved_bytes)
        out["prefetch.streamed_bytes"] = \
            int(pe.prefetch_streamed_bytes_total)
        out["prefetch.wasted_bytes"] = int(pe.prefetch_wasted_bytes_total)
        m = pe.meter
        query_j = sum(c.total_j for c in m.charges if c.kind == "query")
        out["energy.query_j"] = query_j
        out["energy.recovery_j"] = m.recovery_j
        out["energy.prefetch_j"] = m.prefetch_j
        out["energy.memory_j"] = m.memory_j
        out["energy.compute_j"] = m.compute_j
        out["energy.total_j"] = m.total_j
        stats = pe.stats(engine.n_shards)
        if stats["recovery_bytes"] != out["tier.recovery_bytes"]:
            raise ValueError(
                f"PlacementEngine.stats()['recovery_bytes']="
                f"{stats['recovery_bytes']} disagrees with "
                f"recovery_bytes_total={out['tier.recovery_bytes']}")
    if engine.prefetch is not None:
        ps = engine.prefetch.stats()
        for snap_key, stats_key in (("prefetch.streamed_bytes",
                                     "streamed_bytes"),
                                    ("prefetch.wasted_bytes",
                                     "wasted_bytes")):
            if ps[stats_key] != out[snap_key]:
                raise ValueError(
                    f"PrefetchPipeline.stats()[{stats_key!r}]="
                    f"{ps[stats_key]} disagrees with {snap_key}="
                    f"{out[snap_key]}; the prefetch ledger and the "
                    f"placement totals must tell one story")
        out["prefetch.plans"] = ps["plans"]
        out["prefetch.staged_chunks"] = ps["staged_chunks"]
        out["prefetch.stalled_chunks"] = ps["stalled_chunks"]
        out["prefetch.cancelled_chunks"] = ps["cancelled_chunks"]
    rep = engine.reports
    out["sla.served"] = len(rep)
    out["sla.rejected"] = len(engine.queue.rejected)
    out["sla.degraded"] = sum(1 for r in rep if r.degraded)
    out["sla.attainment"] = (sum(1 for r in rep if r.met) / len(rep)
                             if rep else 1.0)
    return out
