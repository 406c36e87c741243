"""Observability of the port: scoped metrics and per-query tracing.

- `metrics`  scoped counter/gauge/histogram registry (the dispatch launch
             counters live here)
- `trace`    per-query span trees on the VirtualClock; only the disabled
             `NullTracer` path runs in the port so far
"""
from repro_torch.obs.metrics import (MetricsRegistry, default_registry,
                                     scoped, unified_snapshot)
from repro_torch.obs.trace import (NULL_TRACE, NullTracer, QueryTrace, Span,
                                   Tracer)

__all__ = [
    "MetricsRegistry", "default_registry", "scoped", "unified_snapshot",
    "NULL_TRACE", "NullTracer", "QueryTrace", "Span", "Tracer",
]
