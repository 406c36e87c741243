"""Observability of the port: deterministic query tracing, scoped metrics,
analysis (counterpart of repro/obs).

- `trace`         per-query span trees on the VirtualClock
                  (Tracer/NullTracer)
- `metrics`       scoped counter/gauge/histogram registry + unified
                  snapshot (the dispatch launch counters live here)
- `audit`         conservation checker: span bytes/joules == ledger lines
- `export`        Chrome-trace-event JSON (Perfetto) + plain-text
                  waterfall
- `critical_path` per-query critical-path extraction + bottleneck
                  attribution, reconciled against the audit
- `timeseries`    fixed-cadence ring-buffer series on the VirtualClock
- `slo`           multi-window multi-burn-rate SLO alerting (per-tenant
                  error budgets, deterministic virtual timestamps)
- `diff`          trace-diff regression explanation (per-category,
                  per-shape wall-time attribution between two runs)
"""
from repro_torch.obs.audit import (AuditReport, ConservationError, audit,
                                   check)
from repro_torch.obs.critical_path import (CriticalPath, Segment, attribute,
                                           critical_path, verify)
from repro_torch.obs.diff import (DiffReport, DiffRow, diff_digests,
                                  diff_traces, digest,
                                  trace_category_seconds)
from repro_torch.obs.export import (chrome_trace, chrome_trace_json,
                                    waterfall, waterfall_query)
from repro_torch.obs.metrics import (MetricsRegistry, default_registry,
                                     scoped, unified_snapshot)
from repro_torch.obs.slo import (Alert, BurnRateRule, SLOMonitor,
                                 default_rules)
from repro_torch.obs.timeseries import RingSeries
from repro_torch.obs.trace import (NULL_TRACE, NullTracer, QueryTrace, Span,
                                   Tracer)

__all__ = [
    "AuditReport", "ConservationError", "audit", "check",
    "CriticalPath", "Segment", "attribute", "critical_path", "verify",
    "DiffReport", "DiffRow", "diff_digests", "diff_traces", "digest",
    "trace_category_seconds",
    "chrome_trace", "chrome_trace_json", "waterfall", "waterfall_query",
    "MetricsRegistry", "default_registry", "scoped", "unified_snapshot",
    "Alert", "BurnRateRule", "SLOMonitor", "default_rules",
    "RingSeries",
    "NULL_TRACE", "NullTracer", "QueryTrace", "Span", "Tracer",
]
