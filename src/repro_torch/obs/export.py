"""Trace export: Chrome trace events (Perfetto) + a plain-text waterfall.

`chrome_trace` emits the Trace Event Format (the JSON Perfetto and
chrome://tracing load): one process lane per tenant, one thread lane per
span kind, complete ("X") events in microseconds of *modeled* time.
`chrome_trace_json` serializes with sorted keys and fixed separators, so
two runs from the same seed produce byte-identical files — the
determinism contract tests/test_torch_obs.py pins down.

`waterfall` renders the same spans as aligned ASCII timelines for humans
without a browser.
"""
from __future__ import annotations

import json
import math

# stable thread-lane order: the execution story top to bottom
_LANES = ("admission", "read", "prefetch_read", "prefetch_cancel",
          "prefetch_stall", "stall", "retry", "failover", "repair",
          "shard_failover", "launch", "launch_batch", "compute",
          "throttle")


def _lane(kind: str) -> int:
    try:
        return _LANES.index(kind) + 1
    except ValueError:
        return len(_LANES) + 1


def _us(t: float) -> float:
    return round(t * 1e6, 6)


def _args(sp) -> dict:
    args = {"bytes": sp.nbytes, "joules": sp.joules}
    if sp.tier is not None:
        args["tier"] = sp.tier
    if sp.ledger is not None:
        args["ledger"] = sp.ledger
    for k, v in sp.attrs.items():
        args[k] = list(v) if isinstance(v, tuple) else v
    return args


def _name(sp) -> str:
    cid = sp.attrs.get("cid")
    if cid is not None:
        return f"{sp.kind} {cid[0]}/{cid[1]}"
    fam = sp.attrs.get("family")
    if fam is not None:
        return f"{sp.kind} {fam}"
    return sp.kind


def chrome_trace(tracer) -> dict:
    """The trace as a Trace-Event-Format object (load in Perfetto via
    `ui.perfetto.dev` > Open trace file, or chrome://tracing)."""
    events: list[dict] = []
    tenants = sorted({qt.tenant for qt in tracer.queries})
    for tenant in tenants:
        events.append({"ph": "M", "pid": tenant, "tid": 0,
                       "name": "process_name",
                       "args": {"name": f"tenant {tenant}"}})
        for i, lane in enumerate(_LANES):
            events.append({"ph": "M", "pid": tenant, "tid": i + 1,
                           "name": "thread_name", "args": {"name": lane}})
        events.append({"ph": "M", "pid": tenant, "tid": 0,
                       "name": "thread_name", "args": {"name": "query"}})
    for qt in tracer.queries:
        if qt.t_start is None or qt.t_end is None:
            continue
        events.append({
            "ph": "X", "pid": qt.tenant, "tid": 0, "cat": "query",
            "name": f"q{qt.qid}", "ts": _us(qt.t_start),
            "dur": _us(qt.t_end - qt.t_start),
            "args": {"qid": qt.qid, "bytes": qt.bytes_expected,
                     "met": qt.met, "degraded": qt.degraded,
                     "error": qt.error,
                     "deadline": (None if math.isinf(qt.deadline)
                                  else _us(qt.deadline))}})
        for sp in qt.spans:
            events.append({
                "ph": "X", "pid": qt.tenant, "tid": _lane(sp.kind),
                "cat": sp.kind, "name": _name(sp), "ts": _us(sp.t0),
                "dur": _us(sp.dur_s), "args": _args(sp)})
    # schema invariant the export tests pin: within every (pid, tid)
    # lane the X events are ts-monotone, so viewers never reorder them.
    # Metadata (M) keeps its emission order ahead of all X events.
    events.sort(key=lambda e: (e["ph"] != "M", e.get("pid", 0),
                               e.get("tid", 0), e.get("ts", 0.0),
                               e.get("dur", 0.0), e.get("name", "")))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def chrome_trace_json(tracer) -> str:
    """Deterministic serialization: same seed -> byte-identical string."""
    return json.dumps(chrome_trace(tracer), sort_keys=True,
                      separators=(",", ":"))


# --------------------------------------------------------------------------
# plain-text waterfall
# --------------------------------------------------------------------------

def _fmt_bytes(n: int) -> str:
    if n >= 1 << 20:
        return f"{n / (1 << 20):.1f}MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f}KiB"
    return f"{n}B"


def _fmt_s(t: float) -> str:
    if t >= 1.0:
        return f"{t:.3f}s"
    if t >= 1e-3:
        return f"{t * 1e3:.3f}ms"
    return f"{t * 1e6:.1f}us"


def waterfall_query(qt, *, width: int = 48) -> str:
    """One query's spans as aligned bars over [t_start, t_end]."""
    if qt.t_start is None or qt.t_end is None:
        return f"q{qt.qid}: not served"
    t0, t1 = qt.t_start, qt.t_end
    span = max(t1 - t0, 1e-12)
    head = (f"q{qt.qid} tenant={qt.tenant} "
            f"[{_fmt_s(t0)} .. {_fmt_s(t1)}] "
            f"{_fmt_bytes(qt.bytes_expected)} "
            f"{'met' if qt.met else 'MISSED'}")
    if qt.degraded:
        head += f" DEGRADED({qt.error})"
    lines = [head]
    for sp in qt.spans:
        lo = max(0.0, min(1.0, (sp.t0 - t0) / span))
        hi = max(lo, min(1.0, (sp.t1 - t0) / span))
        a = int(lo * width)
        b = max(int(math.ceil(hi * width)), a + 1)
        bar = " " * a + "#" * (b - a) + " " * (width - b)
        label = _name(sp)
        detail = _fmt_s(sp.dur_s)
        if sp.nbytes:
            detail += f" {_fmt_bytes(sp.nbytes)}"
            if sp.tier:
                detail += f" {sp.tier}"
            if sp.ledger and sp.ledger != "query":
                detail += f" [{sp.ledger}]"
        lines.append(f"  {label:<28s}|{bar}| {detail}")
    return "\n".join(lines)


def waterfall(tracer, *, width: int = 48,
              max_queries: int | None = None) -> str:
    """Every traced query's waterfall, service order."""
    qs = tracer.queries
    if max_queries is not None:
        qs = qs[:max_queries]
    out = [waterfall_query(qt, width=width) for qt in qs]
    if max_queries is not None and len(tracer.queries) > max_queries:
        out.append(f"... {len(tracer.queries) - max_queries} more queries")
    return "\n".join(out)
