"""Conservation audit: every traced byte and joule equals a ledger line.

The ROADMAP's standing accounting contract — every byte charged once,
never twice, on exactly one ledger kind — used to be a review convention
policed by hand-written property tests per subsystem. With the tracer in
place it becomes a machine-checked invariant over the *whole* execution
path: for each traced query

- span bytes by ledger kind must equal the EnergyMeter lines of that
  kind for that qid, **exactly** (int compare):
  kind="query"    == the nominal on_access split,
  kind="recovery" == the chaos harness's single recovery line,
  kind="prefetch" == staged re-reads + cancelled-stream waste;
- the kind="query" span bytes must also equal the engine's
  `bytes_scanned` for the query (`QueryTrace.bytes_expected`);
- memory joules per kind, recomputed from the span byte sums through the
  same `TierPair.energy_components` the meter prices with, must be
  *bitwise* equal to the lines' joules (same function, same ints in —
  float equality is exact, not approximate);
- compute joules, recomputed as `compute_w * chips * busy_s` from the
  compute span (the same expression `EnergyMeter.charge_compute`
  evaluates), must be bitwise equal to the lines' compute term.

A double charge, a dropped span, or a byte landing
on the wrong kind all surface as an exact mismatch.
"""
from __future__ import annotations

from dataclasses import dataclass, field

_KINDS = ("query", "recovery", "prefetch")


class ConservationError(ValueError):
    """The span-attributed bytes/joules and the energy ledger disagree."""


@dataclass
class QueryAudit:
    """One query's reconciliation: span sums vs ledger lines."""

    qid: int
    span_bytes: dict        # kind -> (fast_bytes, capacity_bytes)
    ledger_bytes: dict      # kind -> (fast_bytes, capacity_bytes)
    problems: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems


@dataclass
class AuditReport:
    queries: list
    problems: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems and all(q.ok for q in self.queries)

    def render(self) -> str:
        lines = [f"conservation audit: {len(self.queries)} queries, "
                 f"{'OK' if self.ok else 'FAILED'}"]
        for p in self.problems:
            lines.append(f"  ! {p}")
        for q in self.queries:
            for p in q.problems:
                lines.append(f"  ! qid={q.qid}: {p}")
        return "\n".join(lines)


def _span_sums(qt) -> dict:
    """kind -> [fast_bytes, capacity_bytes] over the query's spans."""
    sums = {k: [0, 0] for k in _KINDS}
    for sp in qt.spans:
        if sp.ledger is None or sp.nbytes == 0:
            continue
        if sp.ledger not in sums:
            raise ConservationError(
                f"qid={qt.qid}: span kind={sp.kind!r} carries unknown "
                f"ledger {sp.ledger!r} (must be one of {_KINDS})")
        if sp.tier not in ("fast", "capacity"):
            raise ConservationError(
                f"qid={qt.qid}: span kind={sp.kind!r} carries bytes but "
                f"tier={sp.tier!r} (must be 'fast' or 'capacity')")
        sums[sp.ledger][0 if sp.tier == "fast" else 1] += sp.nbytes
    return sums


def audit_query(qt, meter) -> QueryAudit:
    """Reconcile one traced query against the meter's lines for its qid."""
    spans = _span_sums(qt)
    lines = [c for c in meter.charges if c.qid == qt.qid]
    ledger = {k: [0, 0] for k in _KINDS}
    ledger_j = {k: [0.0, 0.0] for k in _KINDS}
    compute_lines_j = 0.0
    for c in lines:
        if c.kind not in ledger:
            ledger[c.kind] = [0, 0]
            ledger_j[c.kind] = [0.0, 0.0]
        ledger[c.kind][0] += c.fast_bytes
        ledger[c.kind][1] += c.capacity_bytes
        ledger_j[c.kind][0] += c.fast_j
        ledger_j[c.kind][1] += c.capacity_j
        compute_lines_j += c.compute_j
    problems: list[str] = []
    # --- bytes: exact int equality per ledger kind and tier ---------------
    for kind in sorted(set(spans) | set(ledger)):
        s = tuple(spans.get(kind, (0, 0)))
        led = tuple(ledger.get(kind, (0, 0)))
        if s != led:
            problems.append(
                f"kind={kind!r} bytes (fast, capacity): spans attribute "
                f"{s}, ledger charged {led}")
    # --- the engine's bytes_scanned is the query-kind span total ----------
    nominal = sum(spans["query"])
    if nominal != qt.bytes_expected:
        problems.append(
            f"query-kind span bytes {nominal} != bytes_scanned "
            f"{qt.bytes_expected}")
    # --- memory joules: recompute from span byte sums, bitwise ------------
    n_by_kind: dict = {}
    for c in lines:
        n_by_kind[c.kind] = n_by_kind.get(c.kind, 0) + 1
    for kind, (fb, cb) in spans.items():
        want_f, want_c = meter.tiers.energy_components(fb, cb)
        got_f, got_c = ledger_j.get(kind, (0.0, 0.0))
        if n_by_kind.get(kind, 0) > 1:
            # several lines of one kind (not produced by the current
            # engine paths, but legal): summation order differs, so
            # equality is near-exact rather than bitwise
            close = (abs(want_f - got_f) <= 1e-9 * max(abs(want_f), 1.0)
                     and abs(want_c - got_c)
                     <= 1e-9 * max(abs(want_c), 1.0))
            if not close:
                problems.append(
                    f"kind={kind!r} joules: spans imply "
                    f"({want_f}, {want_c}), ledger holds "
                    f"({got_f}, {got_c})")
        elif (want_f, want_c) != (got_f, got_c):
            problems.append(
                f"kind={kind!r} joules: spans imply ({want_f}, {want_c}), "
                f"ledger holds ({got_f}, {got_c})")
    # --- compute joules: the charge_compute expression, bitwise -----------
    want_compute = meter.compute_w * qt.chips * qt.busy_s
    if want_compute != compute_lines_j:
        problems.append(
            f"compute joules: compute_w*chips*busy_s = {want_compute} "
            f"(chips={qt.chips}, busy_s={qt.busy_s}), ledger holds "
            f"{compute_lines_j}")
    return QueryAudit(qid=qt.qid, span_bytes={k: tuple(v)
                                              for k, v in spans.items()},
                      ledger_bytes={k: tuple(v)
                                    for k, v in ledger.items()},
                      problems=problems)


def audit(tracer, meter) -> AuditReport:
    """Reconcile every traced query; also flags ledger lines whose qid
    was never traced (bytes charged outside any traced query — with a
    tracer attached from the start, that is itself a leak)."""
    traced = {qt.qid for qt in tracer.queries}
    report = AuditReport(queries=[audit_query(qt, meter)
                                  for qt in tracer.queries])
    stray = sorted({c.qid for c in meter.charges
                    if c.qid is not None and c.qid not in traced})
    if stray:
        report.problems.append(
            f"ledger lines charged to untraced qids {stray}")
    return report


def check(tracer, meter) -> AuditReport:
    """`audit`, raising ConservationError on any mismatch."""
    report = audit(tracer, meter)
    if not report.ok:
        raise ConservationError(report.render())
    return report
