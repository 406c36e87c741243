"""Critical-path extraction: which stage owned each modeled second.

The span trees account for every byte and joule; this module answers
the *time* question: for one query, decompose the closed interval
[submitted_at, t_end] into contiguous segments, each owned by exactly one
span — the critical path. Under the synchronous layout that is trivially
the read sequence; under `PrefetchPipeline` overlap it is the max branch
per stage window (`max(scan_k, stream_{k+1})`), **never** the sum — a
capacity stream that finished under a longer scan contributes zero path
time (its bytes are attributed off-path), while a stream that outlasted
the scan owns the window as `stream_wait`.

The path is *reconstructed from span geometry*, not re-derived from the
pipeline plan: the same window model `obs.trace.layout_pipeline` stamped
onto the spans is read back off them, so a layout bug surfaces as a
closure failure here instead of being reproduced twice.

Categories (`Segment.category`):

- ``queue``          admission wait, submit -> dispatch
- ``fast_read``      a fast-tier scan on the path (nominal hit reads and
                     staged chunks' fast-buffer re-reads)
- ``capacity_read``  a capacity-tier read on the path (sync misses,
                     stall-degraded streams)
- ``stream_wait``    a stage window bound by the *next* chunk's capacity
                     stream — the overlap's residual exposure
- ``recovery``       chaos extras: stall rides, retries, failovers,
                     repairs, shard failovers
- ``throttle``       power-cap stretch beyond busy time

Invariants (`critical_path` records violations in `problems`; `verify`
raises):

1. *closure* — segments tile [submitted_at, t_end] contiguously; window
   boundaries are exact (shared floats from one layout pass), the final
   endpoint matches t_end to 1e-9 relative (service_s sums bytes before
   dividing, the layout cursor divides per chunk — same value, different
   float association);
2. *byte conservation* — on-path bytes + off-path bytes equal the span
   tree's `bytes_by_ledger()` **exactly** (int compare) per
   (ledger kind, tier): every byte is either on the path or attributed
   to a hidden branch, never dropped or double-counted;
3. via `verify`, the whole trace still reconciles against the
   EnergyMeter ledger through `obs.audit.check` — path attribution and
   the conservation audit are one story.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.obs.audit import ConservationError, check

# span kinds the chaos harness lays out sequentially after the reads
_RECOVERY_KINDS = ("stall", "retry", "failover", "repair",
                   "shard_failover")

CATEGORIES = ("queue", "fast_read", "capacity_read", "stream_wait",
              "recovery", "throttle")

_REL_TOL = 1e-9


@dataclass(frozen=True)
class Segment:
    """One owned, contiguous interval of a query's critical path."""

    category: str
    kind: str                # the owning span's kind
    t0: float
    dur_s: float
    nbytes: int = 0
    tier: str | None = None
    ledger: str | None = None

    @property
    def t1(self) -> float:
        return self.t0 + self.dur_s


@dataclass
class CriticalPath:
    """One query's path decomposition + its reconciliation evidence."""

    qid: int
    tenant: int
    shape: str
    met: bool | None
    degraded: bool
    t0: float                # submitted_at
    t1: float                # t_end
    segments: list = field(default_factory=list)
    on_path_bytes: dict = field(default_factory=dict)
    off_path_bytes: dict = field(default_factory=dict)
    problems: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems

    @property
    def total_s(self) -> float:
        return self.t1 - self.t0

    def seconds_by_category(self) -> dict:
        out: dict = {}
        for seg in self.segments:
            out[seg.category] = out.get(seg.category, 0.0) + seg.dur_s
        return out


def _tol(path_end: float) -> float:
    return _REL_TOL * max(abs(path_end), 1.0)


def _category(sp) -> str:
    if sp.kind in _RECOVERY_KINDS:
        return "recovery"
    if sp.kind == "throttle":
        return "throttle"
    if sp.kind == "admission":
        return "queue"
    return "fast_read" if sp.tier == "fast" else "capacity_read"


def _seg(sp, category: str | None = None, *, t0=None, dur=None) -> Segment:
    return Segment(category=category or _category(sp), kind=sp.kind,
                   t0=sp.t0 if t0 is None else t0,
                   dur_s=sp.dur_s if dur is None else dur,
                   nbytes=sp.nbytes, tier=sp.tier, ledger=sp.ledger)


def _add_bytes(acc: dict, sp) -> None:
    if sp.ledger is None or sp.nbytes == 0:
        return
    key = (sp.ledger, sp.tier)
    acc[key] = acc.get(key, 0) + sp.nbytes


def critical_path(qt) -> CriticalPath:
    """Extract one traced query's critical path from its span tree.

    Works on both layouts from the geometry alone: scan-side spans (the
    `prefetch_read` re-reads plus every `read` not marked staged) define
    the stage windows; a window whose scan reaches the next window's
    start is scan-bound, otherwise it is owned by the next stage's
    capacity stream (the staged `read` span that ends there). Recovery
    and throttle spans are sequential by construction. Never raises —
    violations land in `.problems` (see `verify`).
    """
    cp = CriticalPath(qid=qt.qid, tenant=qt.tenant,
                      shape=getattr(qt, "shape", "scan"), met=qt.met,
                      degraded=qt.degraded, t0=qt.submitted_at,
                      t1=qt.t_end if qt.t_end is not None else
                      qt.submitted_at)
    if qt.t_start is None or qt.t_end is None:
        cp.problems.append("query was never served (no t_start/t_end)")
        return cp

    on_path: list = []       # owning spans, for the byte split
    # --- queue: the admission span, [submitted_at, t_start] ---------------
    for sp in qt.spans:
        if sp.kind == "admission":
            cp.segments.append(_seg(sp, "queue"))
            on_path.append(sp)
            break
    else:
        cp.problems.append("no admission span")

    # --- stage windows from the scan-side spans ---------------------------
    scan_side = sorted(
        (sp for sp in qt.spans
         if sp.kind == "prefetch_read"
         or (sp.kind == "read" and not sp.attrs.get("staged"))),
        key=lambda sp: sp.t0)
    staged = {sp.attrs["cid"]: sp for sp in qt.reads
              if sp.attrs.get("staged")}
    for k, sp in enumerate(scan_side):
        if k + 1 < len(scan_side):
            w_end = scan_side[k + 1].t0
        else:
            w_end = sp.t1
        if sp.t1 >= w_end:       # scan-bound window (exact: shared floats)
            cp.segments.append(_seg(sp, t0=sp.t0, dur=w_end - sp.t0))
            on_path.append(sp)
        else:                    # the next stage's stream owns the window
            nxt_cid = scan_side[k + 1].attrs.get("cid")
            stream = staged.get(nxt_cid)
            if stream is None:
                cp.problems.append(
                    f"window [{sp.t0:.6g}, {w_end:.6g}] outlasts its scan "
                    f"but no staged stream for cid={nxt_cid!r} ends there")
                continue
            cp.segments.append(_seg(stream, "stream_wait",
                                    t0=sp.t0, dur=w_end - sp.t0))
            on_path.append(stream)

    # --- recovery + throttle: sequential spans past the reads -------------
    for sp in qt.spans:
        if sp.kind in _RECOVERY_KINDS or sp.kind == "throttle":
            cp.segments.append(_seg(sp))
            on_path.append(sp)

    # --- closure: segments tile [submitted_at, t_end] ---------------------
    cp.segments.sort(key=lambda s: (s.t0, s.t1))
    tol = _tol(cp.t1)
    cursor = qt.submitted_at
    for seg in cp.segments:
        if abs(seg.t0 - cursor) > tol:
            cp.problems.append(
                f"gap/overlap at {seg.category}/{seg.kind}: segment "
                f"starts {seg.t0!r}, path cursor {cursor!r}")
        cursor = seg.t1
    if abs(cursor - qt.t_end) > tol:
        cp.problems.append(
            f"path closes at {cursor!r}, query t_end {qt.t_end!r} "
            f"(diff {cursor - qt.t_end:.3g} s > tol {tol:.3g})")

    # --- byte conservation: on-path + off-path == bytes_by_ledger ---------
    owner_ids = {id(sp) for sp in on_path}
    for sp in qt.spans:
        _add_bytes(cp.on_path_bytes if id(sp) in owner_ids
                   else cp.off_path_bytes, sp)
    want = qt.bytes_by_ledger()
    got = dict(cp.on_path_bytes)
    for key, n in cp.off_path_bytes.items():
        got[key] = got.get(key, 0) + n
    if got != want:
        cp.problems.append(
            f"path bytes (on+off) {got} != span tree bytes {want}")
    return cp


@dataclass
class Attribution:
    """Bottleneck attribution aggregated across a traced replay."""

    queries: int
    missed: int
    seconds: dict            # category -> total path seconds
    miss_seconds: dict       # category -> path seconds of SLA-missed qs
    shape_seconds: dict      # (shape, category) -> total path seconds
    paths: list
    problems: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems

    @property
    def total_s(self) -> float:
        return sum(self.seconds.values())

    @property
    def miss_total_s(self) -> float:
        return sum(self.miss_seconds.values())

    def fractions(self, *, missed_only: bool = False) -> dict:
        src = self.miss_seconds if missed_only else self.seconds
        total = sum(src.values())
        if total <= 0:
            return {k: 0.0 for k in src}
        return {k: v / total for k, v in sorted(src.items())}

    def render(self) -> str:
        lines = [f"critical-path attribution: {self.queries} queries "
                 f"({self.missed} SLA-missed), "
                 f"{self.total_s:.6g} s of path time"]
        order = sorted(self.seconds, key=self.seconds.get, reverse=True)
        fr_all = self.fractions()
        fr_miss = self.fractions(missed_only=True)
        for cat in order:
            lines.append(
                f"  {cat:<14s} {self.seconds[cat]:>12.6g} s "
                f"({fr_all.get(cat, 0.0):6.1%} of all, "
                f"{fr_miss.get(cat, 0.0):6.1%} of SLA-miss time)")
        for p in self.problems:
            lines.append(f"  ! {p}")
        return "\n".join(lines)


def attribute(tracer) -> Attribution:
    """Aggregate per-category path seconds over every traced query —
    the "capacity reads account for X% of SLA-miss time" number."""
    seconds: dict = {}
    miss_seconds: dict = {}
    shape_seconds: dict = {}
    paths = []
    problems: list = []
    missed = 0
    for qt in tracer.queries:
        cp = critical_path(qt)
        paths.append(cp)
        problems.extend(f"qid={cp.qid}: {p}" for p in cp.problems)
        is_miss = cp.met is False
        missed += is_miss
        for cat, s in cp.seconds_by_category().items():
            seconds[cat] = seconds.get(cat, 0.0) + s
            shape_seconds[(cp.shape, cat)] = \
                shape_seconds.get((cp.shape, cat), 0.0) + s
            if is_miss:
                miss_seconds[cat] = miss_seconds.get(cat, 0.0) + s
    return Attribution(queries=len(paths), missed=missed, seconds=seconds,
                       miss_seconds=miss_seconds,
                       shape_seconds=shape_seconds, paths=paths,
                       problems=problems)


def verify(tracer, meter) -> Attribution:
    """The full reconciliation: the conservation audit (span bytes/joules
    == EnergyMeter lines, exact) AND every query's critical path closing
    over [submitted_at, t_end] with exact byte attribution. Raises
    ConservationError on any violation; returns the Attribution."""
    check(tracer, meter)
    attr = attribute(tracer)
    if not attr.ok:
        raise ConservationError(
            "critical-path reconciliation failed:\n  "
            + "\n  ".join(attr.problems))
    return attr
