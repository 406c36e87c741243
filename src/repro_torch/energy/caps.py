"""Power-capped execution: a sliding-window watt budget as a governor
(counterpart of repro/energy/caps.py; numpy, no device work).

A rack's power envelope is a contract over *every* window, not an average
over the whole day — a 30 s burst at 3x the budget trips the breaker even
if the daily mean is fine. `PowerCap` enforces that contract on the tiered
query path:

- every executed query is a ledger segment `(t0, t1, joules)` with uniform
  power over its wall time (times come from `serve.sla.VirtualClock`, so
  the guarantee is deterministic and testable);
- before a query runs, the governor *stretches* its wall service time just
  enough that no window of length `window_s` — past, present, or straddling
  — averages above `budget_w`. Stretching is a bandwidth derate: the
  effective tier rate drops, the chip races-to-idle (compute joules are
  charged at busy time, see repro_torch.energy.meter), and the query
  simply finishes later;
- the same stretched estimate feeds EDF admission
  (`repro_torch.query.engine`): a query whose power-derated service
  time cannot meet its deadline is rejected at submit, never silently
  run over-budget.

`max_window_watts()` is an exact check, not a sampling one: with piecewise-
constant power the sliding-window average is piecewise-linear in the window
position, so its maximum is attained with a window edge on a segment
boundary — checking those finitely many candidates bounds every window.
The governor only ever inspects segments still inside one window of the
new query's start (older ones cannot overlap any affected window), so its
cost tracks the window's occupancy, not the full history.
"""
from __future__ import annotations

import math

import numpy as np

_TOL = 1e-12     # relative slack for float-equality at the budget boundary


def _max_window_watts(t0s: np.ndarray, t1s: np.ndarray, js: np.ndarray,
                      window_s: float, after: float | None = None) -> float:
    """Exact sup of window-average power over ALL windows of `window_s`
    for uniform-power segments. Candidate window ends: every boundary and
    every boundary plus one window length (covering windows that *start*
    on a boundary) — the extrema of a piecewise-linear function. With
    `after`, only windows ending past it count (each sum computed as
    without it)."""
    if len(t0s) == 0:
        return 0.0
    ends = np.unique(np.concatenate(
        [t0s, t1s, t0s + window_s, t1s + window_s]))
    dur = t1s - t0s
    dens = np.where(dur > 0, js / np.where(dur > 0, dur, 1.0), 0.0)
    best = 0.0
    # overlap of every (window, segment) pair; windows are (e - L, e].
    # Batched so a long history costs O(batch x n) memory, not O(n^2)
    for i in range(0, len(ends), 1024):
        e = ends[i:i + 1024, None]
        ov = (np.minimum(t1s[None, :], e)
              - np.maximum(t0s[None, :], e - window_s))
        watts = (np.clip(ov, 0.0, None) * dens[None, :]).sum(axis=1)
        if after is not None:
            watts = watts[ends[i:i + 1024] > after]
        if watts.size:
            best = max(best, float(watts.max()))
    return best / window_s


class PowerCap:
    """Sliding-window watt budget over a ledger of executed queries."""

    def __init__(self, budget_w: float, window_s: float):
        if not math.isfinite(budget_w) or budget_w <= 0:
            raise ValueError(f"budget_w={budget_w} must be a finite "
                             f"positive power in watts")
        if not math.isfinite(window_s) or window_s <= 0:
            raise ValueError(f"window_s={window_s} must be a finite "
                             f"positive duration in seconds")
        self.budget_w = float(budget_w)
        self.window_s = float(window_s)
        # full history, append-only in time order (the engine is serial)
        self._t0: list[float] = []
        self._t1: list[float] = []
        self._j: list[float] = []
        self._gc = 0             # first segment still inside the window
        self.throttled_queries = 0
        self.throttle_s_total = 0.0

    # --- the ledger -------------------------------------------------------
    def __len__(self) -> int:
        return len(self._j)

    @property
    def total_j(self) -> float:
        return float(sum(self._j))

    def record(self, t0: float, t1: float, joules: float,
               natural_s: float | None = None) -> None:
        """Append one executed query's (uniform-power) segment. With
        `natural_s` (the un-throttled service time) the cap also keeps
        the throttle statistics its report() publishes — callers that
        stretch service via throttled_service_s should pass it."""
        if not (math.isfinite(t0) and math.isfinite(t1)) or t1 < t0:
            raise ValueError(f"segment [{t0}, {t1}] is not a forward "
                             f"time interval")
        if not math.isfinite(joules) or joules < 0:
            raise ValueError(f"joules={joules} must be finite and "
                             f"non-negative")
        if joules > 0 and t1 == t0:
            raise ValueError(f"{joules} J over a zero-length segment is "
                             f"infinite power; stretch the service time")
        if self._t0 and t0 < self._t0[-1]:
            raise ValueError(
                f"segment start {t0} precedes the previous segment's "
                f"start {self._t0[-1]}; the ledger is time-ordered "
                f"(queries execute serially on one clock)")
        self._t0.append(float(t0))
        self._t1.append(float(t1))
        self._j.append(float(joules))
        if natural_s is not None and t1 - t0 > natural_s:
            self.throttled_queries += 1
            self.throttle_s_total += (t1 - t0) - natural_s

    def _active(self, t_min: float) -> tuple:
        """Segments that can still overlap a window touching times past
        `t_min`; the pointer only moves forward (time is monotone)."""
        while self._gc < len(self._t1) and self._t1[self._gc] <= t_min:
            self._gc += 1
        sl = slice(self._gc, None)
        return (np.asarray(self._t0[sl]), np.asarray(self._t1[sl]),
                np.asarray(self._j[sl]))

    def window_j(self, t_end: float) -> float:
        """Energy inside the window ending at `t_end`."""
        a = t_end - self.window_s
        j = 0.0
        for t0, t1, e in zip(self._t0, self._t1, self._j):
            dur = t1 - t0
            ov = min(t1, t_end) - max(t0, a)
            if dur > 0 and ov > 0:
                j += e * ov / dur
        return j

    def watts(self, t_end: float) -> float:
        """Window-average power of the window ending at `t_end`."""
        return self.window_j(t_end) / self.window_s

    def max_window_watts(self) -> float:
        """Exact supremum over all windows, whole recorded history."""
        return _max_window_watts(np.asarray(self._t0),
                                 np.asarray(self._t1),
                                 np.asarray(self._j), self.window_s)

    # --- the governor -----------------------------------------------------
    def throttled_service_s(self, now: float, joules: float,
                            natural_s: float) -> float:
        """Minimal wall service >= `natural_s` such that executing
        `joules` over (now, now + s) keeps every window at or under
        budget. Pure query — does not record; callers record() the
        segment once the query actually runs."""
        if not math.isfinite(natural_s) or natural_s < 0:
            raise ValueError(f"natural_s={natural_s} must be finite and "
                             f"non-negative")
        if not math.isfinite(joules) or joules < 0:
            raise ValueError(f"joules={joules} must be finite and "
                             f"non-negative")
        if joules == 0.0:
            return natural_s
        t0s, t1s, js = self._active(now - self.window_s)
        limit = self.budget_w * (1.0 + _TOL)

        def ok(s: float) -> bool:
            if not now + s > now:
                # s underflowed below ulp(now): the trial segment would
                # collapse to zero length, its joules vanishing from the
                # window check (and record() would rightly refuse it)
                return False
            # only windows ending past `now` hold part of the trial
            # segment; those ending earlier were governed when their
            # segments ran. The reference checks them again, and a
            # ledger the bisection left at the limit can then read one
            # rounding above it in the new sum, which refuses every s
            # (ROADMAP.md, queue 3); where it does not, the two agree
            return _max_window_watts(
                np.append(t0s, now), np.append(t1s, now + s),
                np.append(js, joules), self.window_s,
                after=now) <= limit

        # a zero-length segment has infinite power; seed lo with any
        # strictly positive floor so the bisection interval is real
        lo = max(natural_s, 1e-300)
        if ok(lo):
            return lo
        # the query alone needs joules / budget_w seconds; past-ledger
        # congestion can push further — double until feasible
        hi = max(lo, self.window_s, joules / self.budget_w)
        for _ in range(200):
            if ok(hi):
                break
            hi *= 2.0
        else:  # pragma: no cover - ledger invariant keeps this unreachable
            raise RuntimeError(
                f"power cap {self.budget_w} W cannot be met for a "
                f"{joules} J query; the recorded ledger already saturates "
                f"the budget")
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if ok(mid):
                hi = mid
            else:
                lo = mid
        return hi        # the feasible endpoint, verified by ok()

    # --- reporting --------------------------------------------------------
    def report(self, now: float | None = None) -> dict:
        peak = self.max_window_watts()
        return {
            "budget_w": self.budget_w,
            "window_s": self.window_s,
            "segments": len(self),
            "total_j": self.total_j,
            "max_window_w": peak,
            "budget_utilization": peak / self.budget_w,
            "current_w": self.watts(now) if now is not None else None,
            "throttled_queries": self.throttled_queries,
            "throttle_s_total": self.throttle_s_total,
        }
