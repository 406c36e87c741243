"""Fixed-cadence ring-buffer time series on the VirtualClock.

Samples are pushed only at the SLOMonitor's cadence ticks — never on the
wall clock — so a series is a pure function of (workload, seed) and two
same-seed chaos replays produce identical buffers. The ring keeps the
most recent `capacity` samples; burn-rate windows are bounded, so old
samples age out without unbounded growth.

Timestamps are *computed*, not accumulated: tick i lives at
`i * cadence_s` (one multiplication), so timestamps are bitwise
reproducible regardless of how many pushes happened — the determinism
the SLO alert stream inherits.
"""
from __future__ import annotations


class RingSeries:
    """A bounded (t, value) series with time-window queries.

    Push order must be non-decreasing in t (the monitor's cadence
    guarantees it); lookups assume that order.
    """

    __slots__ = ("name", "capacity", "_t", "_v")

    def __init__(self, name: str, *, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.name = name
        self.capacity = int(capacity)
        self._t: list[float] = []
        self._v: list[float] = []

    def __len__(self) -> int:
        return len(self._t)

    def push(self, t: float, value: float) -> None:
        if self._t and t < self._t[-1]:
            raise ValueError(
                f"series {self.name!r}: push at t={t!r} before "
                f"last sample t={self._t[-1]!r}")
        self._t.append(float(t))
        self._v.append(float(value))
        if len(self._t) > self.capacity:
            del self._t[0]
            del self._v[0]

    @property
    def last(self) -> float | None:
        return self._v[-1] if self._v else None

    @property
    def last_t(self) -> float | None:
        return self._t[-1] if self._t else None

    def at_or_before(self, t: float) -> float | None:
        """Latest value with sample time <= t (None before first sample
        still in the ring). Linear from the tail: burn windows look back
        a bounded number of ticks."""
        for i in range(len(self._t) - 1, -1, -1):
            if self._t[i] <= t:
                return self._v[i]
        return None

    def window(self, t_lo: float, t_hi: float) -> list:
        """Samples with t_lo < t <= t_hi, oldest first."""
        return [(t, v) for t, v in zip(self._t, self._v)
                if t_lo < t <= t_hi]

    def window_mean(self, t_lo: float, t_hi: float) -> float:
        """Mean over (t_lo, t_hi]; 0.0 when the window is empty (the
        same empty-series convention as metrics.Histogram.mean)."""
        w = self.window(t_lo, t_hi)
        if not w:
            return 0.0
        return sum(v for _, v in w) / len(w)

    def as_dict(self) -> dict:
        return {"name": self.name, "n": len(self._t),
                "t": list(self._t), "v": list(self._v)}
