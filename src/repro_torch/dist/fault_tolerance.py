"""Fault tolerance: file-based heartbeats, straggler detection, and
supervised crash-restart (counterpart of repro/dist/fault_tolerance.py,
which imports no framework: the code is the reference's).

All host-side and dependency-free: heartbeats are one JSON file per host in
a shared directory (the multi-host lowest common denominator — works over
NFS/GCS-fuse), the straggler detector is a median filter over step times,
and `run_supervised` restarts a training loop from its latest checkpoint up
to a restart budget (tests assert bitwise-identical resumption).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path


class Heartbeat:
    """Per-host liveness + progress beacon over a shared directory.

    `clock` defaults to wall time; chaos tests and the resilience
    harness inject a VirtualClock so liveness verdicts are deterministic
    (dead_hosts at modeled time, no sleeps, no flakes).
    """

    def __init__(self, directory, host: str, timeout_s: float = 30.0,
                 clock=time.time):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host = host
        self.timeout_s = timeout_s
        self.clock = clock

    def _path(self, host: str) -> Path:
        return self.dir / f"{host}.heartbeat"

    def beat(self, step: int) -> None:
        # mkstemp + os.replace (the tune-cache idiom): with_suffix would
        # mangle dotted host names ("node.0.heartbeat" -> "node.0.tmp",
        # clobbering a sibling host's temp file) and an in-place write
        # could be read torn; a rename is atomic on POSIX
        final = self._path(self.host)
        fd, tmp = tempfile.mkstemp(dir=self.dir, prefix=final.name + ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps({"host": self.host, "step": int(step),
                                    "time": self.clock()}))
            os.replace(tmp, final)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise

    def _read_all(self) -> dict:
        out = {}
        for p in sorted(self.dir.glob("*.heartbeat")):
            try:
                rec = json.loads(p.read_text())
                out[rec["host"]] = rec
            except (ValueError, KeyError, OSError):
                continue
        return out

    def fleet(self) -> list:
        return sorted(self._read_all())

    def dead_hosts(self) -> list:
        now = self.clock()
        return sorted(h for h, rec in self._read_all().items()
                      if now - rec["time"] > self.timeout_s)

    def lagging_hosts(self, behind_steps: int) -> list:
        recs = self._read_all()
        if not recs:
            return []
        lead = max(rec["step"] for rec in recs.values())
        return sorted(h for h, rec in recs.items()
                      if rec["step"] < lead - behind_steps + 1)


class StragglerDetector:
    """Flags steps slower than `threshold` x the median of clean steps.

    Flagged steps are excluded from the baseline so one straggler does not
    poison the median and mask the next one.
    """

    def __init__(self, threshold: float = 2.0, warmup: int = 3,
                 window: int = 50):
        self.threshold = threshold
        self.warmup = warmup
        self.window = window
        self._clean: list = []
        self.flagged: list = []
        self.ewma = 0.0

    def observe(self, step: int, seconds: float) -> bool:
        self.ewma = (seconds if not self._clean
                     else 0.9 * self.ewma + 0.1 * seconds)
        if len(self._clean) >= self.warmup:
            baseline = statistics.median(self._clean[-self.window:])
            if seconds > self.threshold * baseline:
                self.flagged.append((step, seconds))
                return True
        self._clean.append(seconds)
        return False


@dataclass
class RestartPolicy:
    max_restarts: int = 2
    backoff_s: float = 0.0       # linear backoff: restart k waits k * this
    restarts: int = 0
    failures: list = field(default_factory=list)

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError(f"max_restarts={self.max_restarts} must be "
                             f">= 0")
        if not math.isfinite(self.backoff_s) or self.backoff_s < 0:
            raise ValueError(f"backoff_s={self.backoff_s} must be finite "
                             f"and non-negative")

    def backoff(self, restart: int) -> float:
        """Seconds to wait before restart number `restart` (1-based)."""
        if restart < 1:
            raise ValueError(f"restart={restart} must be >= 1")
        return self.backoff_s * restart


def run_supervised(loop, restore, policy: RestartPolicy, clock=None):
    """Run `loop(state)` under crash-restart supervision.

    `restore()` produces the state to (re)start from — typically the latest
    checkpoint. Each restart waits `policy.backoff(k)` first: on the wall
    clock by default, or on an injected advanceable clock (e.g.
    repro_torch.serve.sla.VirtualClock) so supervised chaos tests model the backoff
    instead of sleeping it. Re-raises once the restart budget is
    exhausted. Returns (final_state, policy).
    """
    state = restore()
    while True:
        try:
            return loop(state), policy
        except Exception as e:  # noqa: BLE001 — any crash is restartable
            policy.failures.append(repr(e))
            policy.restarts += 1
            if policy.restarts > policy.max_restarts:
                raise
            delay = policy.backoff(policy.restarts)
            if delay:
                if clock is not None and hasattr(clock, "advance"):
                    clock.advance(delay)
                else:
                    time.sleep(delay)
            state = restore()
