"""SLA-aware request scheduler for the serving engine (counterpart of
repro/serve/scheduler.py, a copy with its imports re-pointed).

The paper provisions clusters against a response-time SLA; this module is
the runtime half of that contract for LM serving: requests carry deadlines,
admission/ordering runs through the shared EDF machinery in
`repro_torch.serve.sla` (also used by the analytic query engine), and the
summary reports attained-vs-promised latency so the advisor's provisioning
can be checked in production.

Pure host-side logic over ServeEngine — deterministic and unit-testable.
"""
from __future__ import annotations

import time

from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sla import DeadlineQueue, SLAReport, summarize


class SLAScheduler:
    """Earliest-deadline-first admission over a ServeEngine.

    decode_rate_tps: measured tokens/sec/slot (from a warmup run or the
    advisor's roofline estimate) used for feasibility-based admission
    control: a request is rejected (not silently late) if even an empty
    slot couldn't finish it by its deadline. A zero/unknown rate estimates
    infinitely slow decode, so only deadline-free requests are admitted.
    """

    def __init__(self, engine: ServeEngine, decode_rate_tps: float,
                 clock=time.monotonic):
        self.engine = engine
        self.rate = decode_rate_tps
        self.clock = clock
        self.queue = DeadlineQueue(clock, self._est_service_s)
        self.reports: list[SLAReport] = []

    def _est_service_s(self, req: Request) -> float:
        return req.max_new_tokens / max(self.rate, 1e-9)

    @property
    def rejected(self) -> list[int]:
        return [r.rid for r in self.queue.rejected]

    def submit(self, req: Request, deadline: float) -> bool:
        """deadline: absolute clock time by which generation must finish."""
        req._submitted_at = self.clock()  # type: ignore[attr-defined]
        return self.queue.push(req, deadline)

    def _admit(self):
        while True:
            got = self.queue.pop()        # sheds now-hopeless requests
            if got is None:
                return
            req, deadline = got
            if not self.engine.submit(req):
                self.queue.requeue(req, deadline)   # engine full; keep it
                return
            req._deadline = deadline      # type: ignore[attr-defined]

    def run(self) -> list[SLAReport]:
        while len(self.queue) or any(s is not None
                                     for s in self.engine.slots):
            self._admit()
            for r in self.engine.step():
                now = self.clock()
                self.reports.append(SLAReport(
                    rid=r.rid,
                    deadline=getattr(r, "_deadline", float("inf")),
                    submitted_at=getattr(r, "_submitted_at", now),
                    finished_at=now,
                    work=len(r.generated)))
        return self.reports

    def summary(self) -> dict:
        out = summarize(self.reports, rejected=len(self.queue.rejected))
        out["tokens"] = int(sum(r.work for r in self.reports))
        return out
