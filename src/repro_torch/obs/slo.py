"""Multi-window multi-burn-rate SLO alerting on the VirtualClock.

The SRE playbook's alerting structure, transplanted onto modeled time: a
tenant's error budget is `1 - target` of its events; the *burn rate* over
a window is `windowed_error_rate / (1 - target)` (burn 1.0 = spending the
budget exactly at the sustainable pace). A rule pairs a long window (is
the burn real?) with a short window (is it still happening?) and fires
only when BOTH exceed its threshold — the long window suppresses blips,
the short one makes alerts resolve promptly when the burn stops. Two
default rules (a fast/high-threshold pair for page-worthy burns and a
slow/low-threshold pair for budget leaks) are scaled off the monitor's
cadence, since our virtual runs last seconds, not weeks.

Determinism contract (pinned by tests/test_torch_obs_analysis.py): the
monitor samples only at cadence ticks whose timestamps are *computed* as
`tick_index * cadence_s` — one multiplication, never float accumulation
— and every input is modeled (VirtualClock) time, so two same-seed chaos
replays emit byte-identical `alerts_json()` streams.

Error events: an SLA miss, a degraded (typed-failure) answer, or an
admission/shed rejection — the same definition `serve.sla.SLAReport.met`
and the rejected ledger use, so attainment here reconciles with
`summarize()`.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass

from repro_torch.obs.timeseries import RingSeries


@dataclass(frozen=True)
class BurnRateRule:
    """One (long window, short window, threshold) alerting pair."""

    name: str
    long_s: float
    short_s: float
    threshold: float

    def __post_init__(self):
        if self.long_s <= 0 or self.short_s <= 0:
            raise ValueError(f"rule {self.name!r}: windows must be "
                             f"positive, got long={self.long_s} "
                             f"short={self.short_s}")
        if self.short_s > self.long_s:
            raise ValueError(f"rule {self.name!r}: short window "
                             f"{self.short_s} exceeds long window "
                             f"{self.long_s}")
        if self.threshold <= 0:
            raise ValueError(f"rule {self.name!r}: threshold must be "
                             f"positive, got {self.threshold}")


def default_rules(cadence_s: float) -> tuple:
    """The fast-page / slow-leak pair, scaled to the virtual cadence."""
    return (BurnRateRule("fast_burn", long_s=16 * cadence_s,
                         short_s=2 * cadence_s, threshold=4.0),
            BurnRateRule("slow_burn", long_s=64 * cadence_s,
                         short_s=8 * cadence_s, threshold=1.5))


@dataclass(frozen=True)
class Alert:
    """One deterministic alert transition at a virtual timestamp."""

    t: float
    kind: str                # "fire" | "resolve"
    rule: str
    tenant: int
    burn_long: float
    burn_short: float
    budget_remaining: float  # fraction of the whole-run budget left

    def as_dict(self) -> dict:
        return {"t": self.t, "kind": self.kind, "rule": self.rule,
                "tenant": self.tenant, "burn_long": self.burn_long,
                "burn_short": self.burn_short,
                "budget_remaining": self.budget_remaining}


class _TenantLedger:
    """Cumulative event/error counters + their sampled ring series."""

    __slots__ = ("events", "errors", "events_series", "errors_series")

    def __init__(self, tenant: int, capacity: int):
        self.events = 0
        self.errors = 0
        self.events_series = RingSeries(f"tenant{tenant}.events",
                                        capacity=capacity)
        self.errors_series = RingSeries(f"tenant{tenant}.errors",
                                        capacity=capacity)


class SLOMonitor:
    """Per-tenant burn-rate alerting fed by an engine's SLA stream.

    Wire it with `QueryEngine(monitor=...)` (or
    `replay_trace(monitor=...)`): the engine calls `observe` per served
    query, `observe_rejected` per admission/shed rejection, and `tick`
    after each service charge moves the VirtualClock. Standalone use
    follows the same three calls.
    """

    def __init__(self, *, target: float = 0.9, cadence_s: float = 0.01,
                 rules: tuple | None = None, capacity: int = 4096):
        if not (0.0 < target < 1.0):
            raise ValueError(f"target={target} must be in (0, 1): "
                             f"target 1.0 leaves a zero error budget and "
                             f"every error is an infinite burn")
        if not math.isfinite(cadence_s) or cadence_s <= 0:
            raise ValueError(f"cadence_s={cadence_s} must be a finite "
                             f"positive interval")
        self.target = float(target)
        self.cadence_s = float(cadence_s)
        self.rules = tuple(rules) if rules is not None \
            else default_rules(cadence_s)
        self.capacity = int(capacity)
        self.engine = None
        self.tenants: dict[int, _TenantLedger] = {}
        self.series: dict[str, RingSeries] = {}
        self.alerts: list[Alert] = []
        self._active: set = set()        # (rule.name, tenant) firing now
        self._next_tick = 0              # first not-yet-sampled tick index
        # widest lookback any rule needs, in ticks (for ring sizing docs)
        self.max_window_s = max((r.long_s for r in self.rules),
                                default=0.0)

    # --- wiring -----------------------------------------------------------
    def bind(self, engine) -> None:
        """Attach the engine whose gauges (blended rate, hit rate, watts,
        recovery/prefetch bytes) each tick samples. Requires tiered mode:
        gauges and tick timestamps live on the modeled clock."""
        if engine.tiered is None:
            raise ValueError(
                "SLOMonitor samples on the modeled (VirtualClock) "
                "timeline; pass tiered=repro.tier.PlacementEngine(...) "
                "to the engine as well")
        self.engine = engine

    def _ledger(self, tenant: int) -> _TenantLedger:
        led = self.tenants.get(tenant)
        if led is None:
            led = self.tenants[tenant] = _TenantLedger(tenant,
                                                       self.capacity)
        return led

    def _series(self, name: str) -> RingSeries:
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = RingSeries(name,
                                               capacity=self.capacity)
        return s

    # --- event intake -----------------------------------------------------
    def observe(self, report, *, tenant: int = 0) -> None:
        """One served query's SLAReport: an event, and an error unless
        its deadline was met with a full answer."""
        led = self._ledger(tenant)
        led.events += 1
        led.errors += not report.met

    def observe_rejected(self, *, tenant: int = 0) -> None:
        """An admission or shed rejection: the promise was broken before
        service, which burns budget exactly like a miss."""
        led = self._ledger(tenant)
        led.events += 1
        led.errors += 1

    # --- sampling + rule evaluation ---------------------------------------
    def tick(self, t: float) -> list:
        """Sample every cadence boundary in (last sampled, t] and
        evaluate all rules at each; returns alerts emitted by this call.
        Tick i's timestamp is exactly `i * cadence_s`."""
        emitted: list[Alert] = []
        while self._next_tick * self.cadence_s <= t:
            ts = self._next_tick * self.cadence_s
            self._sample(ts)
            emitted.extend(self._evaluate(ts))
            self._next_tick += 1
        return emitted

    def _sample(self, ts: float) -> None:
        for led in self.tenants.values():
            led.events_series.push(ts, led.events)
            led.errors_series.push(ts, led.errors)
        eng = self.engine
        if eng is None:
            return
        pe = eng.tiered
        chips = eng.n_shards
        self._series("blended_gbps").push(
            ts, pe.blended_measured_bps(chips) / 1e9)
        self._series("hit_rate").push(ts, pe.hit_rate)
        self._series("recovery_bytes").push(ts, pe.recovery_bytes_total)
        self._series("prefetch_bytes").push(
            ts, pe.prefetch_streamed_bytes_total)
        if eng.power_cap is not None:
            self._series("watts").push(ts, eng.power_cap.watts(ts))
            self._series("cap_w").push(ts, eng.power_cap.budget_w)

    def _windowed_burn(self, led: _TenantLedger, ts: float,
                       window_s: float) -> float:
        """Burn rate over (ts - window, ts]: windowed error rate divided
        by the budget rate. Windows with no events burn 0.0."""
        ev1, er1 = led.events, led.errors
        ev0 = led.events_series.at_or_before(ts - window_s) or 0.0
        er0 = led.errors_series.at_or_before(ts - window_s) or 0.0
        events = ev1 - ev0
        if events <= 0:
            return 0.0
        return ((er1 - er0) / events) / (1.0 - self.target)

    def _evaluate(self, ts: float) -> list:
        emitted: list[Alert] = []
        for tenant in sorted(self.tenants):
            led = self.tenants[tenant]
            for rule in self.rules:
                burn_l = self._windowed_burn(led, ts, rule.long_s)
                burn_s = self._windowed_burn(led, ts, rule.short_s)
                key = (rule.name, tenant)
                firing = key in self._active
                if not firing and burn_l >= rule.threshold \
                        and burn_s >= rule.threshold:
                    self._active.add(key)
                    emitted.append(self._alert(ts, "fire", rule, tenant,
                                               burn_l, burn_s))
                elif firing and burn_s < rule.threshold:
                    self._active.discard(key)
                    emitted.append(self._alert(ts, "resolve", rule,
                                               tenant, burn_l, burn_s))
        self.alerts.extend(emitted)
        return emitted

    def _alert(self, ts, kind, rule, tenant, burn_l, burn_s) -> Alert:
        return Alert(t=ts, kind=kind, rule=rule.name, tenant=tenant,
                     burn_long=burn_l, burn_short=burn_s,
                     budget_remaining=self.error_budget(tenant)
                     ["remaining_fraction"])

    # --- reporting --------------------------------------------------------
    def error_budget(self, tenant: int = 0) -> dict:
        """Whole-run budget arithmetic: budget = (1 - target) * events;
        remaining_fraction < 0 means the tenant is over budget."""
        led = self.tenants.get(tenant)
        events = led.events if led is not None else 0
        errors = led.errors if led is not None else 0
        budget = (1.0 - self.target) * events
        return {
            "tenant": tenant,
            "events": events,
            "errors": errors,
            "budget_events": budget,
            "remaining_fraction": (1.0 - errors / budget) if budget > 0
            else 1.0,
        }

    def alerts_json(self) -> str:
        """The canonical alert stream: sorted keys, compact separators —
        the byte-identical-replay artifact."""
        return json.dumps([a.as_dict() for a in self.alerts],
                          sort_keys=True, separators=(",", ":"))

    def summary(self) -> dict:
        return {
            "target": self.target,
            "cadence_s": self.cadence_s,
            "rules": [{"name": r.name, "long_s": r.long_s,
                       "short_s": r.short_s, "threshold": r.threshold}
                      for r in self.rules],
            "ticks": self._next_tick,
            "alerts": len(self.alerts),
            "firing": sorted(self._active),
            "tenants": {t: self.error_budget(t)
                        for t in sorted(self.tenants)},
        }
