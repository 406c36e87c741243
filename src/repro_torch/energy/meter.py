"""Per-query energy metering: the joules ledger behind the paper's verdict
(counterpart of repro/energy/meter.py; numpy and Python, no device work).

The paper's conclusion is not that die-stacking is fast — it is that
die-stacked *power* is up to 50x higher, so the decision depends on SLA,
power, and cost jointly. The ledger charges every query:

- *memory* joules from the bytes it streamed per tier (fast vs capacity,
  each at its tier's `energy_per_byte` — the same Table-1 derivation as
  `TierPair.energy_j`), and
- *compute* joules from the compute chip's power times the *modeled busy
  time* on the `serve.sla.VirtualClock` (the paper's Eq. 7 compute term,
  per query instead of per cluster).

Every charge carries the query id and tenant, so the meter answers the
questions a production bill needs: joules per query, watts per tenant,
fast-vs-capacity-vs-compute breakdown — and its window'd form feeds the
`PowerCap` governor (repro_torch.energy.caps); the $/query TCO model
is ROADMAP.md's step 7.

Compute energy is charged at *busy* (natural) service time: a power-capped
query that gets throttled stretches its wall time, but the chip
races-to-idle — the work (and its joules) does not grow with the wait.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

if TYPE_CHECKING:   # annotation-only: tier.placement imports this module
    from repro_torch.tier.tiers import TierPair


def chip_compute_watts(system, cores: int | None = None) -> float:
    """Eq. 7's per-chip compute power from a Table-1 `SystemSpec`:
    enabled cores x W/core (default: the cores that saturate the chip's
    bandwidth — the paper's scan regime)."""
    n = system.saturating_cores if cores is None else cores
    if not 1 <= n <= system.max_chip_cores:
        raise ValueError(f"cores={n} outside [1, {system.max_chip_cores}] "
                         f"for {system.name!r}")
    return n * system.core_power


@dataclass
class EnergyCharge:
    """One query's line on the bill: bytes moved, joules per component."""

    qid: int | None
    tenant: int | None
    fast_bytes: int
    capacity_bytes: int
    fast_j: float
    capacity_j: float
    compute_j: float = 0.0
    busy_s: float = 0.0          # modeled busy time the compute term used
    kind: str = "query"          # "query" | "recovery" (retry/repair
    #                              bytes) | "prefetch" (overlap traffic:
    #                              staged fast re-reads + cancelled waste)

    @property
    def memory_j(self) -> float:
        return self.fast_j + self.capacity_j

    @property
    def total_j(self) -> float:
        return self.memory_j + self.compute_j

    def as_dict(self) -> dict:
        return {
            "qid": self.qid, "tenant": self.tenant,
            "fast_bytes": self.fast_bytes,
            "capacity_bytes": self.capacity_bytes,
            "fast_j": self.fast_j, "capacity_j": self.capacity_j,
            "compute_j": self.compute_j, "total_j": self.total_j,
            "busy_s": self.busy_s, "kind": self.kind,
        }


@dataclass
class EnergyMeter:
    """The joules ledger for one placement domain.

    `tiers` prices the memory term; `compute_w` is the per-chip compute
    power (0.0 keeps the meter bit-compatible with the old memory-only
    scalar — see `memory_j`, which is exactly what
    `PlacementEngine.energy_j_total` used to accumulate).
    """

    tiers: TierPair
    compute_w: float = 0.0
    charges: list[EnergyCharge] = field(default_factory=list)

    def __post_init__(self):
        if not math.isfinite(self.compute_w) or self.compute_w < 0:
            raise ValueError(f"compute_w={self.compute_w} must be a finite "
                             f"non-negative power in watts")

    # --- charging ---------------------------------------------------------
    def charge(self, fast_bytes: int, capacity_bytes: int, *,
               qid: int | None = None, tenant: int | None = None,
               kind: str = "query") -> EnergyCharge:
        """Open a query's charge with its memory term (bytes validated,
        per-tier pricing single-sourced in TierPair.energy_components);
        the compute term lands via charge_compute once the modeled
        service time is known. `kind` separates nominal query lines from
        "recovery" lines (retry/failover/repair traffic) so fault
        overhead is auditable on the bill."""
        fast_j, capacity_j = self.tiers.energy_components(fast_bytes,
                                                          capacity_bytes)
        ch = EnergyCharge(
            qid=qid, tenant=tenant,
            fast_bytes=int(fast_bytes), capacity_bytes=int(capacity_bytes),
            fast_j=fast_j, capacity_j=capacity_j, kind=str(kind))
        self.charges.append(ch)
        return ch

    def charge_compute(self, ch: EnergyCharge, busy_s: float,
                       chips: int = 1) -> EnergyCharge:
        """Add the compute term: compute_w x chips x modeled busy seconds."""
        if not math.isfinite(busy_s) or busy_s < 0:
            raise ValueError(f"busy_s={busy_s} must be finite and "
                             f"non-negative")
        ch.compute_j += self.compute_w * chips * busy_s
        ch.busy_s += busy_s
        return ch

    # --- totals -----------------------------------------------------------
    @property
    def fast_j(self) -> float:
        return sum(c.fast_j for c in self.charges)

    @property
    def capacity_j(self) -> float:
        return sum(c.capacity_j for c in self.charges)

    @property
    def compute_j(self) -> float:
        return sum(c.compute_j for c in self.charges)

    @property
    def memory_j(self) -> float:
        """The old `PlacementEngine.energy_j_total` scalar: per-tier byte
        energy only. Kept as an exact sum of the ledger's memory lines so
        the tier module's `stats()["energy_j"]` stays bit-compatible."""
        return sum(c.memory_j for c in self.charges)

    @property
    def total_j(self) -> float:
        return sum(c.total_j for c in self.charges)

    def by_tenant(self) -> dict:
        """tenant -> {queries, fast_j, capacity_j, compute_j, total_j}."""
        out: dict = {}
        for c in self.charges:
            t = out.setdefault(c.tenant, {
                "queries": 0, "fast_j": 0.0, "capacity_j": 0.0,
                "compute_j": 0.0, "total_j": 0.0})
            # recovery lines bill joules to the tenant without counting
            # as queries — j_per_query stays joules per *served* query
            t["queries"] += 1 if c.kind == "query" else 0
            t["fast_j"] += c.fast_j
            t["capacity_j"] += c.capacity_j
            t["compute_j"] += c.compute_j
            t["total_j"] += c.total_j
        return out

    @property
    def recovery_j(self) -> float:
        """Joules on kind="recovery" lines — what the faults cost."""
        return sum(c.total_j for c in self.charges if c.kind == "recovery")

    @property
    def prefetch_j(self) -> float:
        """Joules on kind="prefetch" lines — what the overlap cost (staged
        fast-buffer re-reads plus streamed-then-cancelled waste; the
        nominal capacity stream stays on the query line, charged once)."""
        return sum(c.total_j for c in self.charges if c.kind == "prefetch")

    def summary(self) -> dict:
        n = sum(1 for c in self.charges if c.kind == "query")
        return {
            "queries": n,
            "recovery_j": self.recovery_j,
            "prefetch_j": self.prefetch_j,
            "fast_j": self.fast_j,
            "capacity_j": self.capacity_j,
            "compute_j": self.compute_j,
            "memory_j": self.memory_j,
            "total_j": self.total_j,
            "j_per_query": self.total_j / n if n else 0.0,
            "compute_w": self.compute_w,
            "by_tenant": self.by_tenant(),
        }
