"""repro_torch.resilience: deterministic chaos + the recovery it exercises
(counterpart of repro.resilience).

This package injects seeded, replayable faults on the modeled clock
(faults.FaultInjector), and supplies the recovery machinery — checksum
verify-on-read with re-encode-from-oracle repair (recover.ChunkGuard),
SLA-aware retry/backoff with failover (retry.RetryPolicy), degraded-mode
shard re-execution (recover.execute_degraded,
recover.execute_grouped_degraded), and a circuit breaker demoting a
faulting fast tier (recover.CircuitBreaker) — wired into the query path
by harness.ChaosHarness via QueryEngine(chaos=...). Everything but the
degraded re-execution (the kernels, on the card) is numpy and Python on
the host.
"""
from repro_torch.resilience.faults import FaultInjector, FaultSpec
from repro_torch.resilience.harness import ChaosHarness
from repro_torch.resilience.recover import (ChunkCorruptionError, ChunkGuard,
                                            CircuitBreaker,
                                            DegradedResultError,
                                            execute_degraded,
                                            execute_grouped_degraded)
from repro_torch.resilience.retry import RetryPolicy

__all__ = [
    "ChaosHarness",
    "ChunkCorruptionError",
    "ChunkGuard",
    "CircuitBreaker",
    "DegradedResultError",
    "FaultInjector",
    "FaultSpec",
    "RetryPolicy",
    "execute_degraded",
    "execute_grouped_degraded",
]
