"""Distribution substrate: logical-axis sharding, sharding strategies,
fault tolerance, gradient compression, and pipeline parallelism
(counterpart of repro/dist).

Models never name mesh axes directly — they annotate arrays with logical
axis names and this package resolves those names to mesh axes through
per-cell rule tables, optionally overridden by a named strategy.

Ported: `fault_tolerance` (heartbeats, straggler detection, supervised
crash-restart). Sharding, strategies, compression and pipeline
parallelism are ROADMAP.md's queue-1 step 10c.
"""
