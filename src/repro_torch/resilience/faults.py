"""Deterministic seeded fault injection on the modeled time axis
(counterpart of repro/resilience/faults.py).

Every provisioning answer upstream assumes a fault-free machine; this
module makes the machine lie on purpose, reproducibly. A `FaultInjector`
draws every fault decision from a generator keyed by *(seed, event key)*
through `numpy.random.SeedSequence`, so the fault stream is a pure
function of the spec — independent of execution order, retries, or how
many other faults fired first. Replaying the same trace with the same
seed injects byte-identical faults (examples/chaos_replay.py), and fault
timing rides the `serve.sla.VirtualClock`: stalls are modeled service
penalties, never wall-clock sleeps.

Fault classes (all optional, rates in [0, 1]):

- *tier-read stalls / stragglers*: a fast-tier chunk read takes
  `stall_factor` x its nominal time (a flaky stack channel / row-hammer
  refresh storm) — the fault the RetryPolicy and CircuitBreaker exist
  for;
- *shard dropout*: a query arrives while one shard of the mesh is gone;
  degraded execution re-runs that shard's rows from the capacity tier
  (repro_torch.resilience.recover) or the query fails typed;
- *chunk payload corruption*: a bit flips in a stored compressed chunk
  (repro_torch.store); per-chunk checksums detect it on read —
  corruption is never silently aggregated;
- *torn file writes*: a heartbeat or tune-cache file is truncated
  mid-write (`tear_file`) — the reader-side contract is that a torn file
  reads as missing/miss, never as garbage.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from dataclasses import dataclass, fields
from pathlib import Path

import numpy as np


def _key_ints(parts: tuple) -> list[int]:
    """Stable uint32 words from a mixed (str/int) event key — crc32 for
    strings so the entropy is platform- and run-independent (Python's
    hash() is salted per process and would break replay)."""
    out = []
    for p in parts:
        if isinstance(p, str):
            out.append(zlib.crc32(p.encode()))
        elif isinstance(p, (int, np.integer)):
            out.append(int(p) & 0xFFFFFFFF)
        else:
            raise TypeError(f"fault event keys are strings and ints, got "
                            f"{type(p).__name__!r}")
    return out


@dataclass(frozen=True)
class FaultSpec:
    """Rates and shapes of the injected fault classes (one seed drives
    every draw; rate 0.0 disables a class)."""

    seed: int = 0
    stall_rate: float = 0.0        # P[a fast-tier chunk read stalls]
    stall_factor: float = 8.0      # stalled read takes factor x nominal
    corrupt_rate: float = 0.0      # P[a stored chunk has a flipped bit]
    shard_loss_rate: float = 0.0   # P[a query sees one shard dropped]

    def __post_init__(self):
        for f in ("stall_rate", "corrupt_rate", "shard_loss_rate"):
            v = getattr(self, f)
            if not (math.isfinite(v) and 0.0 <= v <= 1.0):
                raise ValueError(f"{f}={v} must be a probability in [0, 1]")
        if not math.isfinite(self.stall_factor) or self.stall_factor < 1.0:
            raise ValueError(
                f"stall_factor={self.stall_factor} must be >= 1; a stall "
                f"that finishes early is not a fault")

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


class FaultInjector:
    """Draws every fault decision of a chaos run from `FaultSpec.seed`.

    Each event gets its own generator seeded by (seed, event key), so
    decisions commute: whether chunk A's read stalls does not depend on
    whether chunk B was checked first, and a replay probes the same
    stream in any order.
    """

    def __init__(self, spec: FaultSpec):
        self.spec = spec

    def _rng(self, *key) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.spec.seed & 0xFFFFFFFF,
                                    *_key_ints(key)]))

    # --- tier-read stalls -------------------------------------------------
    def stalled(self, qid: int, cid: tuple, attempt: int) -> bool:
        """Does read `attempt` of chunk `cid` by query `qid` stall?
        Retries re-draw (a straggling channel usually recovers)."""
        if self.spec.stall_rate <= 0.0:
            return False
        r = self._rng("stall", qid, cid[0], cid[1], attempt)
        return bool(r.random() < self.spec.stall_rate)

    # --- shard dropout ----------------------------------------------------
    def lost_shards(self, qid: int, n_shards: int) -> tuple[int, ...]:
        """Shard indices missing while query `qid` executes (at most one
        per query — correlated multi-shard loss is a test-only scenario
        exercised through recover.execute_degraded directly)."""
        if self.spec.shard_loss_rate <= 0.0 or n_shards <= 1:
            return ()
        r = self._rng("shard", qid)
        if r.random() >= self.spec.shard_loss_rate:
            return ()
        return (int(r.integers(n_shards)),)

    # --- stored-chunk corruption ------------------------------------------
    def corrupt_chunks(self, ids) -> list:
        """The subset of (column, chunk-index) ids whose payload gets a
        flipped bit — decided per chunk, independent of list order."""
        if self.spec.corrupt_rate <= 0.0:
            return []
        out = []
        for name, ci in ids:
            if self._rng("corrupt", name, ci).random() \
                    < self.spec.corrupt_rate:
                out.append((name, ci))
        return out

    def flip_bit(self, chunk, name: str, ci: int):
        """A copy of a store.encode.EncodedChunk with one payload bit
        flipped (the plane copied, XORed on its device; the sealed
        checksum kept, so it no longer verifies), or None for a chunk with
        no payload to corrupt (zero rows). The chunk itself is untouched:
        install the copy with EncodedColumn.replace_chunk, which also
        drops the planes cached from the old chunks. The drawn position
        and bit are the reference's: a bit below 2^30 of a values plane,
        below 2^31 of a words plane, both inside int32."""
        r = self._rng("flip", name, ci)
        for plane, top in (("values", 30), ("words", 31)):
            src = getattr(chunk, plane)
            if src is not None and src.numel():
                i = int(r.integers(src.numel()))
                out = src.clone()
                out[i] ^= 1 << int(r.integers(top))
                return dataclasses.replace(chunk, **{plane: out})
        return None

    # --- torn file writes -------------------------------------------------
    def tear_file(self, path, event: str = "tear") -> bool:
        """Truncate `path` at a seeded fraction of its length — the torn
        write a crashed host leaves behind when it writes in place
        instead of mkstemp + os.replace. Returns False on empty/missing
        files (nothing to tear)."""
        p = Path(path)
        if not p.exists():
            return False
        raw = p.read_bytes()
        if not raw:
            return False
        r = self._rng(event, str(p.name))
        p.write_bytes(raw[:int(r.integers(len(raw)))])
        return True
