"""Block-size autotuner with an on-disk JSON cache (counterpart of
repro/kernels/tune.py).

- `best_params(op, shape_key, defaults)` — the hot-path lookup: returns the
  cached winner for (op, backend, shape) or the heuristic defaults.
  Never times anything, so op call latency is unaffected.
- `autotune(op, shape_key, candidates, bench)` — the timed sweep: runs
  `bench(params)` over the candidate grid, persists the winner to the JSON
  cache, and is a pure cache hit on every later call with the same key.

Cache keys are `op|backend|shape_key`, the backend being the torch device
type the port runs on by default ("cuda" with a card, else "cpu"), so
card and host tunings coexist in one file. The port's cache is its own
file, artifacts/torch_tune_cache.json (override with
REPRO_TORCH_TUNE_CACHE), written atomically; the reference's cache is
never read. `tier.measured_fast_gbps` prices the fast memory tier from
the scan sweeps recorded here. No kernel consults `best_params` yet
(ROADMAP.md, 12h).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import tempfile
import time
from pathlib import Path

import torch

_DEFAULT_PATH = Path(__file__).resolve().parents[3] / "artifacts" \
    / "torch_tune_cache.json"


def cache_path() -> Path:
    return Path(os.environ.get("REPRO_TORCH_TUNE_CACHE", _DEFAULT_PATH))


def backend() -> str:
    """The device type that keys the cache: the card's when there is one
    (the port's default device), else the host's."""
    return "cuda" if torch.cuda.is_available() else "cpu"


class TuneCache:
    """A {key: {params, us, sweep}} JSON file, loaded lazily."""

    def __init__(self, path=None):
        self.path = Path(path) if path else cache_path()
        self._data: dict | None = None

    def _load(self) -> dict:
        if self._data is None:
            try:
                self._data = json.loads(self.path.read_text())
            except (OSError, ValueError):
                self._data = {}
        return self._data

    @staticmethod
    def key(op: str, shape_key: str) -> str:
        return f"{op}|{backend()}|{shape_key}"

    def lookup(self, op: str, shape_key: str):
        return self._load().get(self.key(op, shape_key))

    def entries(self) -> dict:
        """All cached {key: entry} pairs (read-only view for consumers
        that scan the cache, e.g. repro_torch.tier.measured_fast_gbps)."""
        return dict(self._load())

    def store(self, op: str, shape_key: str, entry: dict) -> None:
        data = self._load()
        data[self.key(op, shape_key)] = entry
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # unique temp file per writer + atomic rename: concurrent runs may
        # lose each other's *entries* (last rename wins) but can never
        # interleave bytes into one file and leave it truncated
        fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                   prefix=self.path.name + ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(data, indent=1, sort_keys=True))
            os.replace(tmp, self.path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise


_cache: TuneCache | None = None


def get_cache() -> TuneCache:
    global _cache
    if _cache is None:
        _cache = TuneCache()
    return _cache


def set_cache_path(path) -> TuneCache:
    """Point the tuner at a different cache file (tests, sweeps); None
    goes back to the default path."""
    global _cache
    _cache = TuneCache(path)
    return _cache


def shape_key(**dims) -> str:
    """Canonical 'a=1,b=2' key fragment from shape-defining ints."""
    return ",".join(f"{k}={v}" for k, v in sorted(dims.items()))


def fit(n: int, block: int) -> int:
    """Largest divisor of n that is <= block (block-shape validity)."""
    block = max(1, min(int(block), int(n)))
    while n % block:
        block -= 1
    return block


def best_params(op: str, skey: str, defaults: dict) -> dict:
    """Hot-path lookup: cached winner for this (op, backend, shape) or the
    heuristic defaults. Unknown cached keys are ignored, so stale cache
    entries can't break an op whose tunables changed."""
    entry = get_cache().lookup(op, skey)
    if not entry:
        return dict(defaults)
    tuned = entry.get("params", {})
    return {k: tuned.get(k, v) for k, v in defaults.items()}


def autotune(op: str, skey: str, candidates: dict, bench,
             repeat: int = 3) -> dict:
    """Timed sweep over the candidate grid; persists + returns the entry.

    bench(params) runs the op once with those block sizes and waits for
    the device (torch.cuda.synchronize on the card). A candidate the op
    refuses for this shape (it raises ValueError) is skipped; any other
    error — a failed build, a CUDA error — propagates, so a sweep can
    never hide a kernel that does not run. A cache hit returns
    immediately without timing anything.
    """
    cache = get_cache()
    hit = cache.lookup(op, skey)
    if hit is not None:
        return hit
    sweep = []
    for combo in itertools.product(*candidates.values()):
        params = dict(zip(candidates.keys(), combo))
        try:
            bench(params)                       # warm: build, first launch
        except ValueError:                      # invalid tile for this shape
            continue
        t0 = time.perf_counter()
        for _ in range(repeat):
            bench(params)
        us = (time.perf_counter() - t0) / repeat * 1e6
        sweep.append({"params": params, "us": round(us, 1)})
    if not sweep:
        raise ValueError(f"no viable candidates for {op}|{skey}")
    best = min(sweep, key=lambda r: r["us"])
    entry = {"params": best["params"], "us": best["us"], "sweep": sweep}
    cache.store(op, skey, entry)
    return entry
