"""Deterministic synthetic LM data pipeline (counterpart of
repro/data/pipeline.py).

- batch(step) is a pure function of (seed, step): a restart at step k
  reproduces the exact stream, so checkpoint/restart is bitwise stable.
  The rows are the reference's numpy draws, bit for bit.
- `local_batch` defaults to process 0 of 1. `make_global_batch` puts
  the rows on a virtual mesh's one device whole; on a mesh of ranks each
  rank draws the same global rows and keeps its block under the spec,
  the rows jax.make_array_from_process_local_data puts on that device.
- A host-side prefetch thread overlaps generation with device compute.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.dist.sharding import NamedSharding, local_block

JOIN_TIMEOUT_S = 5.0     # Prefetcher.close waits this long for its thread


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    embed_dim: int = 0      # >0: embeddings-mode archs (audio/vlm stubs)


class SyntheticLM:
    """Zipf-ish token stream with next-token labels (shifted inputs)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _rows(self, step: int, lo: int, hi: int):
        """Rows [lo, hi) of the global batch at `step` (pure function)."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        # zipf-like marginal: heavy head like natural text
        u = rng.random((c.global_batch, c.seq_len + 1))
        toks = np.minimum((u ** -1.2 - 1.0) * 37.0,
                          c.vocab_size - 1).astype(np.int32)
        inputs, labels = toks[:, :-1], toks[:, 1:]
        if c.embed_dim:
            emb_rng = np.random.default_rng((c.seed, step, 7))
            inputs = emb_rng.standard_normal(
                (c.global_batch, c.seq_len, c.embed_dim),
                dtype=np.float32)
        return {"inputs": inputs[lo:hi], "labels": labels[lo:hi]}

    def batch(self, step: int):
        """Full global batch (single-host convenience)."""
        return self._rows(step, 0, self.cfg.global_batch)

    def local_batch(self, step: int, process_index: int = 0,
                    process_count: int = 1):
        per = self.cfg.global_batch // process_count
        return self._rows(step, process_index * per,
                          (process_index + 1) * per)


def _check_spec(spec, mesh, ndim: int) -> None:
    """A spec is the reference's PartitionSpec as a tuple: one entry a
    leading dimension, each None, a mesh axis or a tuple of mesh axes."""
    entries = tuple(spec)
    if len(entries) > ndim:
        raise ValueError(f"spec {spec} has more entries than the array's "
                         f"{ndim} dimensions")
    for e in entries:
        for axis in (e if isinstance(e, tuple) else (e,)):
            if axis is not None and axis not in mesh.axes:
                raise ValueError(f"spec {spec} names {axis!r}, which is "
                                 f"not an axis of {mesh}")


def make_global_batch(host_batch: dict, mesh, specs: dict):
    """Host rows of the global batch -> tensors on `mesh.device`: tokens
    int32, embeddings float32. Every position of a virtual mesh lives on
    one device, so there a spec only names the axes the rows would split
    over; it is checked, and the rows go to the device whole. On a rank
    mesh (launch.mesh.RankMesh) only this rank's block under the spec
    goes to its device; a split that does not divide raises."""
    out = {}
    for k, v in host_batch.items():
        v = np.asarray(v)
        _check_spec(specs[k], mesh, v.ndim)
        dtype = torch.float32 if v.dtype.kind == "f" else torch.int32
        t = local_block(torch.from_numpy(np.ascontiguousarray(v)),
                        NamedSharding(mesh, specs[k]))
        out[k] = t.to(mesh.device, dtype)
    return out


class Prefetcher:
    """Background thread that keeps `depth` host batches ready."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.ds = ds
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._loop, daemon=True)
        self.t.start()

    def _loop(self):
        s = self.step
        while not self._stop.is_set():
            b = self.ds.local_batch(s)
            while not self._stop.is_set():
                try:
                    self.q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def next(self):
        return self.q.get()

    def close(self):
        """Stop the thread and join it: it sees the stop within one put
        timeout (0.1 s) after the batch it is drawing."""
        self._stop.set()
        self.t.join(JOIN_TIMEOUT_S)
        if self.t.is_alive():
            raise RuntimeError(f"prefetch thread still running "
                               f"{JOIN_TIMEOUT_S} s after close()")
