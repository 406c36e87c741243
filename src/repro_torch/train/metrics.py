"""Training observability: throughput and roofline-referenced MFU
logging (counterpart of repro/train/metrics.py).

Writes JSONL records per step (host-side, cheap) with:
- wall-time, tokens/sec, step time EWMA,
- achieved MFU against the accelerator's peak (the H100 row by default),
- the analytic roofline step estimate for the active strategy, so the gap
  between achieved and roofline is a first-class metric.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core import roofline, traffic
from repro_torch.core.systems import H100_SXM, AcceleratorSpec


class MetricsLogger:
    def __init__(self, path, cfg: ArchConfig, shape: ShapeSpec,
                 chips: int, strategy: str = "megatron",
                 spec: AcceleratorSpec = H100_SXM):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.cfg, self.shape, self.chips, self.spec = cfg, shape, chips, spec
        self.model_flops = roofline.model_flops(cfg, shape)
        mesh = traffic.MeshShape(chips=chips, tp=1, fsdp=max(chips, 1),
                                 dp=max(chips, 1))
        hbm = traffic.hbm_traffic(cfg, shape, mesh, strategy)
        coll = traffic.collective_traffic(cfg, shape, mesh, strategy)
        self.roofline_step_s = roofline.terms(
            self.model_flops / chips, hbm["total"], coll["total"],
            spec).step_time_s
        self._ewma = None
        self._f = open(self.path, "a")

    def log(self, step: int, seconds: float, metrics: dict):
        self._ewma = (seconds if self._ewma is None
                      else 0.9 * self._ewma + 0.1 * seconds)
        tokens = self.shape.tokens_per_step
        achieved = self.model_flops / seconds / self.chips
        rec = {
            "step": step,
            "time": time.time(),
            "step_s": seconds,
            "step_s_ewma": self._ewma,
            "tokens_per_s": tokens / seconds,
            "mfu": achieved / self.spec.peak_flops_bf16,
            "roofline_step_s": self.roofline_step_s,
            "roofline_gap": (seconds / self.roofline_step_s
                             if self.roofline_step_s else None),
            **{k: float(v) for k, v in metrics.items()},
        }
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        return rec

    def close(self):
        self._f.close()
