"""Three-term roofline of one step, per chip (counterpart of
repro/core/roofline.py):

  compute_s    = flops_per_device / peak_flops
  memory_s     = bytes_per_device / hbm_bw
  collective_s = ring_bytes_per_device / (links * link_bw)

The flops and bytes come from any source: the analytic traffic model
(`core.traffic`), a profiler, or a compiler's cost analysis. Where a
source counts a loop body once, measure two unrolled probes (p and 2p
layers) and extrapolate affinely to L layers (`extrapolate`) — exact for
homogeneous stacks, whose cost is additive per layer.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

from repro_torch.core.systems import H100_SXM, AcceleratorSpec


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    ring_bytes_per_device: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Full-overlap roofline step estimate (max of the three terms;
        achievable when compute, HBM streaming, and collectives pipeline:
        asynchronous collectives and double-buffered copies)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serialized_s(self) -> float:
        """No-overlap lower-bound-of-badness (sum of terms)."""
        return self.compute_s + self.memory_s + self.collective_s

    def overlapped_step_s(self, efficiency: float = 1.0) -> float:
        """Step time at partial overlap: efficiency=1 -> max(terms),
        0 -> sum(terms)."""
        return (self.step_time_s * efficiency
                + self.serialized_s * (1.0 - efficiency))

    @property
    def bound_fraction(self) -> float:
        """Dominant term / sum — 1.0 means perfectly overlappable."""
        s = self.compute_s + self.memory_s + self.collective_s
        return self.step_time_s / s if s else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d["dominant"] = self.dominant
        d["step_time_s"] = self.step_time_s
        return d


def terms(flops_per_device: float, bytes_per_device: float,
          ring_bytes_per_device: float, spec: AcceleratorSpec = H100_SXM,
          collective_links: int | None = None) -> RooflineTerms:
    links = collective_links if collective_links else 1
    return RooflineTerms(
        compute_s=flops_per_device / spec.peak_flops_bf16,
        memory_s=bytes_per_device / spec.hbm_bandwidth,
        collective_s=ring_bytes_per_device / (links * spec.link_bandwidth),
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        ring_bytes_per_device=ring_bytes_per_device,
    )


def extrapolate(cost_p: dict, cost_2p: dict, num_layers: int, p: int) -> dict:
    """Affine per-layer extrapolation: cost(L) = base + L * per_layer.

    cost_p / cost_2p measured at p and 2p unrolled layers.
    """
    out = {}
    for k in cost_p:
        per_layer = (cost_2p[k] - cost_p[k]) / p
        base = cost_p[k] - p * per_layer
        out[k] = base + num_layers * per_layer
    return out


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs per step (global, params-only convention):
    train 6*N*T, prefill 2*N*T, decode 2*N*T with T = tokens that step.
    N = active params for MoE."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        t = shape.tokens_per_step
        return 6.0 * n * t
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens_per_step
    return 2.0 * n * shape.global_batch        # decode: 1 token per row


def utilization(terms_: RooflineTerms, model_flops_global: float,
                chips: int, spec: AcceleratorSpec = H100_SXM) -> dict:
    """Roofline fractions of one step: model FLOPs utilization at the
    roofline step time, and useful over counted FLOPs."""
    useful_per_dev = model_flops_global / chips
    step = terms_.step_time_s
    mfu = (useful_per_dev / spec.peak_flops_bf16) / step if step else 0.0
    hlo_ratio = (useful_per_dev / terms_.flops_per_device
                 if terms_.flops_per_device else 0.0)
    return {
        "model_flops_global": model_flops_global,
        "model_flops_per_device": useful_per_dev,
        "useful_vs_hlo_flops": hlo_ratio,
        "roofline_mfu": mfu,
        "dominant": terms_.dominant,
    }
