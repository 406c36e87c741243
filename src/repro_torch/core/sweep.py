"""Vectorized + differentiable relaxation of the paper's model on torch
tensors (counterpart of repro/core/sweep.py).

Two beyond-paper uses:
- `sweep_*`: evaluate whole SLA/power/capacity grids on the device in one
  call (the paper's figures as single vectorized expressions).
- `soft_*`: a smooth relaxation (ceil -> sigmoid-smoothed) that makes
  cluster design differentiable — autograd of power(sla, density,
  core_power) gives the sensitivity analysis of §6.1 analytically instead
  of by finite differencing the discrete model.

Everything is float32, as the reference's is. Every Python number is made
a float32 tensor on the device before it meets one, so each operation is
the same IEEE float32 operation as the reference's on both the CPU and
the card (a Python divisor would let the card multiply by its
reciprocal instead).
"""
from __future__ import annotations

import torch

from repro_torch.core.model import Workload
from repro_torch.core.systems import SystemSpec
from repro_torch.device import resolve_device


def _f32(v, device) -> torch.Tensor:
    """`v` itself if it is a tensor, else a float32 scalar on `device`."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _soft_ceil(x, tau: float = 0.05):
    """Smooth ceil: floor(x) + a sigmoid of the fractional part."""
    frac = x - torch.floor(x)
    return torch.floor(x) + torch.sigmoid(
        (frac - _f32(0.5, x.device)) / _f32(tau, x.device))


def soft_performance_power(system: SystemSpec, workload: Workload, sla,
                           density=1.0, core_power_scale=1.0,
                           hard: bool = False, device=None):
    """Differentiable Eq. 10 under performance provisioning.

    sla may be a scalar or a tensor (vectorizes); density /
    core_power_scale are the §6.1 levers, numbers or float32 tensors (to
    differentiate through them). Runs on `device`; by default on the
    device of a tensor `sla`, else on the card.
    """
    if device is None and isinstance(sla, torch.Tensor):
        dev = sla.device
    else:
        dev = resolve_device(device)
    f = lambda v: _f32(v, dev)
    ceil = torch.ceil if hard else _soft_ceil
    sla = torch.as_tensor(sla, dtype=torch.float32, device=dev)
    required_bw = f(workload.bytes_accessed) / sla
    if isinstance(density, torch.Tensor):
        cap_chips = ceil(f(workload.db_size)
                         / (f(system.chip_capacity) * density))
    else:   # a number: the quotient in double, as the reference's is
        cap_chips = ceil(f(workload.db_size
                           / (system.chip_capacity * density)))
    bw_chips = ceil(required_bw / f(system.chip_peak_perf))
    chips = torch.maximum(cap_chips, bw_chips)
    cores = torch.clamp(ceil(required_bw / chips / f(system.core_perf)),
                        1, system.max_chip_cores)
    blades = ceil(chips / f(system.blade_chips))
    mem_power = chips * f(system.modules_per_chip) * f(system.module_power)
    compute_power = chips * cores * f(system.core_power) \
        * f(core_power_scale)
    return mem_power + compute_power + blades * f(system.blade_overhead)


def sweep_performance(system: SystemSpec, workload: Workload, slas,
                      device=None):
    """Power across an SLA grid (hard ceilings — matches the scalar model
    to within the soft/hard gap, asserted in tests)."""
    return soft_performance_power(system, workload, slas, hard=True,
                                  device=device)


def power_sensitivity(system: SystemSpec, workload: Workload, sla: float,
                      device=None):
    """d power / d (log density, log core_power) at the operating point —
    the analytical version of the paper's §6.1 what-ifs."""
    dev = resolve_device(device)
    log_density = torch.zeros((), dtype=torch.float32, device=dev,
                              requires_grad=True)
    log_cps = torch.zeros((), dtype=torch.float32, device=dev,
                          requires_grad=True)
    power = soft_performance_power(system, workload, sla,
                                   density=torch.exp(log_density),
                                   core_power_scale=torch.exp(log_cps),
                                   device=dev)
    g = torch.autograd.grad(power, (log_density, log_cps))
    return {"d_power_d_log_density": float(g[0]),
            "d_power_d_log_core_power": float(g[1])}
