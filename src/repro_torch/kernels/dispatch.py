"""Kernel dispatch of the port: one mode switch + registry for all families.

Counterpart of repro/kernels/dispatch.py. The decision is made per call,
from the mode and the device of the tensor the op was given:

- CUDA:      launch the hand-written Hopper kernel. The tensor must lie on
             a CUDA device of compute capability 9.0; a CPU tensor raises.
- TORCH_REF: the plain PyTorch version (ref.py), on any device. Tests and
             chip_smoke.py use it as the oracle.
- AUTO:      a CPU tensor takes the plain version; a CUDA tensor launches
             the kernel, or raises when the device is not Hopper or the
             build fails. AUTO never falls back to the plain version on a
             CUDA tensor.
"""
from __future__ import annotations

import enum
import importlib
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.obs import metrics as _metrics


class KernelMode(enum.Enum):
    CUDA = "cuda"
    TORCH_REF = "torch_ref"
    AUTO = "auto"


def resolve(mode, tensor) -> bool:
    """True: launch the kernel on `tensor`'s device; False: run the plain
    PyTorch version. Raises where neither may run."""
    mode = KernelMode(mode) if mode is not None else KernelMode.AUTO
    if mode is KernelMode.TORCH_REF:
        return False
    device = tensor.device
    if device.type == "cpu":
        if mode is KernelMode.CUDA:
            raise ValueError(
                "mode='cuda' launches the Hopper kernel, but the tensor lies "
                "on the CPU; move the table to a CUDA device or use "
                "mode='auto' / 'torch_ref'")
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}; the port runs on "
                         f"'cuda' (kernels) or 'cpu' (plain versions)")
    from repro_torch.kernels import _build
    _build.require_hopper(device)
    return True


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class KernelOp:
    """One registered kernel family.

    fn/ref share the public signature; `fn` additionally accepts `mode=`.
    `example(rng)` returns (args, kwargs) exercising the op on the CPU."""
    name: str
    fn: Callable
    ref: Callable
    example: Callable[[Any], tuple]


_REGISTRY: dict[str, KernelOp] = {}

# the reference's family names, all of them, in its order
# (repro/kernels/dispatch.py::_OP_MODULES)
_OP_MODULES = ("scan_filter", "aggregate", "scan_aggregate",
               "scan_compressed", "group_aggregate", "flash_attention",
               "decode_attention", "ssd_chunk")


def register(name: str, *, fn, ref, example=None) -> KernelOp:
    op = KernelOp(name=name, fn=fn, ref=ref, example=example)
    _REGISTRY[name] = op
    return op


def ensure_registered() -> None:
    """Import every family so module-level register() calls ran."""
    for mod in _OP_MODULES:
        importlib.import_module(f"repro_torch.kernels.{mod}.ops")


def get(name: str) -> KernelOp:
    ensure_registered()
    return _REGISTRY[name]


def registered() -> dict[str, KernelOp]:
    ensure_registered()
    return dict(_REGISTRY)


# --------------------------------------------------------------------------
# launch accounting
# --------------------------------------------------------------------------
# One count per public-op call, kernel and plain version alike, as in the
# reference, so the port's counts compare one for one with its. The real
# CUDA launches are counted apart, by each kernel.py's LAUNCHES.

_muted = 0


@contextmanager
def muted(on: bool = True):
    """While `on`, op calls inside the block are not counted. For callers
    that count by the reference's rule instead: a sharded table counts a
    query shape's dispatches once, at its first execution, as the
    reference counts when it traces its cached shard_map."""
    global _muted
    _muted += bool(on)
    try:
        yield
    finally:
        _muted -= bool(on)


def count_launch(name: str, n: int = 1) -> None:
    """Record `n` dispatches for kernel family `name` (in every active
    metrics scope), unless inside `muted()`."""
    if not _muted:
        _metrics.count_launch(name, n)


def record_batch(name: str, width: int, n_chunks: int) -> None:
    """Record one batched dispatch of family `name` covering `n_chunks`
    chunks at payload width `width`. Does not add to launch_counts()."""
    _metrics.record_batch(name, width, n_chunks)


def launch_counts() -> dict[str, int]:
    """Per-family launch counts of the default (process-global) scope."""
    return _metrics.default_registry().launch_counts()


def total_launches() -> int:
    return _metrics.default_registry().total_launches()


def reset_launch_counts() -> None:
    """Reset the default scope's launch counters. Engine-scoped registries
    are unaffected."""
    _metrics.default_registry().reset_launches()
