"""PyTorch/CUDA port of the `repro` package for one NVIDIA H100.

The JAX package `repro` stays the reference. Every module here mirrors
one module there (same subpackage layout and names), and every Pallas TPU
kernel on a ported path becomes a CUDA C++ kernel for `sm_90a` under
`csrc/`, bound with ctypes (`kernels/_build.py`) and dispatched by
`kernels/dispatch.py`. Nothing here imports `jax` or `repro`.

Ported so far: the query engine's flat main path (`db`, `query`,
`serve.sla`, `obs.metrics`, `obs.trace`) over the scan_filter, aggregate
and scan_aggregate kernels.
"""
