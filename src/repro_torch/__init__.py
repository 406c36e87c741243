"""PyTorch/CUDA port of the `repro` package for one NVIDIA H100.

The JAX package `repro` stays the reference. Every module here mirrors
one module there (same subpackage layout and names), and every Pallas TPU
kernel on a ported path becomes a CUDA C++ kernel for `sm_90a` under
`csrc/`, bound with ctypes (`kernels/_build.py`) and dispatched by
`kernels/dispatch.py`. Nothing here imports `jax` or `repro`.

Ported so far:
- the query engine's flat main path (`db`, `query`, `serve.sla`,
  `obs.metrics`, `obs.trace`) over the scan_filter, aggregate and
  scan_aggregate kernels;
- the compressed store (`store`) over the batched aggregate, batched
  scan_aggregate and scan_compressed kernels;
- GROUP BY and hash join (`query.relational`,
  `store.execute_grouped_encoded`) over the group_aggregate kernels;
- LM serving (`configs`, `models`, `serve.engine`, `serve.scheduler`)
  for attention-only stacks over the flash_attention (prefill) and
  decode_attention (one-token decode) kernels, and Mamba-2 stacks over
  the ssd_chunk kernel;
- the tiered engine (`core.systems`, `tier`, `energy`, `kernels.tune`):
  placement, prefetch, the energy meter and the power cap around the
  query engine's kernels.
"""
