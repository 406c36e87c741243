"""Hand-written Hopper kernels (CUDA C++ for sm_90a, sources in
repro_torch/csrc) with a plain PyTorch version of each:

- scan_filter:     BitWeaving-H predicate scan
- aggregate:       masked sum/count/min/max over packed codes
- scan_aggregate:  the two fused; the mask never leaves registers
- scan_compressed: fused predicate + aggregate on RLE runs
- group_aggregate: GROUP BY count/sum over key, value and select planes,
                   and over RLE runs (dense accumulator planes)
- flash_attention: causal / sliding-window prefill attention (forward;
                   flash5's backward differentiates the plain version)
- decode_attention: split-K one-token decode over the ring-buffer cache

aggregate and scan_aggregate also have a batched kernel, one launch over
every chunk of a compressed-store column group.

Each package: kernel.py (ctypes wrapper + launch counter), ops.py (public
op, dispatched through dispatch.py), ref.py (plain PyTorch version).
`_build.py` compiles csrc/*.cu with nvcc at first use.
"""
