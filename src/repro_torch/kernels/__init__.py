"""Hand-written Hopper kernels (CUDA C++ for sm_90a, sources in
repro_torch/csrc) with a plain PyTorch version of each:

- scan_filter:     BitWeaving-H predicate scan
- aggregate:       masked sum/count/min/max over packed codes
- scan_aggregate:  the two fused; the mask never leaves registers

Each package: kernel.py (ctypes wrapper + launch counter), ops.py (public
op, dispatched through dispatch.py), ref.py (plain PyTorch version).
`_build.py` compiles csrc/*.cu with nvcc at first use.
"""
