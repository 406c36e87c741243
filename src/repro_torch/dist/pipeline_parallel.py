"""GPipe-style pipeline parallelism over one mesh axis (counterpart of
repro/dist/pipeline_parallel.py).

`gpipe` places stage s on position s of `axis` and streams M microbatches
through the ring: at tick t position j runs its stage on microbatch t-j,
so the pipe drains in M + S - 1 ticks with the classic bubble fraction
(S-1)/(M+S-1) of idle position-ticks.

On one card the S stages are virtual positions: each tick runs every
stage on its own input in one call batched over S (torch.func.vmap of the
stage over the stacked weights and the (S, ...) carry), and the
reference's ppermute around the ring is a roll of that carry. Specs name
only `axis`; the mesh's other axes are untouched.
"""
from __future__ import annotations

import torch


def bubble_fraction(microbatches: int, stages: int) -> float:
    """Idle fraction of the position-tick grid for a drained GPipe
    schedule."""
    return (stages - 1) / (microbatches + stages - 1)


def gpipe(stage, weights, xs, *, mesh, axis: str):
    """Run `stage(w_s, x)` for s = 0..S-1 composed in sequence, pipelined.

    weights: (S, ...) per-stage params, one stage a position of `axis`.
    xs: (M, ...) microbatches. Output must have the same shape as a
    microbatch. Returns (M, ...) outputs."""
    s = int(mesh.shape[axis])
    m = int(xs.shape[0])
    if weights.shape[0] != s:
        raise ValueError(f"{weights.shape[0]} stages on a {s}-way "
                         f"'{axis}' axis")
    run = torch.func.vmap(stage)                 # every stage in one call
    out = torch.zeros(xs.shape, dtype=xs.dtype, device=xs.device)
    y = torch.zeros((s,) + tuple(xs.shape[1:]), dtype=xs.dtype,
                    device=xs.device)
    for t in range(m + s - 1):
        x = torch.roll(y, 1, dims=0)             # the ppermute i -> i + 1
        x[0] = xs[min(max(t, 0), m - 1)]         # position 0 ingests
        y = run(weights, x)
        done = t - (s - 1)                       # mb finishing this tick
        if 0 <= done < m:
            out[done] = y[s - 1]
    return out
