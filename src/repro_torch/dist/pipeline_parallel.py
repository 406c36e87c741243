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

On a mesh of ranks (launch.mesh.RankMesh) a stage is a rank: each rank
runs the stage of its own `axis` index on its (1, ...) block of the
weights, the ppermute is one paired send/recv a tick on the axis's
subgroup (world.exchange), and the outputs reach every rank of the axis
by an all-reduce SUM of the last stage's outputs and zeros elsewhere,
the reference's psum.
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import PartitionSpec, mesh_constraint


def bubble_fraction(microbatches: int, stages: int) -> float:
    """Idle fraction of the position-tick grid for a drained GPipe
    schedule."""
    return (stages - 1) / (microbatches + stages - 1)


def gpipe(stage, weights, xs, *, mesh, axis: str):
    """Run `stage(w_s, x)` for s = 0..S-1 composed in sequence, pipelined.

    weights: (S, ...) per-stage params, one stage a position of `axis`
    (on a rank mesh: this rank's (1, ...) block of them). xs: (M, ...)
    microbatches, the same on every rank. Output must have the same
    shape as a microbatch. Returns (M, ...) outputs."""
    s = int(mesh.shape[axis])
    m = int(xs.shape[0])
    if mesh.group is not None:
        return _gpipe_ranks(stage, weights, xs, mesh, axis, s, m)
    if weights.shape[0] != s:
        raise ValueError(f"{weights.shape[0]} stages on a {s}-way "
                         f"'{axis}' axis")
    run = torch.func.vmap(stage)                 # every stage in one call
    out = torch.zeros(xs.shape, dtype=xs.dtype, device=xs.device)
    y = torch.zeros((s,) + tuple(xs.shape[1:]), dtype=xs.dtype,
                    device=xs.device)
    y = mesh_constraint(y, PartitionSpec(axis))  # a stage a position
    for t in range(m + s - 1):
        x = torch.roll(y, 1, dims=0)             # the ppermute i -> i + 1
        x[0] = xs[min(max(t, 0), m - 1)]         # position 0 ingests
        y = run(weights, x)
        done = t - (s - 1)                       # mb finishing this tick
        if 0 <= done < m:
            out[done] = y[s - 1]
    return out


def _gpipe_ranks(stage, weights, xs, mesh, axis: str, s: int, m: int):
    import torch.distributed as dist

    from repro_torch.dist import world
    if weights.shape[0] != 1:
        raise ValueError(f"a rank holds its (1, ...) block of the stage "
                         f"weights, not {tuple(weights.shape)}")
    group, peers = mesh.axis_group(axis), mesh.axis_ranks(axis)
    idx = mesh.coords[axis]
    to, frm = peers[(idx + 1) % s], peers[(idx - 1) % s]
    w = weights[0]
    out = torch.zeros(xs.shape, dtype=xs.dtype, device=xs.device)
    recv = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device)
    for t in range(m + s - 1):
        x = xs[min(max(t, 0), m - 1)] if idx == 0 else recv
        y = stage(w, x)
        done = t - (s - 1)                       # mb finishing this tick
        if idx == s - 1 and 0 <= done < m:
            out[done] = y
        if s > 1 and t < m + s - 2:              # the ring i -> i + 1
            recv = world.exchange(y, torch.empty_like(recv), to, frm, group)
    dist.all_reduce(out, group=group)            # zeros but on the last
    return out
