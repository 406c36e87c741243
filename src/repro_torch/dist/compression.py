"""Gradient compression: int8 quantized collectives + error feedback
(counterpart of repro/dist/compression.py).

The cross-pod (DCN) all-reduce is the bandwidth-starved link in multi-pod
training (repro_torch.core.traffic): int8 quantization cuts its bytes 4x
vs fp32 at <1% relative error per reduction, and error feedback makes the
bias vanish over steps (the classic EF-SGD argument: residuals are
bounded, so the accumulated sent signal tracks the accumulated true
signal).

On one card the pods of a mesh are virtual positions: `compressed_psum_pod`
runs the reference's shard_map body over a leading axis of positions, one
batched op per reduction, never a loop over devices.
"""
from __future__ import annotations

import torch


def _quantize(x):
    """x -> (int8 codes, fp32 scale). Symmetric per-tensor quantization:
    scale max|x| / 127 + 1e-12, codes round half to even, clipped to
    +-127 (the reference's formulas)."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.to(torch.float32) * scale


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def compressed_psum_pod(tree, mesh, axis: str = "pod"):
    """psum a replicated tree over `axis` in int8 (scales reduced in fp32).

    Each position of `axis` quantizes its copy (the tensor expanded over a
    leading position axis, stride 0, so no copy is made), the int8 codes
    sum as int32 over that axis (no overflow up to 2^23 summands), and the
    max scale across the positions bounds the dequantization error at
    int8 resolution. Positions of the other axes hold the same result, as
    replicas do in the reference."""
    n = int(mesh.shape[axis])

    def one(x):
        copies = x.expand(n, *x.shape)                  # one per position
        dims = tuple(range(1, copies.dim()))
        scale = (copies.abs().amax(dim=dims) if dims else copies.abs()) \
            / 127.0 + 1e-12                              # (n,)
        q = torch.clamp(torch.round(
            copies / scale.view(n, *(1,) * x.dim())), -127, 127).to(
                torch.int8)
        total = q.sum(dim=0, dtype=torch.int32)
        return _dequantize(total, scale.amax())

    return _map(one, tree)


def _map_pairs(fn, a, b):
    """fn(leaf_a, leaf_b) -> (x, y) over twin trees; returns the tree of
    x and the tree of y."""
    if isinstance(a, dict):
        pairs = {k: _map_pairs(fn, v, b[k]) for k, v in a.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    if isinstance(a, (list, tuple)):
        pairs = [_map_pairs(fn, v, w) for v, w in zip(a, b)]
        return (type(a)(p[0] for p in pairs), type(a)(p[1] for p in pairs))
    return fn(a, b)


def error_feedback_compress(grads, residual=None):
    """One EF step: quantize (grads + residual), carry the new residual.

    Returns (sent, residual): `sent` is the dequantized payload actually
    contributed to the reduction; `residual` must be threaded into the next
    call so quantization error accumulates into later sends instead of
    being lost. Trees are dicts (or lists, tuples) of tensors."""
    if residual is None:
        residual = _map(torch.zeros_like, grads)

    def one(g, r):
        t = g + r
        q, scale = _quantize(t)
        sent = _dequantize(q, scale)
        return sent, t - sent

    return _map_pairs(one, grads, residual)
