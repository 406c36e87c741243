"""Shared model building blocks (counterpart of repro/models/common.py):
dtypes, initialisation on an explicit torch.Generator, RMSNorm, rotary
position embeddings and the training losses. The reference's
logical-axes helpers (sharding) are not ported yet."""
from __future__ import annotations

import functools

import numpy as np
import torch


class Params(torch.nn.Module):
    """An nn.Module whose parameters and sub-modules are also read by name
    (`params["wq"]`), so the model code reads as the reference's pytree
    code does. Parameters are made with requires_grad=False, as serving
    wants them; training makes its model trainable itself
    (repro_torch.train.step.init_state and
    repro_torch.models.convert.state_from_reference call
    requires_grad_(True))."""

    def __getitem__(self, name: str):
        return getattr(self, name)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def dense_init(shape, dtype, generator: torch.Generator,
               scale: float | None = None) -> torch.nn.Parameter:
    """Truncated-normal (at +-2 std) fan-in init, drawn in float32 on the
    generator's device and cast to `dtype`. The reference draws from a JAX
    key; the two give different numbers, so parity tests carry weights
    across with repro_torch.models.convert instead."""
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
    std = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)
    return torch.nn.Parameter(w.to(dtype), requires_grad=False)


def zeros_init(shape, dtype, device) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                              requires_grad=False)


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------

def rms_norm(x, weight, eps: float):
    """RMSNorm in fp32 accumulation, output in the input dtype; the weight
    is an fp32 offset: the scale is (1 + weight)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=None)
def _frequencies_on(head_dim: int, theta: float, device) -> torch.Tensor:
    # one host-to-device copy per (head_dim, theta, device): a copy from
    # pageable host memory on every call would stall the stream each layer
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int. Rotates
    the two halves of the head dim (not interleaved pairs), in fp32."""
    head_dim = x.shape[-1]
    freqs = _frequencies_on(head_dim, theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def softmax_cross_entropy(logits, labels):
    """Mean next-token CE; logits (B, S, V) any float dtype, labels (B, S)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def chunked_cross_entropy(x, head_w, labels, num_chunks: int = 8):
    """CE computed sequence chunk by chunk, so the (B, S, V) logits are
    made one chunk at a time: x (B, S, D) hidden, head_w (D, V). The mean
    over B * S of the chunks' sums."""
    b, s, _ = x.shape
    assert s % num_chunks == 0, (s, num_chunks)
    n = s // num_chunks
    totals = []
    for i in range(num_chunks):
        logits = torch.einsum("bsd,dv->bsv", x[:, i * n:(i + 1) * n],
                              head_w).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, i * n:(i + 1) * n].long()[..., None])
        totals.append((lse - gold[..., 0]).sum())
    return torch.stack(totals).sum() / (b * s)
