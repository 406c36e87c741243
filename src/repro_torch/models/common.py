"""Shared model building blocks (counterpart of repro/models/common.py):
dtypes, initialisation on an explicit torch.Generator (or abstract, on the
meta device), the logical-axes helpers, RMSNorm, rotary position
embeddings and the training losses.

Every module class of the model names its own parameters' logical axes
(`AXES`, the reference's `dense_init(key, shape, axes, ...)` arguments);
repro_torch.models.lm.param_axes collects them by parameter name, and
repro_torch.dist.sharding maps logical names to mesh axes, so models
never mention the mesh."""
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

    AXES: dict = {}      # parameter name -> logical axes (per class)

    def __getitem__(self, name: str):
        return getattr(self, name)


class MetaDraws:
    """Stands in for a torch.Generator when the weights are abstract: its
    device is "meta", and every draw leaves an empty meta tensor (no
    generator exists on the meta device). `lm.init(cfg, device="meta")`
    uses it; the result is the port's jax.eval_shape of the init."""
    device = torch.device("meta")


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
    if not w.is_meta:
        torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)
    return torch.nn.Parameter(w.to(dtype), requires_grad=False)


def uniform(shape, low: float, high: float,
            generator: torch.Generator) -> torch.Tensor:
    """U[low, high) in float32 on the generator's device (empty on meta)."""
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return u if u.is_meta else u.uniform_(low, high, generator=generator)


def zeros_init(shape, dtype, device) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                              requires_grad=False)


# --------------------------------------------------------------------------
# logical axes
# --------------------------------------------------------------------------

def axes_str(names) -> str:
    """Logical axes tuple -> a single string leaf ('embed heads'; '_' =
    None)."""
    if isinstance(names, str):
        return names
    return " ".join(n if n else "_" for n in names) or "_scalar_"


def axes_names(s):
    """Inverse of axes_str -> list[str | None]."""
    if not isinstance(s, str):
        return list(s)
    if s == "_scalar_":
        return []
    return [None if n == "_" else n for n in s.split()]


def _is_param_axes_pair(x):
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], torch.Tensor)
            and not isinstance(x[1], torch.Tensor))


def split_tree(params_and_axes):
    """{'w': (tensor, axes), ...} (nested dicts, lists, tuples, or a
    Params module, whose parameters pair with its class's AXES) ->
    (params, axes) twin trees, the axes leaves as axes_str strings."""
    if isinstance(params_and_axes, torch.nn.Module):
        named = dict(params_and_axes.named_parameters())
        axes = param_axes_of(params_and_axes)
        return named, axes
    if _is_param_axes_pair(params_and_axes):
        return params_and_axes[0], axes_str(params_and_axes[1])
    if isinstance(params_and_axes, dict):
        pairs = {k: split_tree(v) for k, v in params_and_axes.items()}
        return ({k: p for k, (p, _) in pairs.items()},
                {k: a for k, (_, a) in pairs.items()})
    if isinstance(params_and_axes, (list, tuple)):
        pairs = [split_tree(v) for v in params_and_axes]
        kind = type(params_and_axes)
        return kind(p for p, _ in pairs), kind(a for _, a in pairs)
    raise TypeError(f"not a (tensor, axes) pair: {params_and_axes!r}")


def _is_names(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def map_axes_tree(axes_tree):
    """Tree whose leaves are tuples of names -> tree of axes_str leaves."""
    if _is_names(axes_tree) or isinstance(axes_tree, str):
        return axes_str(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: map_axes_tree(v) for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(map_axes_tree(v) for v in axes_tree)
    raise TypeError(f"not an axes tree: {axes_tree!r}")


def param_axes_of(module: torch.nn.Module) -> dict:
    """{parameter name: axes_str} of `module`: each parameter's axes are
    its owner's class attribute AXES[its own name]."""
    out = {}
    for prefix, mod in module.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            full = f"{prefix}.{name}" if prefix else name
            out[full] = axes_str(type(mod).AXES[name])
    return out


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
    if torch.device(device).type == "meta":     # shapes only: no host table
        return torch.empty(head_dim // 2, dtype=torch.float32, device=device)
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
