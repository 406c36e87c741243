"""Public flash attention API, dispatched through
repro_torch.kernels.dispatch (counterpart of
repro/kernels/flash_attention/ops.py).

- `flash5(q5, k, v, window)`: kernel-native layout, a
  torch.autograd.Function whose forward runs the CUDA kernel (on a CUDA
  tensor) and whose backward differentiates the plain version, as the
  reference's custom_vjp does: there is no backward kernel.
- `flash_attention` (models layout): the adapter
  repro_torch.models.attention calls when attn_impl == "flash"; takes the
  model's (B, Sq, KV, G, H) q and (B, Skv, KV, H) k/v. Like the reference
  it ignores q_pos / kv_pos and assumes arange positions aligned to the
  suffix (prefill).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref


def _forward(q, k, v, window, mode):
    if not dispatch.resolve(mode, q):
        return ref.attention_ref(q, k, v, window=window)
    return K.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                 v.contiguous(), window=window)


class _Flash5(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, mode):
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        return _forward(q, k, v, window, mode)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.attention_ref(*leaves, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, leaves, grad)
        return dq, dk, dv, None, None


def flash5(q, k, v, window: int = 0, mode=None):
    """q (B, KVH, G, Sq, D), k/v (B, KVH, Skv, D) -> (B, KVH, G, Sq, D);
    differentiable in q, k and v."""
    return _Flash5.apply(q, k, v, window, mode)


def flash_attention(q, k, v, q_pos, kv_pos, *, window: int = 0, mode=None):
    """Model-layout adapter: q (B, Sq, KV, G, H), k/v (B, Skv, KV, H)."""
    q5 = q.movedim(1, 3)                 # (B, KV, G, Sq, H)
    k4 = k.movedim(1, 2)                 # (B, KV, Skv, H)
    v4 = v.movedim(1, 2)
    o5 = flash5(q5, k4, v4, window, mode)
    return o5.movedim(3, 1)              # back to (B, Sq, KV, G, H)


def _example(rng):
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype="float32"))
               for shape in ((1, 2, 2, 256, 64), (1, 2, 256, 64),
                             (1, 2, 256, 64)))
    return (q, k, v), {}


def _flash5_mode(q, k, v, *, mode=None):
    return _forward(q, k, v, 0, mode)


dispatch.register("flash_attention", fn=_flash5_mode, ref=ref.attention_ref,
                  example=_example)
