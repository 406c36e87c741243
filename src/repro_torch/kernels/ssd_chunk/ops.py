"""Public SSD-scan API in the model's layout, dispatched through
repro_torch.kernels.dispatch (counterpart of
repro/kernels/ssd_chunk/ops.py). The CUDA kernel takes the model's layout
as it is and the B / C planes shared by the heads, so nothing is
broadcast or moved to a head-major layout; unlike the reference, the op
takes the state entering the first chunk (`init_state`), as the model's
chunked scan does.

`ssd` is a torch.autograd.Function (`_SSD`) on both devices: its forward
runs the CUDA kernel (on a CUDA tensor) or the plain version, and its
backward differentiates the plain version, as flash_attention's `_Flash5`
does. There is no backward kernel; the reference has none either (its
model scan is plain jnp, which jax.grad differentiates)."""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd_chunk import kernel as K
from repro_torch.kernels.ssd_chunk import ref


def _forward(x, dt, a_log, b, c, chunk, init_state, mode):
    if not dispatch.resolve(mode, x):
        return ref.ssd_chunked_ref(x, dt, a_log, b, c, chunk, init_state)
    h_in = (None if init_state is None
            else init_state.to(torch.float32).contiguous())
    return K.ssd_scan(x.contiguous(), dt.to(torch.float32).contiguous(),
                      a_log.to(torch.float32).contiguous(), b.contiguous(),
                      c.contiguous(), chunk, h_in)


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, chunk, init_state, mode):
        # a final state nobody reads (training's) arrives as None and
        # costs the backward nothing
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a_log, b, c, init_state)
        ctx.chunk = chunk
        return _forward(x, dt, a_log, b, c, chunk, init_state, mode)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_()
                      for t in saved]
            outs = ref.ssd_chunked_ref(*leaves[:5], ctx.chunk, leaves[5])
            pairs = [(o, g) for o, g in zip(outs, (grad_y, grad_state))
                     if g is not None]
            # c reaches y only: with y unread it has no gradient
            dx, ddt, da, db, dc, *dh = torch.autograd.grad(
                [o for o, _ in pairs], [t for t in leaves if t is not None],
                [g for _, g in pairs], allow_unused=True)
        return dx, ddt, da, db, dc, None, (dh[0] if dh else None), None


def ssd(x, dt, a_log, b, c, chunk: int, init_state=None, mode=None):
    """Model layout: x (B, S, H, P); dt (B, S, H) fp32 post-softplus;
    a_log (H,); b / c (B, S, N) (groups=1, shared by the heads);
    init_state (B, H, N, P) or None (zeros). Returns (y (B, S, H, P) in
    x's dtype, final_state (B, H, N, P) fp32); differentiable in x, dt,
    a_log, b, c and init_state."""
    s = x.shape[1]
    assert s % chunk == 0, (s, chunk)
    return _SSD.apply(x, dt, a_log, b, c, chunk, init_state, mode)


def _example(rng):
    bsz, s, h, p, n, chunk = 2, 64, 2, 16, 8, 16
    x = torch.from_numpy(rng.standard_normal((bsz, s, h, p),
                                             dtype="float32"))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((bsz, s, h), dtype="float32")))
    a_log = torch.from_numpy(rng.standard_normal(h, dtype="float32")) * 0.1
    b = torch.from_numpy(rng.standard_normal((bsz, s, n), dtype="float32"))
    c = torch.from_numpy(rng.standard_normal((bsz, s, n), dtype="float32"))
    return (x, dt, a_log, b, c, chunk), {}


def _ssd_ref(x, dt, a_log, b, c, chunk, init_state=None, **kw):
    return ref.ssd_loop_ref(x, dt, a_log, b, c, chunk, init_state)


dispatch.register("ssd_chunk", fn=ssd, ref=_ssd_ref, example=_example)
