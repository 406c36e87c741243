"""Public SSD-scan API in the model's layout, dispatched through
repro_torch.kernels.dispatch (counterpart of
repro/kernels/ssd_chunk/ops.py). The CUDA kernel takes the model's layout
as it is and the B / C planes shared by the heads, so nothing is
broadcast or moved to a head-major layout; unlike the reference, the op
takes the state entering the first chunk (`init_state`), as the model's
chunked scan does."""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd_chunk import kernel as K
from repro_torch.kernels.ssd_chunk import ref


def ssd(x, dt, a_log, b, c, chunk: int, init_state=None, mode=None):
    """Model layout: x (B, S, H, P); dt (B, S, H) fp32 post-softplus;
    a_log (H,); b / c (B, S, N) (groups=1, shared by the heads);
    init_state (B, H, N, P) or None (zeros). Returns (y (B, S, H, P) in
    x's dtype, final_state (B, H, N, P) fp32)."""
    s = x.shape[1]
    assert s % chunk == 0, (s, chunk)
    if not dispatch.resolve(mode, x):
        return ref.ssd_chunked_ref(x, dt, a_log, b, c, chunk, init_state)
    h_in = (None if init_state is None
            else init_state.to(torch.float32).contiguous())
    return K.ssd_scan(x.contiguous(), dt.to(torch.float32).contiguous(),
                      a_log.to(torch.float32).contiguous(), b.contiguous(),
                      c.contiguous(), chunk, h_in)


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
