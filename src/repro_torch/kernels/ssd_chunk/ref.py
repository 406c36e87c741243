"""Plain PyTorch versions of the SSD chunk scan (counterparts of
repro/kernels/ssd_chunk/ref.py and repro/models/ssm.py::_ssd_chunked).

One chunk of the state-space duality computation (arXiv:2405.21060 §6):
given per-step log-decays l = dt * A, inputs x and the B / C projections,

  y[i]  = C_i . ( sum_{j<=i} exp(cum_i - cum_j) dt_j B_j x_j^T
                  + exp(cum_i) H_in )
  H_out = exp(cum_last) H_in + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T

with cum the running sum of l inside the chunk. Every product runs in
float32 (the inputs cast up, as the Pallas kernel casts them), and y is
rounded once to x's dtype. The reference's plain versions form C . B^T in
the inputs' dtype, so in bf16 they round it where these do not.
"""
from __future__ import annotations

import torch


def ssd_chunk_ref(x, dt, log_a, b, c, h_in):
    """x: (Q, H, P); dt: (Q, H) fp32; log_a: (Q, H) fp32 (= dt * A);
    b, c: (Q, N); h_in: (H, N, P) fp32. Returns (y (Q, H, P), h_out)."""
    q = x.shape[0]
    xf = x.float()
    cum = torch.cumsum(log_a.float(), dim=0)                  # (Q, H)
    seg = cum[:, None, :] - cum[None, :, :]                   # (Q, Q, H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))[:, :, None]
    decay = torch.where(causal, torch.exp(torch.where(causal, seg,
                                                      -torch.inf)), 0.0)
    cb = torch.einsum("in,jn->ij", c.float(), b.float())      # (Q, Q)
    att = cb[:, :, None] * decay * dt.float()[None, :, :]     # (Q, Q, H)
    y_intra = torch.einsum("ijh,jhp->ihp", att, xf)
    y_inter = torch.einsum("ih,in,hnp->ihp", torch.exp(cum), c.float(),
                           h_in.float())
    decay_to_end = torch.exp(cum[-1][None] - cum)             # (Q, H)
    s_k = torch.einsum("jh,jn,jhp->hnp", decay_to_end * dt.float(),
                       b.float(), xf)
    h_out = h_in.float() * torch.exp(cum[-1])[:, None, None] + s_k
    return (y_intra + y_inter).to(x.dtype), h_out


def ssd_loop_ref(x, dt, a_log, b, c, chunk: int, init_state=None):
    """The chunk loop over ssd_chunk_ref, row by row (the reference's
    `ops._ssd_ref`). Model layout as ssd_chunked_ref."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    la = dt.float() * -torch.exp(a_log.float())
    ys, hs = [], []
    for bi in range(bsz):
        h_state = (torch.zeros((h, n, p), dtype=torch.float32,
                               device=x.device) if init_state is None
                   else init_state[bi].float())
        rows = []
        for ci in range(s // chunk):
            sl = slice(ci * chunk, (ci + 1) * chunk)
            y_c, h_state = ssd_chunk_ref(x[bi, sl], dt[bi, sl], la[bi, sl],
                                         b[bi, sl], c[bi, sl], h_state)
            rows.append(y_c)
        ys.append(torch.cat(rows, dim=0))
        hs.append(h_state)
    return torch.stack(ys), torch.stack(hs)


def ssd_chunked_ref(x, dt, a_log, b, c, chunk: int, init_state=None):
    """Vectorized chunked scan (repro/models/ssm.py:62-123).

    x: (B, S, H, P); dt: (B, S, H) fp32 post-softplus; a_log: (H,);
    b / c: (B, S, N) (one group, shared by the heads); init_state:
    (B, H, N, P) or None. S is a whole number of chunks. Returns
    (y (B, S, H, P) in x's dtype, final state (B, H, N, P) fp32)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = chunk
    assert s % q == 0, (s, q)
    nc = s // q
    la = dt.float() * -torch.exp(a_log.float())               # (B, S, H)
    lc = la.reshape(bsz, nc, q, h)
    xc = x.float().reshape(bsz, nc, q, h, p)
    dtc = dt.float().reshape(bsz, nc, q, h)
    bc = b.float().reshape(bsz, nc, q, n)
    cc = c.float().reshape(bsz, nc, q, n)
    cum = torch.cumsum(lc, dim=2)                             # (B,NC,Q,H)
    total = cum[:, :, -1]                                     # (B,NC,H)

    # intra-chunk: att[b,k,i,j,h] = exp(cum_i - cum_j) (C_i . B_j) dt_j,
    # j <= i; the upper triangle is masked in the argument, so exp never
    # sees an overflowing difference and no inf * 0 arises
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,NC,Q,Q,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    seg = torch.where(causal[None, None, :, :, None], seg, -torch.inf)
    cb = torch.einsum("bkin,bkjn->bkij", cc, bc)              # (B,NC,Q,Q)
    att = cb[..., None] * torch.exp(seg) * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", att, xc)

    # chunk summary states: S_k[n,p] = sum_j exp(total - cum_j) dt_j B_j x_j
    decay_to_end = torch.exp(total[:, :, None] - cum)         # (B,NC,Q,H)
    sk = torch.einsum("bkjh,bkjn,bkjhp->bkhnp", decay_to_end * dtc, bc, xc)

    # inter-chunk recurrence: the state entering each chunk
    state = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    prev = []
    for k in range(nc):
        prev.append(state)
        state = state * torch.exp(total[:, k])[..., None, None] + sk[:, k]
    prev_states = torch.stack(prev, dim=1)                    # (B,NC,H,N,P)

    y_inter = torch.einsum("bkih,bkin,bkhnp->bkihp", torch.exp(cum), cc,
                           prev_states)
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y.to(x.dtype), state
