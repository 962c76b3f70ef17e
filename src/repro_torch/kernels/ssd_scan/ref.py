"""Plain PyTorch SSD scan (port of ``repro/kernels/ssd_scan/ref.py``): the
path for CPU tensors, and the reference ``csrc/ssd_scan.cu`` is held
against on the card.

``ssd_chunk_dual_ref`` is the intra-chunk dual form in float32 on the
tensors' device (the JAX oracle is a float64 numpy loop); ``ssd_chunked``
is the whole-sequence chunked scan (dual form within chunks, the carried
state across them). Both mask above the diagonal BEFORE the exp.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _tril_exp(cum: torch.Tensor) -> torch.Tensor:
    """``exp(cum_t - cum_s)`` for s <= t, exactly 0 above the diagonal;
    ``cum`` (..., Q) -> (..., Q, Q)."""
    q = cum.shape[-1]
    rel = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    return torch.exp(rel.masked_fill(~tri, float("-inf")))


def ssd_chunk_dual_ref(c: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                       cum: torch.Tensor, dt: torch.Tensor,
                       state_in: torch.Tensor,
                       d_skip: torch.Tensor) -> torch.Tensor:
    """c, b: (G, Q, N); x: (G, H, Q, P); cum, dt: (G, H, Q); state_in:
    (G, H, P, N); d_skip: (H,). Returns y (G, H, Q, P) in x's dtype."""
    c, b, xf = c.float(), b.float(), x.float()
    cum, dt = cum.float(), dt.float()
    scores = torch.einsum("gtn,gsn->gts", c, b)[:, None]      # (G,1,Q,Q)
    m = scores * _tril_exp(cum) * dt[:, :, None, :]
    y = m @ xf
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "gtn,ghpn->ghtp", c, state_in.float())
    y = y + d_skip.float()[None, :, None, None] * xf
    return y.to(x.dtype)


def ssd_chunked(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                dt: torch.Tensor, log_a: torch.Tensor, *, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. x: (B, S, H, P); b, c: (B, S, N) (one group
    shared by the heads); dt: (B, S, H) positive steps; log_a: (H,).
    Returns (y (B, S, H, P) in x's dtype, final_state (B, H, P, N))."""
    bsz, s, h, pd = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    a = torch.exp(log_a.float())
    dt = dt.float()
    lg = (-dt * a).reshape(bsz, nc, chunk, h)        # log decay per step
    xs = x.reshape(bsz, nc, chunk, h, pd).float()
    bs = b.reshape(bsz, nc, chunk, n).float()
    cs = c.reshape(bsz, nc, chunk, n).float()
    dts = dt.reshape(bsz, nc, chunk, h)
    cum = torch.cumsum(lg, dim=2)                      # (B, nc, Q, H)
    total = cum[:, :, -1:, :]

    gmat = _tril_exp(cum.transpose(2, 3))             # (B, nc, H, Q, Q)
    scores = torch.einsum("bntk,bnsk->bnts", cs, bs)
    m = scores[:, :, None] * gmat * dts.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.einsum("bnhts,bnshp->bnthp", m, xs)

    w = torch.exp(total - cum) * dts                  # (B, nc, Q, H)
    chunk_state = torch.einsum("bnsh,bnsk,bnshp->bnhpk", w, bs, xs)
    decay = torch.exp(total[:, :, 0, :])              # (B, nc, H)
    state = (torch.zeros((bsz, h, pd, n), device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for i in range(nc):                               # state BEFORE chunk i
        prev.append(state)
        state = state * decay[:, i, :, None, None] + chunk_state[:, i]
    prevs = torch.stack(prev, dim=1)                  # (B, nc, H, P, N)

    y_inter = torch.einsum("bnth,bntk,bnhpk->bnthp", torch.exp(cum), cs,
                           prevs)
    y = (y_intra + y_inter).reshape(bsz, s, h, pd)
    return y.to(x.dtype), state
