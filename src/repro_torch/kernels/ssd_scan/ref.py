"""Plain PyTorch SSD scan (port of ``repro/kernels/ssd_scan/ref.py``): the
path for CPU tensors, and the reference ``csrc/ssd_scan.cu`` is held
against on the card.

``ssd_chunk_dual_ref`` is the intra-chunk dual form in float32 on the
tensors' device (the JAX oracle is a float64 numpy loop); ``ssd_chunked``
is the whole-sequence chunked scan (dual form within chunks, the carried
state across them, a sequential loop over chunks: the yardstick of
``ops.ssd_chunked_kernel``'s state pass). Both mask above the diagonal
BEFORE the exp. ``emulated_ssd_chunk`` repeats the CUDA kernel's
arithmetic for the CPU tests; no path runs it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ref import _fast_exp, _mma_rz, _parts


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


def emulated_ssd_chunk(c: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                       cum: torch.Tensor, dt: torch.Tensor,
                       state_in: torch.Tensor, d_skip: torch.Tensor, *,
                       split: bool = True, fast_exp: bool = False,
                       mma_rz: bool = False,
                       s_tile: int = 64) -> torch.Tensor:
    """``csrc/ssd_scan.cu``'s arithmetic in float32, shapes as
    ``ssd_chunk_dual_ref``. For each 64-row tile of t and each
    ``s_tile``-wide tile of s up to the diagonal: S = C_t B_s^T, then per
    head M = S o exp(cum_t - cum_s) o dt_s (0 where s > t, masked before
    the exp) and acc += M x_s, and for the rows t of this s-tile acc += D
    x_t; last, acc += exp(cum_t) (C_t state^T). Each product in split
    precision (``split``): an fp32 operand as TF32 hi and lo, lo.hi +
    hi.lo + hi.hi, where a
    bfloat16 operand (c and b, or x) is exact and has no lo, so its lo
    products are not taken (bf16 c, b: C B^T 1 product, C state^T 2; bf16
    x: M x 2); or one hi.hi TF32 product. e^x as ``__expf`` (``fast_exp``)
    or exact. Sums rounded to nearest in float32, or (``mma_rz``) as
    mma.sync adds them: each product's k8 slice into the running sum,
    rounded toward zero, in the kernel's order. Returns the float32 sums,
    which the kernel rounds to x's dtype as it stores them."""
    exp = _fast_exp if fast_exp else torch.exp
    c_lo, x_lo = split and c.dtype != torch.bfloat16, \
        split and x.dtype != torch.bfloat16
    cf, bf, xf = c.float(), b.float(), x.float()
    cum, dt, st = cum.float(), dt.float(), state_in.float()
    q = c.shape[1]

    def product(acc, a, a_lo, bm, b_lo):
        """acc + a @ bm in the kernel's split, a and bm as (hi, lo)."""
        pairs = ([(a[1], bm[0])] if a_lo else []) + \
            ([(a[0], bm[1])] if b_lo else []) + [(a[0], bm[0])]
        if mma_rz:
            return _mma_rz(acc, pairs)
        terms = [u @ v for u, v in pairs]
        return acc + sum(terms[1:], terms[0])

    y = torch.empty(x.shape, device=x.device)
    for t0 in range(0, q, 64):
        t1 = min(q, t0 + 64)
        ct = _parts(cf[:, t0:t1])                       # (G, T, N)
        acc = torch.zeros(y[:, :, t0:t1].shape, device=x.device)
        tpos = torch.arange(t0, t1, device=x.device)[:, None]
        for s0 in range(0, t1, s_tile):
            s1 = min(q, s0 + s_tile)
            bt = tuple(v.transpose(1, 2) for v in _parts(bf[:, s0:s1]))
            sc = product(torch.zeros((c.shape[0], t1 - t0, s1 - s0),
                                     device=x.device), ct, c_lo, bt, c_lo)
            ok = torch.arange(s0, s1, device=x.device)[None, :] <= tpos
            rel = cum[:, :, t0:t1, None] - cum[:, :, None, s0:s1]
            m = sc[:, None] * exp(torch.where(ok, rel, float("-inf"))) \
                * dt[:, :, None, s0:s1]
            acc = product(acc, _parts(m), True, _parts(xf[:, :, s0:s1]),
                          x_lo)
            if s0 >= t0:                                # rows t of s-tile
                r0, r1 = s0 - t0, s1 - t0
                acc[:, :, r0:r1] = acc[:, :, r0:r1] + d_skip.float()[
                    None, :, None, None] * xf[:, :, s0:s1]
        tmp = product(torch.zeros_like(acc), tuple(v[:, None] for v in ct),
                      c_lo, _parts(st.transpose(2, 3)), split)
        y[:, :, t0:t1] = acc + exp(cum[:, :, t0:t1])[..., None] * tmp
    return y
