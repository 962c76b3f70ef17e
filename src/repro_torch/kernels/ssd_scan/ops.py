"""The full chunked SSD scan on the intra-chunk kernel (port of
``repro/kernels/ssd_scan/ops.py``).

Each chunk's heavy work (the dual form, the carried state's output, the D
skip) goes through ``ssd_chunk_dual``; the chunk-state einsum and the
chunk-to-chunk recurrence (O(n_chunks), sequential) stay plain torch ops on
the tensors' device, as the reference leaves them to XLA and ``lax.scan``.
The kernel reads the chunks of x, the decays and dt as strided views and
writes y into ``(B, S, H, P)`` directly: nothing is transposed.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk_dual


def ssd_chunked_kernel(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       dt: torch.Tensor, log_a: torch.Tensor,
                       d_skip: torch.Tensor, *, chunk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P); b, c: (B, S, N); dt: (B, S, H); log_a, d_skip:
    (H,). Returns (y (B, S, H, P) in x's dtype, final_state (B, H, P, N))."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    a = torch.exp(log_a.float())
    dt = dt.float()
    dts = dt.reshape(bsz, nc, chunk, h)
    cum = torch.cumsum(-dts * a, dim=2)                # (B, nc, Q, H)
    total = cum[:, :, -1, :]
    bs = b.reshape(bsz, nc, chunk, n).float()
    cs = c.reshape(bsz, nc, chunk, n).float()
    xs = x.reshape(bsz, nc, chunk, h, p)

    w = torch.exp(total[:, :, None] - cum) * dts
    chunk_state = torch.einsum("bnsh,bnsk,bnshp->bnhpk", w, bs, xs.float())
    dec = torch.exp(total)                             # (B, nc, H)
    state = torch.zeros((bsz, h, p, n), device=x.device)
    prev = []
    for i in range(nc):                                # state BEFORE chunk i
        prev.append(state)
        state = state * dec[:, i, :, None, None] + chunk_state[:, i]
    prevs = torch.stack(prev, dim=1)                   # (B, nc, H, P, N)

    g = bsz * nc
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    heads_first = lambda t: t.transpose(2, 3).reshape(g, h, chunk, *t.shape[4:])
    ssd_chunk_dual(cs.reshape(g, chunk, n), bs.reshape(g, chunk, n),
                   heads_first(xs), heads_first(cum), heads_first(dts),
                   prevs.reshape(g, h, p, n), d_skip,
                   out=heads_first(y.reshape(bsz, nc, chunk, h, p)))
    return y, state
