"""The full chunked SSD scan on the intra-chunk kernel (port of
``repro/kernels/ssd_scan/ops.py``).

Each chunk's heavy work (the dual form, the carried state's output, the D
skip) goes through ``ssd_chunk_dual``. The chunk states and the
chunk-to-chunk recurrence stay plain torch ops on the tensors' device, as
the reference leaves them to XLA and ``lax.scan``, but in a fixed number of
ops whatever the number of chunks: the chunk states are one batched
product, and every state before a chunk (and the final one) is one product
with the (nc + 1, nc) matrix of decays between chunks (``chunk_decays``).
The kernel reads the chunks of x, the decays and dt as strided views and
writes y into ``(B, S, H, P)`` directly: nothing is transposed.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk_dual


def chunk_decays(total: torch.Tensor) -> torch.Tensor:
    """``L`` (..., nc + 1, nc) from the chunks' total log decays ``total``
    (..., nc): ``L[n, m] = exp(sum_{m < j < n} total_j)`` for m < n, else 0,
    so the state before chunk n is ``sum_m L[n, m] chunk_state_m`` (row nc:
    the final state). The sums are segment sums, each over its own chunks
    (a masked cumulative sum, masked to -inf above the diagonal before the
    exp), never the difference of two long cumulative sums, whose fp32
    spacing would swamp the short ones."""
    nc = total.shape[-1]
    ones = torch.ones((nc, nc), dtype=torch.bool, device=total.device)
    # seg[i, m] = sum_{m < j <= i} total_j for m <= i
    rep = total[..., :, None].expand(*total.shape, nc)
    seg = torch.cumsum(rep.masked_fill(~ones.tril(-1), 0.0), dim=-2)
    seg = seg.masked_fill(~ones.tril(), float("-inf"))
    return F.pad(torch.exp(seg), (0, 0, 1, 0))      # row 0: no chunk before


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

    # chunk_state[b, n, h] = (x w)^T B over the chunk: (P, Q) @ (Q, N)
    w = torch.exp(total[:, :, None] - cum) * dts       # (B, nc, Q, H)
    xw = (xs.float() * w[..., None]).permute(0, 1, 3, 4, 2)
    chunk_state = xw @ bs[:, :, None]                  # (B, nc, H, P, N)
    # states before each chunk (rows 0..nc-1) and the final one (row nc)
    decays = chunk_decays(total.transpose(1, 2))       # (B, H, nc+1, nc)
    states = decays @ chunk_state.transpose(1, 2).reshape(bsz, h, nc, p * n)
    states = states.reshape(bsz, h, nc + 1, p, n)
    prevs = states[:, :, :nc].transpose(1, 2)          # (B, nc, H, P, N)

    g = bsz * nc
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    heads_first = lambda t: t.transpose(2, 3).reshape(g, h, chunk, *t.shape[4:])
    ssd_chunk_dual(cs.reshape(g, chunk, n), bs.reshape(g, chunk, n),
                   heads_first(xs), heads_first(cum), heads_first(dts),
                   prevs.reshape(g, h, p, n), d_skip,
                   out=heads_first(y.reshape(bsz, nc, chunk, h, p)))
    return y, states[:, :, nc].contiguous()
