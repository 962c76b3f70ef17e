"""Plain PyTorch attention (port of
``repro/kernels/flash_attention/ref.py``): the path for CPU tensors, and
the reference ``csrc/flash_attention.cu`` is held against on the card.

``attention_ref`` is the flat-head ``(BH, S, d)`` twin of the JAX oracle;
``plain_attention`` the grouped-query ``(B, S, H, hd)`` materialized-scores
twin, with a sliding window, soft-capping and a query offset. Both take
the scores in float32 and mask with a finite very negative number, so a
query row with no valid key at all gets the mean of ``v`` (uniform
weights), not 0 or NaN, as the JAX functions do.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap else s


def _mask(sq: int, skv: int, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query may see."""
    qp = q_offset + torch.arange(sq, device=device)[:, None]
    kp = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= qp - kp < window
    return ok


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q: (BH, Sq, d); k, v: (BH, Skv, d) -> (BH, Sq, d) in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = _softcap(s, softcap)
    ok = _mask(q.shape[1], k.shape[1], causal, window or None, 0, q.device)
    s = torch.where(ok, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    attn_cap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd_v)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    qg = q.reshape(b, sq, kvh, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    s = _softcap(s, attn_cap)
    ok = _mask(sq, k.shape[1], causal, window, q_offset, q.device)
    s = s + torch.where(ok, 0.0, NEG_INF).float()
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
