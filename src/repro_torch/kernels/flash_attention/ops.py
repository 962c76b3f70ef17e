"""Grouped-query attention on the ``(B, S, H, hd)`` layout (port of
``repro/kernels/flash_attention/ops.py``).

Where the reference folds the heads into the batch and repeats each KV
head G = H / KV times before its kernel, the port hands the kernel strided
``(B, H, S, hd)`` views of the caller's tensors: no transpose, no repeat,
and the output lands in ``(B, Sq, H, hd)`` directly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.flash_attention.flash_attention import (_check,
                                                                 _route,
                                                                 attend)


def gqa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd)."""
    _check(window, softcap)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2] or 0 in k.shape or 0 in q.shape:
        raise ValueError(f"gqa_flash: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; KV heads "
                         f"must divide H")
    if _route(q) == "cpu":
        return ref.plain_attention(q, k, v, causal=causal,
                                   window=window or None, attn_cap=softcap)
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    view = lambda t: t.permute(0, 2, 1, 3)
    attend(view(q), view(k), view(v), view(out), causal=causal,
           window=window, softcap=softcap)
    return out
