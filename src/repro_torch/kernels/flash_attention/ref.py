"""Plain PyTorch attention (port of
``repro/kernels/flash_attention/ref.py``): the path for CPU tensors, and
the reference ``csrc/flash_attention.cu`` is held against on the card.

``attention_ref`` is the flat-head ``(BH, S, d)`` twin of the JAX oracle;
``plain_attention`` the grouped-query ``(B, S, H, hd)`` materialized-scores
twin, with a sliding window, soft-capping and a query offset. Both take
the scores in float32 and mask with a finite very negative number, so a
query row with no valid key at all gets the mean of ``v`` (uniform
weights), not 0 or NaN, as the JAX functions do.

``emulated_attention`` is neither: it mirrors the arithmetic of
``csrc/flash_attention.cu`` (split-precision TF32 products, the online
softmax over key tiles, its exp) in float32, so that its error can be held
against a float64 attention off the card (the tests) and beside the kernel
on it (the card sweep). No path runs it.
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


def _tf32(x: torch.Tensor, nearest: bool = True) -> torch.Tensor:
    """x in TF32 (10 mantissa bits): rounded to nearest with ties away from
    zero (cvt.rna.tf32.f32), or truncated toward zero, as the tensor core
    reads an fp32 register."""
    bits = x.view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _parts(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi, nearest=False)


def _fast_exp(x: torch.Tensor) -> torch.Tensor:
    """CUDA's ``__expf``: 2^(x * log2 e) of the product rounded to float32
    (the error that grows with |x|; ex2.approx's own 2 ulp are not
    modelled)."""
    return torch.exp2((x * 1.4426950408889634).double()).float()


def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def _mma_rz(c: torch.Tensor, pairs) -> torch.Tensor:
    """c + sum of a @ b over ``pairs``, one k8 slice of one pair at a time,
    as mma.sync.m16n8k8 adds them: the slice's exact sum with c, rounded
    toward zero to float32."""
    for k0 in range(0, pairs[0][0].shape[-1], 8):
        for a, b in pairs:
            c = _rz(c.double() + a[..., k0:k0 + 8].double()
                    @ b[..., k0:k0 + 8, :].double())
    return c


def emulated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool, split: bool = True,
                       fast_exp: bool = False, mma_rz: bool = False,
                       bkv: int = 64) -> torch.Tensor:
    """The kernel's arithmetic in float32 on ``(BH, S, d)`` tensors: q *
    scale, K, P and V split into TF32 hi and lo, each product summed as
    lo.hi + hi.lo + hi.hi (``split``; a bfloat16 K or V has no lo) or one
    hi.hi TF32 product; the online softmax over ``bkv``-key tiles with the
    -1e30 mask and its correction exp(m_old - m_new) on l and the output,
    e^x as ``__expf`` (``fast_exp``) or exact. The products' sums are
    float32's, rounded to nearest, or (``mma_rz``) each mma.sync's, added
    into the running scores and output one k8 slice at a time and rounded
    toward zero, the kernel's order."""
    exp = _fast_exp if fast_exp else torch.exp
    q, k, v = q.float(), k.float(), v.float()
    sq, skv, d = q.shape[1], k.shape[1], q.shape[2]
    qh, ql = _parts(q * d ** -0.5)
    m = torch.full(q.shape[:2], -1e30, device=q.device)
    l = torch.zeros(q.shape[:2], device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    for kv0 in range(0, skv, bkv):
        (kh, kl), (vh, vl) = _parts(k[:, kv0:kv0 + bkv]), \
            _parts(v[:, kv0:kv0 + bkv])
        kh, kl = kh.transpose(1, 2), kl.transpose(1, 2)
        if mma_rz:
            s = _mma_rz(torch.zeros(sq, kh.shape[2], device=q.device),
                        ((ql, kh), (qh, kl), (qh, kh)) if split else
                        ((qh, kh),))
        else:
            s = qh @ kh
            if split:
                s = (ql @ kh + qh @ kl) + s
        if causal:
            kpos = torch.arange(kv0, kv0 + kh.shape[2],
                                device=q.device)[None, :]
            s = torch.where(kpos <= qpos, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1))
        corr = exp(m - m_new)
        p = exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        ph, pl = _parts(p)
        if mma_rz:
            acc = _mma_rz(acc * corr[..., None],
                          ((pl, vh), (ph, vl), (ph, vh)) if split else
                          ((ph, vh),))
        else:
            pv = ph @ vh
            if split:
                pv = (pl @ vh + ph @ vl) + pv
            acc = acc * corr[..., None] + pv
        m = m_new
    return acc / l[..., None]
