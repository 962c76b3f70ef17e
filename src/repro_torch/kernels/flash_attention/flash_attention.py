"""Forward flash attention (port of
``repro/kernels/flash_attention/flash_attention.py``).

``flash_attention`` (flat heads, ``(BH, S, d)``) and ``ops.gqa_flash``
(grouped-query ``(B, S, H, hd)``) launch ``csrc/flash_attention.cu`` once
on CUDA tensors, or raise: there is no fallback. On CPU tensors they run
the plain versions of ``ref.py``. Each launch adds one to
``launch_count()``.

The kernel reads q, k, v and writes the output through strides, so neither
layout is transposed or copied and the GQA wrapper does not repeat K/V: the
kernel maps query head h to kv head ``h // (H // KV)``. The TPU kernel's
block sizes ``bq/bkv`` and its ``interpret`` flag do not carry over (the
CUDA kernel masks ragged Sq and Skv, so neither needs to be a multiple of a
block). Inputs are float32 or bfloat16, one dtype for q, k and v, head dim
at most 128. ``PLAN`` is the kernel's launch shape and exp form, the card
sweep's pick (``launch/bwd_sweep.py --only flash``); the library is built
with it as constants (``build_defines``), so the wrapper has no runtime
knob.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (warps a block, keys a tile, fast exp): a block owns 16 query rows a warp
# and streams K/V tiles through a 2-stage ring; the softmax's e^x is
# ``__expf`` if fast exp is 1, else ``expf``
PLAN = (4, 64, 1)

_count_lock = threading.Lock()
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _count_launch() -> None:
    global _launches
    with _count_lock:
        _launches += 1


def build_defines(plan=PLAN) -> Tuple[str, ...]:
    """The ``-D`` flags that fix ``flash_attention.cu``'s launch shape and
    exp form."""
    warps, bkv, fast_exp = plan
    return (f"-DFLASH_WARPS={warps}", f"-DFLASH_BKV={bkv}",
            f"-DFLASH_FAST_EXP={int(fast_exp)}")


def _library(name: str = "flash_attention", defines=None) -> ctypes.CDLL:
    """The library built with ``defines`` (``build_defines()``'s, the
    picked shape, when None), its entry point declared."""
    from repro_torch.kernels import load_library
    lib = load_library(name, [SOURCE], defines=defines or build_defines())
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return lib


def _route(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda (kernel) or cpu "
                         f"(plain version), not {q.device}")
    return q.device.type


def _check(window: int, softcap: float) -> None:
    if window < 0 or softcap < 0:
        raise ValueError(f"window {window} and softcap {softcap} must be "
                         f">= 0 (0 turns either off)")


def _launch(entry, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, causal: bool, window: int,
            softcap: float) -> None:
    """One launch of the C entry ``entry`` (``flash_attention_fwd``'s
    arguments) on checked ``(B, H, S, d)`` views; raises on a CUDA error."""
    bsz, heads, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = entry(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), (ctypes.c_longlong * 12)(*strides), bsz, heads,
            kvh, sq, skv, d, int(causal), int(window), float(softcap),
            d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry.__name__} launch failed: CUDA error "
                           f"{err} (B={bsz}, H={heads}, KV={kvh}, Sq={sq}, "
                           f"Skv={skv}, d={d})")


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, causal: bool, window: int,
           softcap: float) -> torch.Tensor:
    """One launch on ``(B, H, S, d)`` views (any strides, unit stride in
    d): q and ``out`` ``(B, H, Sq, d)``, k and v ``(B, KV, Skv, d)``.
    Writes ``out`` and returns it."""
    d = q.shape[-1]
    named = (("q", q), ("k", k), ("v", v), ("out", out))
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"flash attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}; the kernel takes one dtype")
        if t.stride(-1) != 1:
            raise ValueError(f"flash attention: {name} needs unit stride in "
                             f"the head dim")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    _launch(_library().flash_attention_fwd, q, k, v, out, causal, window,
            softcap)
    _count_launch()
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (BH, Sq, d); k, v: (BH, Skv, d) -> (BH, Sq, d) in q's dtype."""
    _check(window, softcap)
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] \
            or 0 in k.shape or 0 in q.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if _route(q) == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    attend(q.unsqueeze(1), k.unsqueeze(1), v.unsqueeze(1), out.unsqueeze(1),
           causal=causal, window=window, softcap=softcap)
    return out
