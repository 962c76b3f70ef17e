"""Fused dense layer ``act(x @ w + b)`` (port of
``repro/kernels/dense_block/dense_block.py``).

``fused_dense`` and ``segmented_dense`` (the DenseNet layer over column
segments, ``ops.dense_concat_matmul``) launch ``csrc/fused_dense.cu`` once
on CUDA tensors, or raise: there is no fallback. On CPU tensors they run
the plain versions of ``ref.py``. Each launch adds one to
``launch_count()``.

The TPU kernel's block sizes ``bm/bn/bk`` and its ``interpret`` flag do not
carry over: the CUDA kernel picks its own tiles, masks ragged M, K and N
edges (so nobody pads), and there is no interpreter; the port's signatures
drop them. Inputs are float32 or bfloat16; parts, ``w`` and ``b`` share one
dtype, and the output has it. Split-K workspaces and counters are
``torch.empty``/``torch.zeros`` tensors freed after the launch: PyTorch's
caching allocator hands their memory out again only in stream order.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.dense_block import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_dense.cu"
ACT_CODE = {"identity": 0, "relu": 1, "tanh": 2, "swish": 3, "silu": 3,
            "gelu": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = (64, 64, 16)          # (BM, BN, BK) of csrc/fused_dense.cu
MAX_PARTS = 128              # kMaxSegs of csrc/fused_dense.cu
# split K until the grid holds about this many blocks per SM ...
_BLOCKS_PER_SM = 2
# ... but give each split at least this many BK chunks
_MIN_CHUNKS_PER_SPLIT = 4

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


def _library() -> ctypes.CDLL:
    from repro_torch.kernels import load_library
    lib = load_library("fused_dense", [SOURCE])
    fn = lib.fused_dense_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, p, p, p, p, ll, p, p, ll, p, p, i, i, i, i, i,
                       p]
        fn.restype = ctypes.c_int
    return lib


def plan(m: int, n: int, chunks: int, num_sms: int) -> Tuple[int, int, int]:
    """``(tiles, splits, chunks_per_split)`` of one launch with an
    ``(m, n)`` output and ``chunks`` BK-chunks of K (summed over the
    segments): K is split until the grid holds ~``_BLOCKS_PER_SM`` blocks
    per SM, each split keeping at least ``_MIN_CHUNKS_PER_SPLIT`` chunks."""
    bm, bn, _ = TILE
    tiles = -(-m // bm) * -(-n // bn)
    want = -(-_BLOCKS_PER_SM * num_sms // tiles)
    splits = max(1, min(want, chunks // _MIN_CHUNKS_PER_SPLIT))
    per_split = max(1, -(-chunks // splits))
    return tiles, max(1, -(-chunks // per_split)), per_split


def _check_cuda(parts: Sequence[torch.Tensor], w: torch.Tensor,
                b: Optional[torch.Tensor]) -> None:
    x = parts[0]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_dense kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    named = [(f"parts[{i}]", t) for i, t in enumerate(parts)] + [("w", w)]
    if b is not None:
        named.append(("b", b))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"fused_dense: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"fused_dense: {name} is {t.dtype}, x is "
                            f"{x.dtype}; the kernel takes one dtype")
        if t.ndim and t.stride(-1) != 1:
            raise ValueError(f"fused_dense: {name} needs unit stride in its "
                             f"last dimension")
        if t.ndim > 1 and t.stride(0) >= 2 ** 31:
            raise ValueError(f"fused_dense: {name}'s row stride does not "
                             f"fit an int")


def _launch(parts: Sequence[torch.Tensor], w: torch.Tensor,
            b: Optional[torch.Tensor], activation: str) -> torch.Tensor:
    """One launch of ``csrc/fused_dense.cu`` over the column segments
    ``parts`` (shapes already checked)."""
    parts = [t for t in parts if t.shape[1] > 0]
    _check_cuda(parts, w, b)
    if len(parts) > MAX_PARTS:
        raise ValueError(f"fused_dense kernel takes at most {MAX_PARTS} "
                         f"parts in one launch, got {len(parts)}")
    m, n = parts[0].shape[0], w.shape[1]
    dev, dtype = parts[0].device, parts[0].dtype
    out = torch.empty((m, n), device=dev, dtype=dtype)
    if m == 0 or n == 0:
        return out
    bk = TILE[2]
    chunks = sum(-(-t.shape[1] // bk) for t in parts)
    lib = _library()
    with torch.cuda.device(dev):
        num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tiles, splits, per_split = plan(m, n, chunks, num_sms)
        ws = counters = None
        if splits > 1:
            ws = torch.empty((splits, m, n), device=dev, dtype=torch.float32)
            counters = torch.zeros((tiles,), device=dev, dtype=torch.int32)
        k = len(parts)
        err = lib.fused_dense_fwd(
            _DTYPE_CODE[dtype], k,
            (ctypes.c_longlong * k)(*(t.data_ptr() for t in parts)),
            (ctypes.c_int * k)(*(t.stride(0) for t in parts)),
            (ctypes.c_int * k)(*(t.shape[1] for t in parts)),
            w.data_ptr(), w.stride(0), None if b is None else b.data_ptr(),
            out.data_ptr(), out.stride(0),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            m, n, ACT_CODE[activation], splits, per_split,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_dense_fwd launch failed: CUDA error {err} "
                           f"(m={m}, n={n}, parts={k}, splits={splits})")
    _count_launch()
    return out


def segmented_dense(parts: Sequence[torch.Tensor], w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *,
                    activation: str = "swish") -> torch.Tensor:
    """``act(concat(parts, -1) @ w + b)`` without building the concat:
    ``parts`` are 2-D ``(M, k_i)``, ``w`` is ``(sum k_i, N)``."""
    if activation not in ACT_CODE:
        raise ValueError(f"unknown activation {activation!r}; have "
                         f"{sorted(ACT_CODE)}")
    parts = list(parts)
    if not parts or any(t.ndim != 2 for t in parts) or w.ndim != 2:
        raise ValueError("fused_dense takes 2-D parts and a 2-D w")
    if len({t.shape[0] for t in parts}) != 1:
        raise ValueError(f"fused_dense: parts differ in rows "
                         f"{[tuple(t.shape) for t in parts]}")
    k = sum(t.shape[1] for t in parts)
    if k == 0 or w.shape[0] != k or (
            b is not None and tuple(b.shape) != (w.shape[1],)):
        raise ValueError(f"fused_dense: K={k}, w {tuple(w.shape)}, b "
                         f"{None if b is None else tuple(b.shape)}")
    device = parts[0].device
    if device.type == "cpu":
        return ref.dense_concat_matmul_ref(parts, w, b, activation)
    if device.type != "cuda":
        raise ValueError(f"fused_dense runs on cuda (kernel) or cpu (plain "
                         f"version), not {device}")
    return _launch(parts, w, b, activation)


def fused_dense(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, *,
                activation: str = "swish") -> torch.Tensor:
    """``act(x @ w + b)``. x: (M, K); w: (K, N); b: (N,) or None."""
    return segmented_dense([x], w, b, activation=activation)
