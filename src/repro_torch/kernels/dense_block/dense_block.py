"""Fused dense layer ``act(x @ w + b)`` (port of
``repro/kernels/dense_block/dense_block.py``).

``fused_dense`` and ``segmented_dense`` (the DenseNet layer over column
segments, ``ops.dense_concat_matmul``) launch ``csrc/fused_dense.cu`` once
on CUDA tensors, or raise: there is no fallback. On CPU tensors they run
the plain versions of ``ref.py``. Each launch adds one to
``launch_count()``.

The kernel runs on the tensor cores in split-precision TF32 ("3xTF32": each
fp32 operand as a TF32 high part plus its TF32 residual, three products
summed in fp32; a bfloat16 operand is exact in TF32 and takes one), held
to the fp32 plain version at the same 1e-4 bar as an fp32 product. The TPU
kernel's block sizes ``bm/bn/bk`` and its ``interpret`` flag do not carry
over: ``plan`` picks the tiles and splits, the kernel masks ragged M, K and
N edges (so nobody pads), and there is no interpreter; the port's
signatures drop them. Inputs are float32 or bfloat16; parts, ``w`` and
``b`` share one dtype, and the output has it. Split-K workspaces and
counters are ``torch.empty``/``torch.zeros`` tensors freed after the
launch: PyTorch's caching allocator hands their memory out again only in
stream order.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.dense_block import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_dense.cu"
ACT_CODE = {"identity": 0, "relu": 1, "tanh": 2, "swish": 3, "silu": 3,
            "gelu": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (BM, BN) of the block tile by config id (csrc/fused_dense.cu's
# launch_config: 8 warps of 32x16 outputs, 16 of 32x32), and the K of a
# chunk (BK)
TILES = ((64, 64), (128, 128))
BK = 32
MAX_PARTS = 128              # kMaxSegs of csrc/fused_dense.cu
# split K until the grid holds up to this many blocks per SM (the 64x64
# tile's ring of four stages takes 74 KB of shared memory: three an SM) ...
_BLOCKS_PER_SM = 3
# ... but give each split at least this many BK chunks
_MIN_CHUNKS_PER_SPLIT = 8

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
        fn.argtypes = [i, i, i, p, p, p, p, ll, p, p, ll, p, p, i, i, i, i,
                       i, p]
        fn.restype = ctypes.c_int
    return lib


def chunks_of(widths: Sequence[int]) -> List[Tuple[int, int, int]]:
    """The kernel's walk over K: ``(part, first column, columns)`` of every
    BK-chunk, part by part; a chunk never straddles two parts."""
    return [(i, k0, min(BK, k - k0)) for i, k in enumerate(widths)
            for k0 in range(0, k, BK)]


def plan(m: int, n: int, chunks: int, num_sms: int
         ) -> Tuple[int, int, int, int]:
    """``(config, tiles, splits, chunks_per_split)`` of one launch with an
    ``(m, n)`` output and ``chunks`` BK-chunks of K (summed over the
    segments): 64x64 tiles, and K split until the grid holds up to
    ``_BLOCKS_PER_SM`` blocks per SM, each split keeping at least
    ``_MIN_CHUNKS_PER_SPLIT`` chunks. Split s takes chunks ``[s * per, (s +
    1) * per)`` of ``chunks_of``'s walk. The rule follows the card
    (``launch/bwd_sweep.py``, H100): at the Ant layer 3 (M=256, N=2048, K
    =4207) the 64x64 tile at 3 splits was the best of every tile and split
    (the 128x128 tile's best: 4 splits, 22% slower), and at the
    kernels_micro row (M=64, N=256, K=2159) at 8 splits."""
    bm, bn = TILES[0]
    tiles = -(-m // bm) * -(-n // bn)
    want = max(1, _BLOCKS_PER_SM * num_sms // tiles)
    splits = max(1, min(want, chunks // _MIN_CHUNKS_PER_SPLIT))
    per_split = max(1, -(-chunks // splits))
    return 0, tiles, max(1, -(-chunks // per_split)), per_split


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
            b: Optional[torch.Tensor], activation: str,
            forced: Optional[Tuple[int, int, int, int]] = None
            ) -> torch.Tensor:
    """One launch of ``csrc/fused_dense.cu`` over the column segments
    ``parts`` (shapes already checked), as ``plan`` plans it or as
    ``forced`` (a plan of the same shape: the card sweep's candidates)."""
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
    chunks = len(chunks_of([t.shape[1] for t in parts]))
    lib = _library()
    with torch.cuda.device(dev):
        num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        config, tiles, splits, per_split = forced or plan(m, n, chunks,
                                                          num_sms)
        ws = counters = None
        if splits > 1:
            ws = torch.empty((splits, m, n), device=dev, dtype=torch.float32)
            counters = torch.zeros((tiles,), device=dev, dtype=torch.int32)
        k = len(parts)
        err = lib.fused_dense_fwd(
            config, _DTYPE_CODE[dtype], k,
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
                           f"(m={m}, n={n}, parts={k}, config={config}, "
                           f"splits={splits})")
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
