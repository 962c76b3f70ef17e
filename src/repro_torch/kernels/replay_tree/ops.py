"""Sum-tree operations of the device replay (port of
``repro/kernels/replay_tree/ops.py``).

``sumtree_set`` and ``sumtree_sample`` launch ``csrc/replay_tree.cu`` on
CUDA tensors (or raise) and run the plain version of ``ref.py`` on CPU
tensors; there is no fallback. Both update or read the tree in place on
PyTorch's current stream and never sync with the host. Each counts its
launches. ``sumtree_set`` keeps the LAST write of a repeated index (the
rule of the reference's ``tree_set_onehot`` and host ``SumTree``). An
index outside the tree's leaves (the replay never produces one) raises on
CPU tensors; on the card, where checking it would cost a host sync per
write, the kernel skips it and counts it, and ``skipped_writes`` reads the
count off the hot path. Temporaries freed after a launch
go back to PyTorch's caching allocator, which reuses them only in stream
order, after the kernel.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels.replay_tree import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "replay_tree.cu"

_count_lock = threading.Lock()
_launches = {"sample": 0, "set": 0}
_skipped: Dict[torch.device, torch.Tensor] = {}   # int32 (1,) per card


def launch_count(which: str) -> int:
    """Launches of the ``"sample"`` or ``"set"`` kernel since the last
    ``reset_launch_count``."""
    return _launches[which]


def reset_launch_count() -> None:
    with _count_lock:
        for k in _launches:
            _launches[k] = 0


def _count(which: str) -> None:
    with _count_lock:
        _launches[which] += 1


def skipped_writes(device) -> int:
    """Entries ``sumtree_set`` skipped on ``device`` since the process
    started because their index lay outside the leaves (syncs the card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t = _skipped.get(device)
    return 0 if t is None else int(t.item())


def _library() -> ctypes.CDLL:
    from repro_torch.kernels import load_library
    lib = load_library("replay_tree", [SOURCE])
    if lib.tree_sample.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tree_sample.argtypes = [p, i, i, p, i, p, p, p]
        lib.tree_set.argtypes = [p, i, p, p, i, p, p, p]
        lib.tree_sample.restype = lib.tree_set.restype = ctypes.c_int
    return lib


def _depth(tree: torch.Tensor) -> int:
    size = tree.shape[0]
    if tree.ndim != 1 or size < 4 or size & (size - 1):
        raise ValueError(f"sum-tree must be 1-D with a power-of-two size "
                         f">= 4, got {tuple(tree.shape)}")
    return size.bit_length() - 1


def _check_cuda(what: str, device: torch.device, **tensors) -> None:
    for name, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, tree on "
                             f"{device}")
        if t.dtype != dtype or not t.is_contiguous() or t.ndim != 1:
            raise ValueError(f"{what}: {name} must be a contiguous 1-D "
                             f"{dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _route(tree: torch.Tensor) -> str:
    if tree.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sum-tree runs on cuda (kernel) or cpu (plain "
                         f"version), not {tree.device}")
    return tree.device.type


def sumtree_init(capacity: int, device=None) -> torch.Tensor:
    """Zeroed flat tree: 2**depth float32 nodes, root at 1."""
    return ref.tree_init_ref(capacity, device)


def sumtree_total(tree: torch.Tensor) -> torch.Tensor:
    return ref.tree_total_ref(tree)


def sumtree_get(tree: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return ref.tree_get_ref(tree, idx)


def sumtree_set(tree: torch.Tensor, idx: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
    """Write ``value`` at leaves ``idx`` (keep-last) and refresh the
    ancestor sums, in place; returns ``tree``."""
    if _route(tree) == "cpu":
        half = tree.shape[0] // 2
        if idx.numel() and not (0 <= int(idx.min())
                                and int(idx.max()) < half):
            raise IndexError(f"sumtree_set: index outside the {half} leaves "
                             f"(min {int(idx.min())}, max {int(idx.max())})")
        return ref.tree_set_ref(tree, idx, value)
    depth = _depth(tree)
    idx = idx.to(torch.int32).contiguous()
    value = value.to(torch.float32).contiguous()
    _check_cuda("sumtree_set", tree.device, tree=(tree, torch.float32),
                idx=(idx, torch.int32), value=(value, torch.float32))
    if idx.shape != value.shape:
        raise ValueError(f"sumtree_set: idx {tuple(idx.shape)} and value "
                         f"{tuple(value.shape)} differ")
    owner = torch.empty((tree.shape[0] // 2,), dtype=torch.int32,
                        device=tree.device)
    skipped = _skipped.get(tree.device)
    if skipped is None:
        skipped = _skipped.setdefault(tree.device, torch.zeros(
            (1,), dtype=torch.int32, device=tree.device))
    with torch.cuda.device(tree.device):
        err = _library().tree_set(
            tree.data_ptr(), depth, idx.data_ptr(), value.data_ptr(),
            idx.shape[0], owner.data_ptr(), skipped.data_ptr(),
            torch.cuda.current_stream(tree.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tree_set launch failed: CUDA error {err} "
                           f"(n={idx.shape[0]}, depth={depth})")
    _count("set")
    return tree


def sumtree_sample(tree: torch.Tensor, targets: torch.Tensor, *,
                   capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch proportional descent -> ``(leaf int32, leaf priority)``."""
    if _route(tree) == "cpu":
        leaf = ref.tree_sample_ref(tree, targets, capacity=capacity)
        return leaf, ref.tree_get_ref(tree, leaf)
    depth = _depth(tree)
    targets = targets.to(torch.float32).contiguous()
    _check_cuda("sumtree_sample", tree.device, tree=(tree, torch.float32),
                targets=(targets, torch.float32))
    if not 1 <= capacity <= tree.shape[0] // 2:
        raise ValueError(f"capacity {capacity} does not fit a tree of "
                         f"{tree.shape[0]} nodes")
    b = targets.shape[0]
    leaf = torch.empty((b,), dtype=torch.int32, device=tree.device)
    pri = torch.empty((b,), dtype=torch.float32, device=tree.device)
    with torch.cuda.device(tree.device):
        err = _library().tree_sample(
            tree.data_ptr(), depth, capacity, targets.data_ptr(), b,
            leaf.data_ptr(), pri.data_ptr(),
            torch.cuda.current_stream(tree.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tree_sample launch failed: CUDA error {err} "
                           f"(b={b}, depth={depth})")
    _count("sample")
    return leaf, pri
