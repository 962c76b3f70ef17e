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
count off the hot path. The write needs no scratch (its keep-last lives
in shared memory); the sample allocates its two outputs, which go back to
PyTorch's caching allocator when freed and are reused only in stream
order, after the kernel. ``SAMPLE_PLAN`` and ``PDL`` are the launch shape
the card sweep picked (``launch/bwd_sweep.py``); the library is built
with them as constants.

Under ``torch.func.vmap`` (a fleet's member-batched superstep) both go
through custom ops whose vmap rules take the stacked ``(E, 2**depth)``
trees and ``(E, n)`` arguments whole: on the card one launch of the
member-axis kernel (``tree_sample_members`` / ``tree_set_members``) for
all ``E`` members, on the CPU the plain versions member by member
(``ref.*_members_ref``). Outside ``vmap`` a call takes the solo route.
``sumtree_sample_members`` and ``sumtree_set_members`` are the same
launches called on stacked tensors directly.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.common import is_batched, members_first
from repro_torch.kernels.replay_tree import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "replay_tree.cu"

_count_lock = threading.Lock()
_launches = {"sample": 0, "set": 0}
_skipped: Dict[torch.device, torch.Tensor] = {}   # int32 (1,) per card

# (levels a round, lanes a target, levels staged in shared memory) of the
# sample, and programmatic dependent launch for both kernels: the picks of
# the card sweep (PERF.md)
SAMPLE_PLAN = (5, 32, 8)
PDL = True


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
    # check: disable=R004 -- the counter's one read, off the hot path
    return 0 if t is None else int(t.item())


def build_defines(sample=SAMPLE_PLAN, pdl: bool = PDL) -> Tuple[str, ...]:
    """The ``-D`` flags that fix ``replay_tree.cu``'s launch shapes."""
    k, lanes, top = sample
    return (f"-DSAMPLE_K={k}", f"-DSAMPLE_LANES={lanes}",
            f"-DSAMPLE_TOP={top}", f"-DTREE_PDL={int(pdl)}")


def library(name: str = "replay_tree", defines=None) -> ctypes.CDLL:
    """The library built with ``defines`` (``build_defines()``'s, the
    picked shapes, when None), its entry points declared."""
    from repro_torch.kernels import load_library
    lib = load_library(name, [SOURCE], defines=defines or build_defines())
    if lib.tree_sample.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tree_sample.argtypes = [p, i, i, p, i, p, p, p]
        lib.tree_set.argtypes = [p, i, p, p, i, p, p]
        lib.tree_sample_members.argtypes = [p, i, i, p, i, i, p, p, p]
        lib.tree_set_members.argtypes = [p, i, p, p, i, i, p, p]
        for entry in ("tree_sample", "tree_set", "tree_sample_members",
                      "tree_set_members"):
            getattr(lib, entry).restype = ctypes.c_int
    return lib


def _depth(tree: torch.Tensor) -> int:
    size = tree.shape[0]
    if tree.ndim != 1 or size < 4 or size & (size - 1):
        raise ValueError(f"sum-tree must be 1-D with a power-of-two size "
                         f">= 4, got {tuple(tree.shape)}")
    return size.bit_length() - 1


def _check_cuda(what: str, device: torch.device, ndim: int = 1,
                **tensors) -> None:
    for name, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, tree on "
                             f"{device}")
        if t.dtype != dtype or not t.is_contiguous() or t.ndim != ndim:
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{ndim}-D {dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _skip_counter(device: torch.device) -> torch.Tensor:
    skipped = _skipped.get(device)
    if skipped is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "sumtree_set: the skip counter of this card is made at its "
                "first write; write once before capturing a CUDA graph")
        skipped = _skipped.setdefault(device, torch.zeros(
            (1,), dtype=torch.int32, device=device))
    return skipped


def _check_leaves(idx: torch.Tensor, half: int, what: str) -> None:
    """The CPU path's check of every index, solo ``(n,)`` or ``(E, n)``."""
    # check: disable=R003 -- CPU tensors only; the card skips and counts (C0)
    if idx.numel() and not (0 <= int(idx.min()) and int(idx.max()) < half):
        raise IndexError(f"{what}: index outside the {half} leaves "
                         f"(min {int(idx.min())}, max {int(idx.max())})")


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
    ancestor sums, in place; returns ``tree``. Under ``vmap`` the write of
    every member is one member-axis launch (``sumtree_set_members``)."""
    if is_batched((tree, idx, value)):
        _set_op(tree, idx, value)
        return tree
    if _route(tree) == "cpu":
        _check_leaves(idx, tree.shape[0] // 2, "sumtree_set")
        return ref.tree_set_ref(tree, idx, value)
    depth = _depth(tree)
    idx = idx.to(torch.int32).contiguous()
    value = value.to(torch.float32).contiguous()
    _check_cuda("sumtree_set", tree.device, tree=(tree, torch.float32),
                idx=(idx, torch.int32), value=(value, torch.float32))
    if idx.shape != value.shape:
        raise ValueError(f"sumtree_set: idx {tuple(idx.shape)} and value "
                         f"{tuple(value.shape)} differ")
    skipped = _skip_counter(tree.device)
    with torch.cuda.device(tree.device):
        err = library().tree_set(
            tree.data_ptr(), depth, idx.data_ptr(), value.data_ptr(),
            idx.shape[0], skipped.data_ptr(),
            torch.cuda.current_stream(tree.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tree_set launch failed: CUDA error {err} "
                           f"(n={idx.shape[0]}, depth={depth})")
    _count("set")
    return tree


def sumtree_sample(tree: torch.Tensor, targets: torch.Tensor, *,
                   capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch proportional descent -> ``(leaf int32, leaf priority)``.
    Under ``vmap`` every member's descent is one member-axis launch
    (``sumtree_sample_members``)."""
    if is_batched((tree, targets)):
        return _sample_op(tree, targets, capacity)
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
        err = library().tree_sample(
            tree.data_ptr(), depth, capacity, targets.data_ptr(), b,
            leaf.data_ptr(), pri.data_ptr(),
            torch.cuda.current_stream(tree.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tree_sample launch failed: CUDA error {err} "
                           f"(b={b}, depth={depth})")
    _count("sample")
    return leaf, pri


# ------------------------------------------------------------ member axis

def sumtree_set_members(tree: torch.Tensor, idx: torch.Tensor,
                        value: torch.Tensor) -> torch.Tensor:
    """In each of ``E`` trees ``(E, 2**depth)``, write member ``m``'s
    ``value[m]`` at its leaves ``idx[m]`` (``(E, n)``, keep-last) and
    refresh the ancestors, in place; one launch for all members on the
    card. Returns ``tree``."""
    if tree.ndim != 2 or idx.shape != value.shape or idx.ndim != 2 \
            or idx.shape[0] != tree.shape[0]:
        raise ValueError(f"sumtree_set_members: tree {tuple(tree.shape)}, "
                         f"idx {tuple(idx.shape)}, value "
                         f"{tuple(value.shape)}: want (E, size), (E, n), "
                         f"(E, n)")
    if _route(tree) == "cpu":
        _check_leaves(idx, tree.shape[1] // 2, "sumtree_set_members")
        return ref.tree_set_members_ref(tree, idx, value)
    depth = _depth(tree[0])
    idx = idx.to(torch.int32).contiguous()
    value = value.to(torch.float32).contiguous()
    _check_cuda("sumtree_set_members", tree.device, 2,
                tree=(tree, torch.float32), idx=(idx, torch.int32),
                value=(value, torch.float32))
    skipped = _skip_counter(tree.device)
    with torch.cuda.device(tree.device):
        err = library().tree_set_members(
            tree.data_ptr(), depth, idx.data_ptr(), value.data_ptr(),
            idx.shape[1], tree.shape[0], skipped.data_ptr(),
            torch.cuda.current_stream(tree.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tree_set_members launch failed: CUDA error "
                           f"{err} (E={tree.shape[0]}, n={idx.shape[1]}, "
                           f"depth={depth})")
    _count("set")
    return tree


def sumtree_sample_members(tree: torch.Tensor, targets: torch.Tensor, *,
                           capacity: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Proportional descent in each of ``E`` trees for its ``(E, B)``
    targets -> ``(leaf (E, B) int32, priority (E, B))``; one launch for
    all members on the card."""
    if tree.ndim != 2 or targets.ndim != 2 \
            or targets.shape[0] != tree.shape[0]:
        raise ValueError(f"sumtree_sample_members: tree "
                         f"{tuple(tree.shape)}, targets "
                         f"{tuple(targets.shape)}: want (E, size), (E, B)")
    if _route(tree) == "cpu":
        leaf = ref.tree_sample_members_ref(tree, targets, capacity=capacity)
        return leaf, ref.tree_get_members_ref(tree, leaf)
    depth = _depth(tree[0])
    targets = targets.to(torch.float32).contiguous()
    _check_cuda("sumtree_sample_members", tree.device, 2,
                tree=(tree, torch.float32), targets=(targets, torch.float32))
    if not 1 <= capacity <= tree.shape[1] // 2:
        raise ValueError(f"capacity {capacity} does not fit a tree of "
                         f"{tree.shape[1]} nodes")
    e, b = targets.shape
    leaf = torch.empty((e, b), dtype=torch.int32, device=tree.device)
    pri = torch.empty((e, b), dtype=torch.float32, device=tree.device)
    with torch.cuda.device(tree.device):
        err = library().tree_sample_members(
            tree.data_ptr(), depth, capacity, targets.data_ptr(), b, e,
            leaf.data_ptr(), pri.data_ptr(),
            torch.cuda.current_stream(tree.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tree_sample_members launch failed: CUDA error "
                           f"{err} (E={e}, b={b}, depth={depth})")
    _count("sample")
    return leaf, pri


@torch.library.custom_op("repro_torch::sumtree_set", mutates_args=("tree",))
def _set_op(tree: torch.Tensor, idx: torch.Tensor,
            value: torch.Tensor) -> None:
    sumtree_set(tree, idx, value)


@torch.library.custom_op("repro_torch::sumtree_sample", mutates_args=())
def _sample_op(tree: torch.Tensor, targets: torch.Tensor,
               capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    leaf, pri = sumtree_sample(tree, targets, capacity=capacity)
    return leaf, pri


def _set_vmap(info, in_dims, tree, idx, value):
    if in_dims[0] != 0:
        raise ValueError("sumtree_set under vmap: the trees must be "
                         "stacked on their leading axis (one a member)")
    e = info.batch_size
    sumtree_set_members(tree, members_first(idx, in_dims[1], e),
                        members_first(value, in_dims[2], e))
    return None, None


def _sample_vmap(info, in_dims, tree, targets, capacity):
    e = info.batch_size
    out = sumtree_sample_members(members_first(tree, in_dims[0], e),
                                 members_first(targets, in_dims[1], e),
                                 capacity=capacity)
    return out, (0, 0)


torch.library.register_vmap("repro_torch::sumtree_set", _set_vmap)
torch.library.register_vmap("repro_torch::sumtree_sample", _sample_vmap)
