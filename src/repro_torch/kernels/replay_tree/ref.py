"""Plain PyTorch sum-tree (port of ``repro/kernels/replay_tree/ref.py``):
the path for CPU tensors, and the reference the CUDA kernels are held
against on the card.

Layout: a flat float32 tensor of ``2**depth`` nodes, root at 1, leaves at
``size // 2 ..``; ``depth = ceil(log2(capacity)) + 1``.
"""
from __future__ import annotations

import math

import torch


def tree_depth(capacity: int) -> int:
    """Levels incl. the leaf level (root is level 0, leaves level depth-1)."""
    return int(math.ceil(math.log2(max(int(capacity), 2)))) + 1


def tree_size(capacity: int) -> int:
    return 1 << tree_depth(capacity)


def tree_init_ref(capacity: int, device=None) -> torch.Tensor:
    return torch.zeros((tree_size(capacity),), dtype=torch.float32,
                       device=device)


def tree_total_ref(tree: torch.Tensor) -> torch.Tensor:
    return tree[1]


def tree_get_ref(tree: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tree[idx.long() + tree.shape[0] // 2]


def keep_last(idx: torch.Tensor) -> torch.Tensor:
    """Mask of the entries that win a keep-last write: for every repeated
    index, only its last position (``index_put_`` with repeated indices
    has no defined winner, so the winner is made explicit)."""
    n = idx.shape[0]
    pos = torch.arange(n, device=idx.device)
    uniq, inv = torch.unique(idx, return_inverse=True)
    last = torch.full(uniq.shape, -1, dtype=pos.dtype, device=idx.device)
    last = last.scatter_reduce(0, inv, pos, reduce="amax")
    return last[inv] == pos


def tree_set_ref(tree: torch.Tensor, idx: torch.Tensor,
                 value: torch.Tensor) -> torch.Tensor:
    """Leaf write (keep-last for repeated ``idx``) + bottom-up parent
    recompute as ``left + right``, in place; returns ``tree``."""
    size = tree.shape[0]
    depth = size.bit_length() - 1                # size == 2**depth
    idx = idx.long()
    keep = keep_last(idx)
    leaf = idx[keep] + size // 2
    tree[leaf] = value.to(tree.dtype)[keep]
    node = torch.unique(leaf // 2)
    for _ in range(depth - 1):                   # levels depth-2 .. 0 (root)
        tree[node] = tree[2 * node] + tree[2 * node + 1]
        node = torch.unique(node // 2)
    return tree


def tree_sample_ref(tree: torch.Tensor, targets: torch.Tensor, *,
                    capacity: int) -> torch.Tensor:
    """Proportional descent; leaves (int32) clamped to [0, capacity)."""
    node = torch.ones(targets.shape, dtype=torch.long, device=tree.device)
    t = targets.to(torch.float32)
    for _ in range(tree.shape[0].bit_length() - 2):   # depth-1 descents
        left = 2 * node
        lmass = tree[left]
        go_right = t >= lmass
        t = torch.where(go_right, t - lmass, t)
        node = torch.where(go_right, left + 1, left)
    leaf = torch.clamp(node - tree.shape[0] // 2, 0, capacity - 1)
    return leaf.to(torch.int32)
