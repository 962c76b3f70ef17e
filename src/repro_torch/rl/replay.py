"""The host replay: prioritized experience replay on a NumPy sum-tree
(port of ``repro/rl/replay.py``; Schaul et al. 2016 / Ape-X).

A host-side circular buffer with a vectorized NumPy sum-tree for
O(log N) proportional sampling (stratified, as in the PER paper) and
importance weights. ``add_batch``/``update_priorities`` take whole actor
batches: the Ape-X pattern where many actors push transitions and the
learner refreshes the priorities of the sampled batch from its TD errors
(``metrics["priorities"]`` of ``rl/sac.py`` and ``rl/td3.py``).

It stays NumPy, as the reference's: a float64 tree, ``np.unique`` per
level, a duplicate index keeping its last value, and a
``np.random.Generator`` as the sampler, so the same calls on the same
inputs give the reference's results bit for bit. (A buffer on the card is
the device replay, ``repro_torch.replay``.)

``UniformReplay`` is the ablation without prioritization.
``buffer_state``/``load_buffer_state`` copy a buffer's arrays and cursor
out and back (checkpoints and the guard's skip snapshot).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np


class SumTree:
    """Array-backed binary sum tree over ``capacity`` leaves."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.depth = int(np.ceil(np.log2(self.capacity))) + 1
        self.size = 1 << self.depth                   # leaves start at size//2
        self.tree = np.zeros(self.size, np.float64)

    @property
    def total(self) -> float:
        return float(self.tree[1])

    def set(self, idx: np.ndarray, value: np.ndarray) -> None:
        """Vectorized leaf update (duplicate idx keeps the last value)."""
        idx = np.asarray(idx, np.int64)
        value = np.asarray(value, np.float64)
        leaf = idx + self.size // 2
        self.tree[leaf] = value
        # recompute the parents level by level (vectorized, deduplicated)
        node = leaf // 2
        while node.size and node[0] >= 1:
            node = np.unique(node)
            self.tree[node] = self.tree[2 * node] + self.tree[2 * node + 1]
            if node[0] == 1:
                break
            node = node // 2

    def get(self, idx: np.ndarray) -> np.ndarray:
        return self.tree[np.asarray(idx, np.int64) + self.size // 2]

    def sample(self, targets: np.ndarray) -> np.ndarray:
        """Vectorized descent: for each target mass in [0, total) the
        leaf."""
        node = np.ones_like(targets, np.int64)
        t = np.asarray(targets, np.float64).copy()
        # root is level 0, leaves are level depth-1: depth-1 descents
        for _ in range(self.depth - 1):
            left = 2 * node
            lmass = self.tree[left]
            go_right = t >= lmass
            t = np.where(go_right, t - lmass, t)
            node = np.where(go_right, left + 1, left)
        # a target == total (or float error in the descent) can walk past
        # the last positive leaf into the zero-padded tail
        return np.clip(node - self.size // 2, 0, self.capacity - 1)


@dataclasses.dataclass
class PrioritizedReplay:
    capacity: int
    obs_dim: int
    act_dim: int
    alpha: float = 0.6
    beta: float = 0.4
    eps: float = 1e-6
    n_step: int = 1          # >1: rows carry the n-step "disc" column

    def __post_init__(self):
        c = self.capacity
        self.data = {
            "obs": np.zeros((c, self.obs_dim), np.float32),
            "act": np.zeros((c, self.act_dim), np.float32),
            "rew": np.zeros((c,), np.float32),
            "next_obs": np.zeros((c, self.obs_dim), np.float32),
            "done": np.zeros((c,), np.float32),
        }
        if self.n_step > 1:
            # bootstrap coefficient gamma^span * (1 - done), computed on
            # the run's device by replay.store.nstep_emit_flat before the
            # add
            self.data["disc"] = np.zeros((c,), np.float32)
        self.tree = SumTree(c)
        self.ptr = 0
        self.count = 0
        self.max_priority = 1.0

    def __len__(self) -> int:
        return self.count

    def add_batch(self, batch: Dict[str, np.ndarray],
                  priorities: Optional[np.ndarray] = None) -> None:
        n = batch["obs"].shape[0]
        idx = (self.ptr + np.arange(n)) % self.capacity
        for k, buf in self.data.items():
            buf[idx] = batch[k]
        if priorities is None:
            priorities = np.full((n,), self.max_priority)
        self.tree.set(idx, (np.abs(priorities) + self.eps) ** self.alpha)
        self.ptr = int((self.ptr + n) % self.capacity)
        self.count = int(min(self.count + n, self.capacity))

    def sample(self, batch_size: int, rng: np.random.Generator
               ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
        """Stratified proportional sampling; returns (batch, idx,
        is_weights)."""
        total = self.tree.total
        bounds = np.linspace(0.0, total, batch_size + 1)
        targets = rng.uniform(bounds[:-1], bounds[1:])
        idx = self.tree.sample(targets)
        idx = np.clip(idx, 0, max(self.count - 1, 0))
        p = self.tree.get(idx) / max(total, 1e-12)
        w = (self.count * np.maximum(p, 1e-12)) ** (-self.beta)
        w = (w / w.max()).astype(np.float32)
        batch = {k: v[idx] for k, v in self.data.items()}
        return batch, idx, w

    def update_priorities(self, idx: np.ndarray,
                          priorities: np.ndarray) -> None:
        pr = np.abs(np.asarray(priorities, np.float64)) + self.eps
        self.max_priority = float(max(self.max_priority,
                                      pr.max(initial=0.0)))
        self.tree.set(np.asarray(idx), pr ** self.alpha)


@dataclasses.dataclass
class UniformReplay:
    capacity: int
    obs_dim: int
    act_dim: int
    n_step: int = 1

    def __post_init__(self):
        self._inner = PrioritizedReplay(self.capacity, self.obs_dim,
                                        self.act_dim, alpha=0.0, beta=0.0,
                                        n_step=self.n_step)

    def __len__(self):
        return len(self._inner)

    def add_batch(self, batch, priorities=None):
        self._inner.add_batch(batch, None)

    def sample(self, batch_size: int, rng: np.random.Generator):
        n = len(self._inner)
        idx = rng.integers(0, n, size=batch_size)
        batch = {k: v[idx] for k, v in self._inner.data.items()}
        return batch, idx, np.ones((batch_size,), np.float32)

    def update_priorities(self, idx, priorities):
        pass


HostReplay = Union[PrioritizedReplay, UniformReplay]


def buffer_state(buf: HostReplay, rng: np.random.Generator) -> dict:
    """A copy of what a host run keeps outside its ``TrainLoopState``:
    the buffer's arrays (``data``), its float64 ``tree``, ``ptr``,
    ``count``, ``max_priority`` and the sampler's ``rng_state`` (the
    reference's checkpoint metadata keys)."""
    inner = getattr(buf, "_inner", buf)
    return {"data": {k: v.copy() for k, v in inner.data.items()},
            "tree": inner.tree.tree.copy(), "ptr": inner.ptr,
            "count": inner.count, "max_priority": inner.max_priority,
            "rng_state": rng.bit_generator.state}


def load_buffer_state(buf: HostReplay, st: dict) -> np.random.Generator:
    """Copy ``st`` (``buffer_state``'s keys) into ``buf`` in place;
    returns a new sampler in ``st["rng_state"]``."""
    inner = getattr(buf, "_inner", buf)
    for k in inner.data:
        inner.data[k][...] = st["data"][k]
    inner.tree.tree[...] = st["tree"]
    inner.ptr, inner.count = int(st["ptr"]), int(st["count"])
    inner.max_priority = float(st["max_priority"])
    rng = np.random.default_rng()
    rng.bit_generator.state = st["rng_state"]
    return rng
