"""Device-resident prioritized replay (port of ``repro/replay/device.py``).

State is a dict (``store`` + sum-tree + running max priority + per-row add
step) that lives on the run's device; ``add -> sample -> update`` never
leave it and never sync with the host. The sum-tree operations go through
``kernels.replay_tree.ops``: the CUDA kernels for a state on the card, the
plain version for one on the CPU. Semantics are the reference's:
stratified proportional sampling, ``(|p| + eps) ** alpha`` priorities,
``(N * p) ** -beta`` importance weights normalized by the batch max.
Randomness comes in as an argument: ``replay_sample`` takes its ``(B,)``
uniform draws. Operations update the state in place and return it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.replay_tree.ops import (sumtree_get, sumtree_init,
                                                 sumtree_sample, sumtree_set,
                                                 sumtree_total)
from repro_torch.replay.store import store_add, store_gather, store_init

ReplayState = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class DeviceReplayConfig:
    capacity: int
    obs_dim: int
    act_dim: int
    alpha: float = 0.6
    beta: float = 0.4
    eps: float = 1e-6
    uniform: bool = False        # ablation w/o prioritization
    n_step: int = 1              # >1: rows carry an n-step "disc" column

    def __post_init__(self):
        for f in ("capacity", "obs_dim", "act_dim", "n_step"):
            if not isinstance(getattr(self, f), int) or getattr(self, f) < 1:
                raise ValueError(f"DeviceReplayConfig.{f} must be an int "
                                 f">= 1")


def replay_init(cfg: DeviceReplayConfig, device=None) -> ReplayState:
    extra = ("disc",) if cfg.n_step > 1 else ()
    return {
        "store": store_init(cfg.capacity, cfg.obs_dim, cfg.act_dim, device,
                            extra_fields=extra),
        "tree": sumtree_init(cfg.capacity, device),
        "max_priority": torch.ones((), dtype=torch.float32, device=device),
        # learner step at which each row was written (priority staleness)
        "add_step": torch.zeros((cfg.capacity,), dtype=torch.int32,
                                device=device),
    }


def replay_add(cfg: DeviceReplayConfig, state: ReplayState,
               batch: Dict[str, torch.Tensor],
               priorities: Optional[torch.Tensor] = None,
               step: Optional[torch.Tensor] = None) -> ReplayState:
    """Append an actor batch; new rows get max priority unless given.
    ``step`` (scalar learner step) stamps the written rows."""
    _, idx = store_add(state["store"], batch)
    if step is not None:
        stamp = torch.as_tensor(step, dtype=torch.int32,
                                device=idx.device)
        state["add_step"].index_copy_(0, idx.long(), stamp.expand(idx.shape))
    if cfg.uniform:
        return state
    if priorities is None:
        pr = torch.ones(idx.shape, dtype=torch.float32,
                        device=idx.device) * state["max_priority"]
    else:
        if priorities.shape[0] > cfg.capacity:
            priorities = priorities[-cfg.capacity:]   # as store_add kept
        pr = torch.abs(priorities.to(torch.float32))
    sumtree_set(state["tree"], idx, (pr + cfg.eps) ** cfg.alpha)
    return state


def _sample_raw(cfg: DeviceReplayConfig, state: ReplayState,
                u: torch.Tensor, batch_size: int):
    """Stratified sample with unnormalized IS weights."""
    count = state["store"]["count"]
    if cfg.uniform:
        n = torch.clamp(count, min=1)
        idx = torch.minimum((u * n).to(torch.int32), n - 1)
        batch = store_gather(state["store"], idx)
        batch["add_step"] = state["add_step"][idx.long()]
        return batch, idx, torch.ones((batch_size,), dtype=torch.float32,
                                      device=u.device)
    tree = state["tree"]
    total = sumtree_total(tree)
    targets = (torch.arange(batch_size, dtype=torch.float32, device=u.device)
               + u) * (total / batch_size)
    idx, _ = sumtree_sample(tree, targets, capacity=cfg.capacity)
    idx = torch.clamp(idx, min=0)
    idx = torch.minimum(idx, torch.clamp(count - 1, min=0))
    p = sumtree_get(tree, idx) / torch.clamp(total, min=1e-12)
    w = (count * torch.clamp(p, min=1e-12)) ** (-cfg.beta)
    batch = store_gather(state["store"], idx)
    batch["add_step"] = state["add_step"][idx.long()]
    return batch, idx, w.to(torch.float32)


def replay_sample(cfg: DeviceReplayConfig, state: ReplayState,
                  u: torch.Tensor, batch_size: int
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                             torch.Tensor]:
    """``(batch, leaf idx, IS weights normalized by the batch max)``;
    ``u`` holds ``batch_size`` uniform draws on [0, 1), one per stratum."""
    if u.shape != (batch_size,):
        raise ValueError(f"replay_sample: u {tuple(u.shape)} != "
                         f"({batch_size},)")
    batch, idx, w = _sample_raw(cfg, state, u, batch_size)
    return batch, idx, w / torch.clamp(torch.max(w), min=1e-12)


def replay_update(cfg: DeviceReplayConfig, state: ReplayState,
                  idx: torch.Tensor, priorities: torch.Tensor
                  ) -> ReplayState:
    """Refresh the sampled batch's priorities from the learner's TD
    errors (a repeated index keeps its last value)."""
    if cfg.uniform:
        return state
    pr = torch.abs(priorities.to(torch.float32)) + cfg.eps
    state["max_priority"] = torch.maximum(state["max_priority"],
                                          torch.max(pr))
    sumtree_set(state["tree"], idx, pr ** cfg.alpha)
    return state


class DeviceReplay:
    """Stateful convenience wrapper; the trainer threads the state dict
    itself."""

    def __init__(self, cfg: DeviceReplayConfig, device=None):
        self.cfg = cfg
        self.state = replay_init(cfg, device)

    def __len__(self) -> int:
        return int(self.state["store"]["count"])

    @property
    def total(self) -> float:
        return float(sumtree_total(self.state["tree"]))

    def add_batch(self, batch, priorities=None) -> None:
        self.state = replay_add(self.cfg, self.state, batch, priorities)

    def sample(self, batch_size: int, u: torch.Tensor):
        return replay_sample(self.cfg, self.state, u, batch_size)

    def update_priorities(self, idx, priorities) -> None:
        self.state = replay_update(self.cfg, self.state, idx, priorities)
