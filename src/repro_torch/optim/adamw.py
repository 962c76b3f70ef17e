"""Adam / AdamW with grad clipping, by hand (port of
``repro/optim/adamw.py``).

State is a tree mirroring params: ``{"mu": .., "nu": .., "count": i32}``,
the reference's layout, so it round-trips leaf for leaf through a
checkpoint of either package (``torch.optim.AdamW`` keeps other state).
``count`` stays an int32 tensor on the params' device: an update never
syncs with the host. Bias correction and the ``eps`` placement are the
reference's: ``lr * (m / bc1) / (sqrt(v / bc2) + eps)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.common import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    # schedule(count) -> multiplier; None = constant lr
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def adamw_init(params: Any) -> Any:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def adamw_update(cfg: AdamWConfig, grads: Any, state: Any, params: Any
                 ) -> Tuple[Any, Any]:
    """Returns ``(new_params, new_state)``; nothing is updated in place."""
    if cfg.grad_clip_norm is not None:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip_norm)
    count = state["count"] + 1
    c = count.to(torch.float32)
    lr = cfg.lr * (cfg.schedule(count) if cfg.schedule is not None else 1.0)
    bc1 = 1.0 - torch.pow(cfg.b1, c)
    bc2 = 1.0 - torch.pow(cfg.b2, c)

    def upd(g, m, v, p):
        g32 = g.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        step = lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            step = step + lr * cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - step).to(p.dtype), m, v

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(state["mu"]),
        tree_leaves(state["nu"]), tree_leaves(params))]
    return (tree_unflatten(params, [o[0] for o in out]),
            {"mu": tree_unflatten(params, [o[1] for o in out]),
             "nu": tree_unflatten(params, [o[2] for o in out]),
             "count": count})


def warmup_cosine(warmup_steps: int, total_steps: int, min_frac: float = 0.1
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    def sched(count: torch.Tensor) -> torch.Tensor:
        c = count.to(torch.float32)
        warm = c / max(warmup_steps, 1)
        prog = torch.clamp((c - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(c < warmup_steps, warm, cos)
    return sched
