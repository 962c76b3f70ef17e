"""Adam / AdamW with grad clipping, by hand (port of
``repro/optim/adamw.py``).

State is a tree mirroring params: ``{"mu": .., "nu": .., "count": i32}``,
the reference's layout, so it round-trips leaf for leaf through a
checkpoint of either package (``torch.optim.AdamW`` keeps other state).
``count`` stays an int32 tensor on the params' device: an update never
syncs with the host. Bias correction and the ``eps`` placement are the
reference's: ``lr * (m / bc1) / (sqrt(v / bc2) + eps)``.

``adamw_update`` issues that arithmetic as ``torch._foreach_*`` ops over
all leaves at once (on the card a few launches an op, not about ten a
leaf); ``adamw_update_ref``, the plain version, loops over the leaves. The
two are bitwise equal: the foreach version does the same operations in the
same order and uses no fused form (``alpha=``, ``addcmul``, ``lerp``),
which could contract to an FMA and change the last bit. Under
``torch.func.vmap`` (a fleet's member-batched superstep), which has no rule
for the foreach ops, ``adamw_update`` takes ``adamw_update_ref``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.common import (is_batched, tree_leaves, tree_map,
                                tree_unflatten)


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


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def _step_terms(cfg: AdamWConfig, state: Any):
    """``(count, lr, bc1, bc2)`` of the update that makes ``count``."""
    count = state["count"] + 1
    c = count.to(torch.float32)
    lr = cfg.lr * (cfg.schedule(count) if cfg.schedule is not None else 1.0)
    return (count, lr, 1.0 - torch.pow(cfg.b1, c),
            1.0 - torch.pow(cfg.b2, c))


def _new_trees(params: Any, new_p, mu, nu, count) -> Tuple[Any, Any]:
    return (tree_unflatten(params, new_p),
            {"mu": tree_unflatten(params, mu),
             "nu": tree_unflatten(params, nu), "count": count})


def adamw_update(cfg: AdamWConfig, grads: Any, state: Any, params: Any
                 ) -> Tuple[Any, Any]:
    """Returns ``(new_params, new_state)``; nothing is updated in place.
    ``adamw_update_ref``'s arithmetic as foreach ops over all leaves
    (under ``vmap``: ``adamw_update_ref`` itself)."""
    if is_batched(params) or is_batched(grads):
        return adamw_update_ref(cfg, grads, state, params)
    ps, gs = tree_leaves(params), tree_leaves(grads)
    if cfg.grad_clip_norm is not None:
        gs = torch._foreach_mul(gs, _clip_scale(global_norm(gs),
                                                cfg.grad_clip_norm))
    gs = [g.to(torch.float32) for g in gs]
    count, lr, bc1, bc2 = _step_terms(cfg, state)
    mul, add, div = torch._foreach_mul, torch._foreach_add, \
        torch._foreach_div
    mu = add(mul(tree_leaves(state["mu"]), cfg.b1), mul(gs, 1 - cfg.b1))
    nu = add(mul(tree_leaves(state["nu"]), cfg.b2),
             mul(mul(gs, gs), 1 - cfg.b2))       # square: g * g, as pow 2
    step = div(mul(div(mu, bc1), lr),
               add(torch._foreach_sqrt(div(nu, bc2)), cfg.eps))
    p32 = [p.to(torch.float32) for p in ps]
    if cfg.weight_decay:
        step = add(step, mul(p32, lr * cfg.weight_decay))
    new_p = [t.to(p.dtype) for t, p in
             zip(torch._foreach_sub(p32, step), ps)]
    return _new_trees(params, new_p, mu, nu, count)


def adamw_update_ref(cfg: AdamWConfig, grads: Any, state: Any, params: Any
                     ) -> Tuple[Any, Any]:
    """The plain version of ``adamw_update``: the same update, leaf by
    leaf."""
    if cfg.grad_clip_norm is not None:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip_norm)
    count, lr, bc1, bc2 = _step_terms(cfg, state)

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
    return _new_trees(params, [o[0] for o in out], [o[1] for o in out],
                      [o[2] for o in out], count)


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
