"""Adam / AdamW with grad clipping, by hand (port of
``repro/optim/adamw.py``).

State is a tree mirroring params: ``{"mu": .., "nu": .., "count": i32}``,
the reference's layout, so it round-trips leaf for leaf through a
checkpoint of either package (``torch.optim.AdamW`` keeps other state).
``count`` stays an int32 tensor on the params' device: an update never
syncs with the host. Bias correction and the ``eps`` placement are the
reference's: ``lr * (m / bc1) / (sqrt(v / bc2) + eps)``.

``adamw_update`` hands every leaf and the step count to ``_adamw_step``
(a scheduled ``lr`` and the clip scale, which no config of the port sets,
it computes first with torch ops). On the card that is ONE launch of
``csrc/adamw.cu`` over all leaves (one per 40 leaves past that), bias
corrections and the new ``count`` included: a leaf that is not contiguous
is copied to a contiguous one first, and a dtype other than float32
raises. CPU tensors take the same arithmetic as foreach ops over all
leaves (``_foreach_step``). Under ``torch.func.vmap`` (a fleet's
member-batched superstep) the call goes through ``_adamw_step`` as the
custom op ``repro_torch::adamw_step``, whose vmap rule moves the member
axis of every argument first and calls the op again: on the card the same
launch then covers the stacked ``(E, ...)`` leaves, each member with its
own count (a nested vmap stacks its members on the leading axes alike); on
the CPU it runs leaf by leaf as ``adamw_update_ref`` does (vmap has no
rule for the foreach ops). Every route is bitwise ``adamw_update_ref``,
the plain version: each does the same float32 operations in the same
order, and none uses a fused form (``alpha=``, ``addcmul``, ``lerp``, an
FMA), which could change the last bit. ``adamw_path_counts`` counts the
kernel's launches (``"kernel"``) and the CPU calls (``"fallback"``) as
they are issued (under a CUDA graph: at capture).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.common import (is_batched, members_first, tree_leaves,
                                tree_map, tree_unflatten)
from repro_torch.obs.trace import stamp

SOURCE = Path(__file__).resolve().parent / "csrc" / "adamw.cu"

_count_lock = threading.Lock()
_paths = {"kernel": 0, "fallback": 0}


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


def adamw_path_counts() -> Dict[str, int]:
    """Since the last reset: ``"kernel"``, the launches of ``csrc/adamw.cu``
    (one a call of up to 40 leaves), and ``"fallback"``, the calls on CPU
    tensors (torch ops)."""
    with _count_lock:
        return dict(_paths)


def reset_adamw_path_counts() -> None:
    with _count_lock:
        for k in _paths:
            _paths[k] = 0


def _count(path: str, n: int = 1) -> None:
    with _count_lock:
        _paths[path] += n


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


def _bias_terms(count: torch.Tensor, b1: float, b2: float):
    """``(count + 1, bc1, bc2)``: the update's count and bias corrections."""
    count = count + 1
    c = count.to(torch.float32)
    return count, 1.0 - torch.pow(b1, c), 1.0 - torch.pow(b2, c)


def _step_terms(cfg: AdamWConfig, state: Any):
    """``(count, lr, bc1, bc2)`` of the update that makes ``count``."""
    count, bc1, bc2 = _bias_terms(state["count"], cfg.b1, cfg.b2)
    lr = cfg.lr * (cfg.schedule(count) if cfg.schedule is not None else 1.0)
    return count, lr, bc1, bc2


def _new_trees(params: Any, new_p, mu, nu, count) -> Tuple[Any, Any]:
    return (tree_unflatten(params, new_p),
            {"mu": tree_unflatten(params, mu),
             "nu": tree_unflatten(params, nu), "count": count})


def adamw_update(cfg: AdamWConfig, grads: Any, state: Any, params: Any
                 ) -> Tuple[Any, Any]:
    """Returns ``(new_params, new_state)``; nothing is updated in place.
    On the card one kernel launch over all leaves (and all members under
    ``vmap``); CPU tensors run the foreach ops. In a superstep graph
    captured with phase stamps the call is the ``adamw`` phase, inside the
    ``update`` one (``obs.trace.stamp``)."""
    stamp("adamw")
    ps, gs = tree_leaves(params), tree_leaves(grads)
    scale = (_clip_scale(global_norm(gs), cfg.grad_clip_norm)
             if cfg.grad_clip_norm is not None else None)
    lr_t = (cfg.lr * cfg.schedule(state["count"] + 1)
            if cfg.schedule is not None else None)
    # only a vmapped call needs the op (its vmap rule): an unbatched one
    # runs the op's body, which skips the dispatcher's first-call imports
    step = _adamw_op if is_batched((ps, gs, state)) else _adamw_step
    flat = step(ps, gs, tree_leaves(state["mu"]), tree_leaves(state["nu"]),
                state["count"], lr_t, scale, cfg.lr, cfg.b1, cfg.b2,
                cfg.eps, cfg.weight_decay)
    n = len(ps)
    stamp("update")
    return _new_trees(params, flat[:n], flat[n:2 * n], flat[2 * n:3 * n],
                      flat[3 * n])


def _foreach_step(ps, gs, mus, nus, scale, lr, bc1, bc2, b1: float,
                  b2: float, eps: float, wd: float):
    """``(p', mu', nu')`` of every leaf as foreach ops over all leaves."""
    if scale is not None:
        gs = torch._foreach_mul(gs, scale)
    gs = [g.to(torch.float32) for g in gs]
    mul, add, div = torch._foreach_mul, torch._foreach_add, \
        torch._foreach_div
    mu = add(mul(list(mus), b1), mul(gs, 1 - b1))
    nu = add(mul(list(nus), b2),
             mul(mul(gs, gs), 1 - b2))           # square: g * g, as pow 2
    step = div(mul(div(mu, bc1), lr),
               add(torch._foreach_sqrt(div(nu, bc2)), eps))
    p32 = [p.to(torch.float32) for p in ps]
    if wd:
        step = add(step, mul(p32, lr * wd))
    new_p = [t.to(p.dtype) for t, p in
             zip(torch._foreach_sub(p32, step), ps)]
    return new_p, mu, nu


def _leaf_step(g, m, v, p, scale, lr, bc1, bc2, b1: float, b2: float,
               eps: float, wd: float):
    """``(p', mu', nu')`` of one leaf (the terms broadcast against it)."""
    if scale is not None:
        g = (g * scale).to(g.dtype)
    g32 = g.to(torch.float32)
    m = b1 * m + (1 - b1) * g32
    v = b2 * v + (1 - b2) * torch.square(g32)
    step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if wd:
        step = step + lr * wd * p.to(torch.float32)
    return (p.to(torch.float32) - step).to(p.dtype), m, v


def adamw_update_ref(cfg: AdamWConfig, grads: Any, state: Any, params: Any
                     ) -> Tuple[Any, Any]:
    """The plain version of ``adamw_update``: the same update, leaf by
    leaf."""
    scale = None
    if cfg.grad_clip_norm is not None:
        scale = _clip_scale(global_norm(grads), cfg.grad_clip_norm)
    count, lr, bc1, bc2 = _step_terms(cfg, state)
    out = [_leaf_step(g, m, v, p, scale, lr, bc1, bc2, cfg.b1, cfg.b2,
                      cfg.eps, cfg.weight_decay)
           for g, m, v, p in zip(
               tree_leaves(grads), tree_leaves(state["mu"]),
               tree_leaves(state["nu"]), tree_leaves(params))]
    return _new_trees(params, [o[0] for o in out], [o[1] for o in out],
                      [o[2] for o in out], count)


# ------------------------------------------------------------ the kernel

def _library() -> ctypes.CDLL:
    """``csrc/adamw.cu``, built at first use, its entry point declared."""
    from repro_torch.kernels import load_library
    lib = load_library("adamw", [SOURCE])
    if lib.adamw_step.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.adamw_step.argtypes = [p, i, i, p, p, p, p, f, f, f, f, f, f,
                                   f, f, i, i, p]
        lib.adamw_step.restype = ctypes.c_int
    return lib


def _kernel_inputs(ps, gs, mus, nus, count, lr_t, scale):
    """The kernel's operands, or an exception: every leaf and device scalar
    float32 and ``count`` int32, all on ``count``'s device; each leaf's
    leading axes ``count``'s (a member each) and its grad and moments of
    its shape. A leaf that is not contiguous (a view, an unbatched
    argument expanded to every member) comes back as a contiguous copy,
    ``lr_t`` and ``scale`` broadcast to one value a member."""
    dev, lead = count.device, tuple(count.shape)
    if count.dtype != torch.int32:
        raise TypeError(f"adamw_step: count is {count.dtype}, the kernel "
                        f"takes int32")
    for p, *rest in zip(ps, gs, mus, nus):
        if tuple(p.shape[:len(lead)]) != lead or any(
                t.shape != p.shape for t in rest):
            raise ValueError(
                f"adamw_step: a leaf of shape {tuple(p.shape)} (grad and "
                f"moments {[tuple(t.shape) for t in rest]}) against count "
                f"{lead}: the members lead every leaf")
    scalars = [s.expand(lead) for s in (lr_t, scale) if s is not None]
    for t in (*ps, *gs, *mus, *nus, *scalars):
        if t.dtype != torch.float32 or t.device != dev:
            raise TypeError(f"adamw_step: a {t.dtype} operand on {t.device}"
                            f"; the kernel takes float32 on {dev}")
    trees = [[t.contiguous() for t in ts] for ts in (ps, gs, mus, nus)]
    lr_t, scale = [None if s is None else s.expand(lead).contiguous()
                   for s in (lr_t, scale)]
    return (*trees, count.contiguous(), lr_t, scale)


def _launch(ps, gs, mus, nus, count, lr_t, scale, lr: float, b1: float,
            b2: float, eps: float, wd: float) -> List[torch.Tensor]:
    """``[p'..., mu'..., nu'..., count']`` of the launches over every leaf
    (``_kernel_inputs``' operands): leaf ``i`` holds ``count.numel()``
    members of ``numel // count.numel()`` elements each."""
    dev, members = count.device, count.numel()
    if dev.type != "cuda":
        raise RuntimeError(f"adamw_step: the kernel runs on a CUDA card, "
                           f"not {dev}")
    new_p = [torch.empty_like(p) for p in ps]
    mu = [torch.empty_like(m) for m in mus]
    nu = [torch.empty_like(v) for v in nus]
    count_out = torch.empty_like(count)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    table = (ctypes.c_int64 * (8 * len(ps)))()
    for i, ts in enumerate(zip(ps, gs, mus, nus, new_p, mu, nu)):
        table[8 * i:8 * i + 7] = [t.data_ptr() for t in ts]
        table[8 * i + 7] = ps[i].numel() // members
    with torch.cuda.device(dev):
        launches = _library().adamw_step(
            table, len(ps), members, count.data_ptr(), count_out.data_ptr(),
            None if lr_t is None else lr_t.data_ptr(),
            None if scale is None else scale.data_ptr(),
            lr, b1, 1 - b1, b2, 1 - b2, eps,
            lr * wd if lr_t is None else 0.0, wd, int(bool(wd)), sms,
            torch.cuda.current_stream(dev).cuda_stream)
    if launches < 0:
        raise RuntimeError(f"adamw_step launch failed: CUDA error "
                           f"{-launches} ({len(ps)} leaves, {members} "
                           f"members)")
    _count("kernel", launches)
    return [*new_p, *mu, *nu, count_out]


def _plain_step(ps, gs, mus, nus, count, lr_t, scale, lr: float, b1: float,
                b2: float, eps: float, wd: float) -> List[torch.Tensor]:
    """``_adamw_step`` as torch ops: foreach ops over all leaves for a solo
    call, leaf by leaf (``adamw_update_ref``'s) for members."""
    count, bc1, bc2 = _bias_terms(count, b1, b2)
    lr = lr if lr_t is None else lr_t
    if count.dim() == 0:
        new_p, mu, nu = _foreach_step(ps, gs, mus, nus, scale, lr, bc1, bc2,
                                      b1, b2, eps, wd)
        return [*new_p, *mu, *nu, count]

    def per(t, leaf):                 # a member's scalar over its leaf
        return t if not isinstance(t, torch.Tensor) else t.expand(
            count.shape).reshape(count.shape
                                 + (1,) * (leaf.dim() - count.dim()))
    out = [_leaf_step(g, m, v, p, per(scale, p), per(lr, p), per(bc1, p),
                      per(bc2, p), b1, b2, eps, wd)
           for p, g, m, v in zip(ps, gs, mus, nus)]
    return [o[k] for k in range(3) for o in out] + [count]


def _adamw_step(ps: List[torch.Tensor], gs: List[torch.Tensor],
                mus: List[torch.Tensor], nus: List[torch.Tensor],
                count: torch.Tensor, lr_t: Optional[torch.Tensor],
                scale: Optional[torch.Tensor], lr: float, b1: float,
                b2: float, eps: float, wd: float) -> List[torch.Tensor]:
    """``[p'..., mu'..., nu'..., count + 1]`` of one AdamW step (``lr_t`` a
    scheduled lr, else ``lr``; ``scale`` the clip scale, or None).
    ``count`` holds a member's step count each: 0-d for a solo call; the
    vmap rule's call stacks the members on the leading axes of ``count``
    and of every leaf. CPU tensors take torch ops; any other device the
    kernel."""
    if (ps[0] if ps else count).device.type == "cpu":
        _count("fallback")
        return _plain_step(ps, gs, mus, nus, count, lr_t, scale, lr, b1, b2,
                           eps, wd)
    return _launch(*_kernel_inputs(ps, gs, mus, nus, count, lr_t, scale),
                   lr, b1, b2, eps, wd)


_adamw_op = torch.library.custom_op(
    "repro_torch::adamw_step", _adamw_step, mutates_args=())


def _adamw_vmap(info, in_dims, ps, gs, mus, nus, count, lr_t, scale, lr,
                b1, b2, eps, wd):
    """Every argument with its member axis first, through the op again: one
    step of ``info.batch_size`` members (of more under a nested vmap, whose
    own rule moves its axis in front of these)."""
    e = info.batch_size
    ps, gs, mus, nus = [[members_first(t, d, e) for t, d in zip(ts, dims)]
                        for ts, dims in zip((ps, gs, mus, nus), in_dims[:4])]
    count, lr_t, scale = [None if t is None else members_first(t, d, e)
                          for t, d in zip((count, lr_t, scale), in_dims[4:7])]
    out = _adamw_op(ps, gs, mus, nus, count, lr_t, scale, lr, b1, b2, eps,
                    wd)
    return out, [0] * len(out)


torch.library.register_vmap("repro_torch::adamw_step", _adamw_vmap)


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
