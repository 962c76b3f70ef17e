"""Shared utilities: parameter init, activation registry, tree helpers
(port of ``repro/common.py``).

Every module is an (init, apply) pair over plain nested dicts of tensors.
``Dense`` params are ``{"w": (in, out), "b": (out,)}`` — the reference's
layout, so no transpose crosses the packages. Randomness comes from an
explicit ``torch.Generator`` on the tensors' device.
"""
from __future__ import annotations

import math
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.nn.functional as F

from repro_torch.obs.trace import stamp

Params = Dict[str, Any]


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "swish": swish,
    "silu": swish,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return ACTIVATIONS[name]
    except KeyError as e:
        raise ValueError(f"unknown activation {name!r}; have "
                         f"{sorted(ACTIVATIONS)}") from e


def uniform_fan_in(generator: torch.Generator, fan_in: int,
                   shape: Sequence[int], device: torch.device,
                   dtype=torch.float32) -> torch.Tensor:
    """Torch-style U(-1/sqrt(fan_in), 1/sqrt(fan_in)) used by the paper's
    codebase."""
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.empty(tuple(shape), device=device, dtype=dtype).uniform_(
        -bound, bound, generator=generator)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               device: torch.device, *, dtype=torch.float32) -> Params:
    """``w`` ~ ``uniform_fan_in`` stored ``(in, out)``; ``b`` zero."""
    return {"w": uniform_fan_in(generator, in_dim, (in_dim, out_dim), device,
                                dtype),
            "b": torch.zeros((out_dim,), device=device, dtype=dtype)}


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of nested dicts/lists/tuples (and
    to the matching leaves of ``rest``, trees of the same structure). Dicts
    are walked in sorted key order, so two trees with the same keys give
    their leaves in the same order whatever order they were built in."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in ``tree_map``'s traversal order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree: Any, leaves: Sequence[Any]) -> Any:
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_size(tree: Any) -> int:
    """Total number of parameters in a tree."""
    return sum(t.numel() for t in tree_leaves(tree))


def tree_l2_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm over every leaf (grad/update diagnostics)."""
    return torch.sqrt(sum(torch.sum(torch.square(t))
                          for t in tree_leaves(tree)))


def tree_update_ratio(new: Any, old: Any, eps: float = 1e-12
                      ) -> torch.Tensor:
    """||new - old|| / ||old||: the per-step relative parameter movement."""
    delta = tree_map(lambda a, b: a - b, new, old)
    return tree_l2_norm(delta) / (tree_l2_norm(old) + eps)


def ema_update(target: Any, online: Any,
               tau: Union[float, torch.Tensor]) -> Any:
    """Polyak averaging: target <- tau*online + (1-tau)*target (paper A.1).
    ``tau`` may be a 0-d tensor on the device (TD3's delayed target: 0 on
    the steps that skip it), with the same arithmetic. In a superstep
    graph captured with phase stamps the call is the ``target`` phase,
    inside the ``update`` one (``obs.trace.stamp``)."""
    stamp("target")
    out = tree_map(lambda t, o: (1.0 - tau) * t + tau * o, target, online)
    stamp("update")
    return out


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber loss on residuals (paper A.1, Q-regression)."""
    a = torch.abs(x)
    return torch.where(a <= delta, 0.5 * x * x, delta * (a - 0.5 * delta))


def value_and_grad(fn: Callable[[Any], Any], tree: Any, *,
                   has_aux: bool = False) -> Tuple[Any, Any]:
    """``jax.value_and_grad`` over one tree of tensors.

    ``fn`` gets detached copies of ``tree``'s leaves that require grad, so
    autograd differentiates with respect to them only; every other tensor
    ``fn`` touches stays constant (and a fused stack whose weights are such
    constants skips their dW). Returns ``(value, grads)`` or, with
    ``has_aux``, ``((value, aux), grads)``; value and aux come back
    detached, and a leaf ``fn`` never used gets a zero gradient.

    Under ``torch.func.vmap`` (a fleet's member-batched superstep, where
    ``torch.autograd.grad`` cannot run) the same contract goes through
    ``torch.func.grad_and_value`` (``value_and_grad_func``)."""
    if is_batched(tree):
        return value_and_grad_func(fn, tree, has_aux=has_aux)
    var = tree_map(lambda t: t.detach().requires_grad_(True), tree)
    with torch.enable_grad():
        out = fn(var)
        loss, aux = out if has_aux else (out, None)
        leaves = tree_leaves(var)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for g, v in zip(grads, leaves)]
    value = loss.detach()
    if has_aux:
        value = (value, tree_map(lambda t: t.detach(), aux))
    return value, tree_unflatten(tree, grads)


def is_batched(tree: Any) -> bool:
    """Whether any leaf of ``tree`` is a ``torch.func.vmap``-batched
    tensor (the body of a fleet's member-batched superstep)."""
    return any(torch._C._functorch.is_batchedtensor(t)
               for t in tree_leaves(tree))


def members_first(t: torch.Tensor, dim: Optional[int], e: int
                  ) -> torch.Tensor:
    """A ``torch.library`` vmap rule's argument with its member axis first:
    an unbatched one (``dim`` None) expanded to ``e`` members of stride 0
    (never copied ``e`` times)."""
    if dim is None:
        return t.expand((e, *t.shape))
    return t.movedim(dim, 0)


def value_and_grad_func(fn: Callable[[Any], Any], tree: Any, *,
                        has_aux: bool = False) -> Tuple[Any, Any]:
    """``value_and_grad``'s contract through ``torch.func.grad_and_value``
    (the route ``vmap`` accepts): unused leaves get zeros, and every
    tensor ``fn`` closes over stays constant."""
    def flat(leaves):
        return fn(tree_unflatten(tree, leaves))
    grads, out = torch.func.grad_and_value(flat, has_aux=has_aux)(
        tree_leaves(tree))
    if has_aux:
        value = (out[0].detach(), tree_map(lambda t: t.detach(), out[1]))
    else:
        value = out.detach()
    return value, tree_unflatten(tree, grads)
