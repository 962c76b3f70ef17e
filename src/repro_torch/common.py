"""Shared utilities: parameter init, activation registry (port of
``repro/common.py``).

Every module is an (init, apply) pair over plain nested dicts of tensors.
``Dense`` params are ``{"w": (in, out), "b": (out,)}`` — the reference's
layout, so no transpose crosses the packages. Randomness comes from an
explicit ``torch.Generator`` on the tensors' device.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence

import torch
import torch.nn.functional as F

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


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of nested dicts/lists/tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
