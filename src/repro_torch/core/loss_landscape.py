"""Loss-landscape slices (Li et al. 2018 filter normalization), paper A.3
(port of ``repro/core/loss_landscape.py``).

The 2-D surface of a loss L(theta + a*d1 + b*d2), where d1 and d2 are
Gaussian directions *filter-normalized* per parameter tensor: each
direction tensor is rescaled so that its norm matches the parameter
tensor's (per output filter for matrices, per tensor otherwise).

The paper takes it of J_Q (eq. 2-3) with frozen target values, to show
that wide Q-networks sit in near-convex basins and deep ones in sharp,
chaotic ones.

``random_direction`` takes its Gaussian draws as an argument, keyed by
leaf path (``leaf_paths``), so a test can feed it the reference's; given
none, it draws them from an explicit ``torch.Generator`` on the params'
device, leaf by leaf in ``tree_leaves`` order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import tree_leaves, tree_map, tree_unflatten


def leaf_paths(tree: Any, prefix: str = "") -> List[str]:
    """The "/"-joined key path of every leaf, in ``tree_leaves`` order
    (dicts by sorted key, lists by index): ``"q1/layers/0/dense/w"``."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _filter_normalize(direction: Any, params: Any) -> Any:
    def norm_one(d: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        d, p = d.float(), p.float()
        if p.ndim >= 2:
            # per output filter (the last axis)
            axes = tuple(range(p.ndim - 1))
            dn = torch.sqrt(torch.sum(d * d, dim=axes, keepdim=True)) + 1e-10
            pn = torch.sqrt(torch.sum(p * p, dim=axes, keepdim=True))
            return d / dn * pn
        dn = torch.linalg.vector_norm(d) + 1e-10
        return d / dn * torch.linalg.vector_norm(p)
    return tree_map(norm_one, direction, params)


def random_direction(params: Any,
                     draws: Optional[Dict[str, Any]] = None,
                     generator: Optional[torch.Generator] = None) -> Any:
    """A filter-normalized Gaussian direction shaped like ``params``.

    ``draws`` maps each leaf path to its standard-normal draw (any array
    of the leaf's shape); without it the draws come from ``generator``."""
    leaves, paths = tree_leaves(params), leaf_paths(params)
    if draws is not None:
        d = [torch.tensor(np.asarray(draws[p]), dtype=torch.float32,
                          device=l.device) for p, l in zip(paths, leaves)]
    elif generator is not None:
        d = [torch.randn(l.shape, generator=generator, dtype=torch.float32,
                         device=l.device) for l in leaves]
    else:
        raise ValueError("random_direction needs draws or a generator")
    for p, x, l in zip(paths, d, leaves):
        if x.shape != l.shape:
            raise ValueError(f"draw for {p} has shape {tuple(x.shape)}, the "
                             f"leaf {tuple(l.shape)}")
    return _filter_normalize(tree_unflatten(params, d), params)


def loss_surface(loss_fn: Callable[[Any], torch.Tensor], params: Any,
                 d1: Any, d2: Any, *, span: float = 1.0,
                 resolution: int = 11
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Evaluate ``loss_fn`` on a (resolution x resolution) grid of the
    slice through ``params`` along ``d1`` and ``d2``.

    Returns ``(alphas, betas, surface)`` as numpy arrays; ``surface[i, j]``
    is the loss at ``alphas[i]``, ``betas[j]``. Runs without autograd on
    the params' device; each point is read to the host once."""
    alphas = np.linspace(-span, span, resolution)
    betas = np.linspace(-span, span, resolution)
    surf = np.zeros((resolution, resolution))
    with torch.no_grad():
        for i, a in enumerate(alphas):
            for j, b in enumerate(betas):
                a32, b32 = float(np.float32(a)), float(np.float32(b))
                shifted = tree_map(lambda p, x, y: p + a32 * x + b32 * y,
                                   params, d1, d2)
                surf[i, j] = float(loss_fn(shifted))
    return alphas, betas, surf


def sharpness(surface: np.ndarray) -> float:
    """Mean absolute discrete Laplacian of the log-loss: higher is a
    sharper, less convex basin (the paper compares plots by eye)."""
    s = np.log(np.maximum(surface, 1e-12))
    lap = (s[2:, 1:-1] + s[:-2, 1:-1] + s[1:-1, 2:] + s[1:-1, :-2]
           - 4 * s[1:-1, 1:-1])
    return float(np.mean(np.abs(lap)))
