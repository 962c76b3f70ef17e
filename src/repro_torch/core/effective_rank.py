"""Effective rank srank_delta (Kumar et al. 2021), the paper's §4 metric
(port of ``repro/core/effective_rank.py``).

  srank_delta(Phi) = min{k : sum_{i<=k} sigma_i / sum_i sigma_i >= 1 - delta}

Phi is the feature matrix of the penultimate layer of a Q-network evaluated
on a batch of transitions. The singular values come from
``torch.linalg.svdvals`` in float32; the result stays a tensor on the
features' device, so a training chunk's epilogue reads it off the card
once, with everything else it reports. ``effective_rank_members`` takes a
fleet's member-stacked ``(E, batch, dim)`` features.
"""
from __future__ import annotations

import torch


def effective_rank(features: torch.Tensor,
                   delta: float = 0.01) -> torch.Tensor:
    """srank of a (batch, dim) feature matrix (other ranks are reshaped to
    (-1, dim)). Returns an int32 0-d tensor."""
    if features.ndim != 2:
        features = features.reshape(-1, features.shape[-1])
    sigma = torch.linalg.svdvals(features.to(torch.float32))
    cum = torch.cumsum(sigma, 0) / torch.clamp(torch.sum(sigma), min=1e-12)
    # first index where the cumulative mass reaches 1 - delta (1-based)
    return (torch.argmax((cum >= 1.0 - delta).to(torch.int32))
            + 1).to(torch.int32)


def effective_rank_members(features: torch.Tensor,
                           delta: float = 0.01) -> torch.Tensor:
    """``effective_rank`` of each member's ``(batch, dim)`` features of an
    ``(E, batch, dim)`` stack (``torch.func.vmap``): ``(E,)`` int32."""
    return torch.func.vmap(lambda f: effective_rank(f, delta))(features)


def srank_curve(features: torch.Tensor, deltas=(0.1, 0.05, 0.01)) -> dict:
    return {d: int(effective_rank(features, d)) for d in deltas}
