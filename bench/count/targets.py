"""The target networks' EMA, counted from a configuration file's shapes
alone: the elements every target network of one member-update holds (both
target critics, and OFENet's target where the configuration has OFENet),
and the least bytes of averaging them."""
from __future__ import annotations

from bench.count import F32, nets

# the target and its online net read, the target written: float32 each
EMA_WORDS = 3


def elements(config: dict) -> int:
    """Elements of one member's target networks."""
    n = nets(config)
    total = 2 * n["critic"].params()
    for k in ("phi_s", "phi_sa", "pred"):
        if k in n:
            total += n[k].params()
    return total


def ema_bytes(config: dict, members: int = 1) -> int:
    """Least traffic of one superstep's EMA of ``members`` members."""
    return EMA_WORDS * F32 * elements(config) * members
