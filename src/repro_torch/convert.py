"""Weights across the packages: the reference's params as nested numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``) <-> the port's
nested tensors. Both keep dense ``w`` as ``(in, out)``, so nothing is
transposed."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.common import tree_map


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dicts/lists of arrays -> the same nesting of tensors."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def params_to_numpy(tree: Any) -> Any:
    """Nested tensors -> the same nesting of numpy arrays (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
