"""Plain PyTorch fused dense layer and DenseNet concat-matmul (port of
``repro/kernels/dense_block/ref.py``): the path for CPU tensors, and the
reference ``csrc/fused_dense.cu`` is held against on the card.

Both take the product in float32 and cast the result once, to the dtype of
``x`` (of the first part).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.common import get_activation


def fused_dense_ref(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None,
                    activation: str = "swish") -> torch.Tensor:
    """``act(x @ w + b)`` in float32, returned in ``x``'s dtype."""
    y = x.float() @ w.float()
    if b is not None:
        y = y + b.float()
    return get_activation(activation)(y).to(x.dtype)


def dense_concat_matmul_ref(parts: Sequence[torch.Tensor], w: torch.Tensor,
                            b: Optional[torch.Tensor] = None,
                            activation: str = "swish") -> torch.Tensor:
    """The paper's DenseNet layer: ``act(concat(parts) @ w + b)``."""
    return fused_dense_ref(torch.cat(list(parts), dim=-1), w, b, activation)
