"""Wrappers around the fused dense kernel (port of
``repro/kernels/dense_block/ops.py``).

``dense_concat_matmul`` is the DenseNet entry point: the concat of the
stream segments never exists, and where the reference makes one kernel
call per part and sums the parts' products (each rounded to the input
dtype) outside, the port makes ONE launch that sums every part in its fp32
accumulator and rounds once, as ``ref.dense_concat_matmul_ref`` does (in
bfloat16 the two differ within the bf16 tolerance; ROADMAP C5). The CUDA
kernel masks ragged edges, so ``fused_dense_padded`` pads nothing and keeps
the reference's name only; ``bm/bn/bk`` and ``interpret`` are gone (see
``dense_block``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.dense_block.dense_block import (fused_dense,
                                                         segmented_dense)


def fused_dense_padded(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None, *,
                       activation: str = "swish") -> torch.Tensor:
    """``fused_dense`` for any (M, K, N): the kernel masks the edges."""
    return fused_dense(x, w, b, activation=activation)


def dense_concat_matmul(parts: Sequence[torch.Tensor], w: torch.Tensor,
                        b: Optional[torch.Tensor] = None, *,
                        activation: str = "swish") -> torch.Tensor:
    """``act(concat(parts, -1) @ w + b)`` in one launch, without the
    concat; any activation of ``common.get_activation``."""
    return segmented_dense(parts, w, b, activation=activation)
