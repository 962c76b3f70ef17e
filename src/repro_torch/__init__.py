"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

The JAX package (``src/repro/``) is the reference; this package mirrors its
module layout and parameter trees (nested dicts of tensors, dense ``w``
stored ``(in, out)``) so weights and checkpoints cross between the two.
It imports neither ``jax`` nor ``repro``.

What is ported so far: serving (``rl.policy.Policy`` over SAC or TD3
behind the continuous-batching ``launch.serve_policy.PolicyServer``), SAC
and TD3 training on the device replay with bitwise checkpoint and resume
(``rl.experiment.Experiment``), and the kernel micro-benchmark
``launch.kernels_micro``. Every Pallas kernel of
the reference is a hand-written CUDA kernel here (``kernels/``: the
DenseNet stack forward and backward, the sum-tree sample and write, the
fused dense layer, flash attention, the SSD chunk); each one's plain
PyTorch version runs only for tensors on the CPU.

Device rule: entry points take ``device=None`` and then run on the card.
With no card they raise; they never pick the CPU on their own. Tests pass
``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA card. Raises when no device is asked for and no card is
    present — the CPU is used only when the caller asks for it."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but no CUDA card "
                               f"is available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card available and no device asked for: pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
