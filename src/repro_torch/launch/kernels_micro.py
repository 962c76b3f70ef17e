"""Kernel micro-benchmark of the port (the counterpart of
``benchmarks/kernels_micro.py``): the fused dense, flash attention and SSD
kernels at the reference rows' shapes, each against its plain version.

    python -m repro_torch.launch.kernels_micro              # on the card
    python -m repro_torch.launch.kernels_micro --device cpu

``run(device=None)`` returns one row per kernel, named as the reference's
rows, with ``us_per_call`` (on the card: CUDA events over ``reps`` calls
after a warm-up; on the CPU, where the plain versions run, the host clock),
``derived`` = ``maxerr`` of the port's function against its plain version
on the same inputs, ``ref_us`` (the plain version's time), and ``launches``
and ``calls``: on the card each call launches its kernel exactly once, so
the two are equal. Inputs come from a seeded ``torch.Generator`` on the
device.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device
from repro_torch.kernels.dense_block import dense_block, ops as dense_ops
from repro_torch.kernels.dense_block import ref as dense_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan import ssd_scan


def _time_us(fn: Callable[[], torch.Tensor], device: torch.device,
             reps: int) -> float:
    """Microseconds per call after one warm-up call."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return 1e3 * start.elapsed_time(end) / reps


def _row(name: str, kernel: Callable[[], torch.Tensor],
         plain: Callable[[], torch.Tensor], launches: Callable[[], int],
         device: torch.device, reps: int) -> Dict:
    before = launches()
    us = _time_us(kernel, device, reps)
    err = float((kernel().float() - plain().float()).abs().max())
    calls = reps + 2
    return {"name": name, "us_per_call": us, "derived": f"maxerr={err:.2e}",
            "maxerr": err, "ref_us": _time_us(plain, device, reps),
            "launches": launches() - before, "calls": calls}


def run(device: DeviceLike = None, *, reps: int = 20,
        seed: int = 0) -> List[Dict]:
    """The three rows (see the module docstring), on the card unless
    ``device`` asks for the CPU."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    rows = []

    # the paper's DenseNet layer (Table 2): stream 2159 -> 256 units
    parts = [randn(64, 111), randn(64, 2048)]
    w = randn(2159, 256) * 0.02
    rows.append(_row(
        "kernel_dense_concat_2159x256",
        lambda: dense_ops.dense_concat_matmul(parts, w),
        lambda: dense_ref.dense_concat_matmul_ref(parts, w),
        dense_block.launch_count, dev, reps))

    q, k, v = randn(1, 256, 8, 32), randn(1, 256, 4, 32), randn(1, 256, 4, 32)
    rows.append(_row(
        "kernel_flash_attn_256_gqa",
        lambda: flash_ops.gqa_flash(q, k, v),
        lambda: flash_ref.plain_attention(q, k, v),
        flash_attention.launch_count, dev, reps))

    bsz, s, h, p, n = 2, 64, 4, 16, 8
    x, b, c = randn(bsz, s, h, p), randn(bsz, s, n), randn(bsz, s, n)
    dt = F.softplus(randn(bsz, s, h))
    log_a = torch.linspace(0.0, 1.0, h, device=dev)
    d_skip = torch.ones((h,), device=dev)

    def ssd_plain():
        y, _ = ssd_ref.ssd_chunked(x, b, c, dt, log_a, chunk=16)
        return y + d_skip[None, None, :, None] * x
    rows.append(_row(
        "kernel_ssd_chunk_64",
        lambda: ssd_ops.ssd_chunked_kernel(x, b, c, dt, log_a, d_skip,
                                           chunk=16)[0],
        ssd_plain, ssd_scan.launch_count, dev, reps))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for r in rows:
        r["device"] = name
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default when a card is present) or cpu")
    args = ap.parse_args(argv)
    for r in run(args.device):
        print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']},"
              f"ref_us={r['ref_us']:.1f},launches={r['launches']}/"
              f"{r['calls']} calls,{r['device']}")


if __name__ == "__main__":
    main()
