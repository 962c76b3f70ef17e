"""Tile and split sweep of the stack backward's products, on the card.

    python -m repro_torch.launch.bwd_sweep

For every product of the critic's and the actor's densenet backward at the
training path's M=256 (dW_i over the batch, dx_i over U), times the
register tile (``dense_tile_rt.cuh``) at both shapes and every split of K
the planner may take, and marks the plan ``stack.plan_bwd`` picks: the
measurements its rules follow. dx is timed as the product alone, on the
operands ``act_grad`` and the W^T transpose make. Times are CUDA events
over back-to-back calls after a warm-up, the median of three runs; the
card must be there (``resolve_device``).
"""
from __future__ import annotations

import argparse
import math
import statistics
from typing import List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels.dense_block import stack

# (name, M, d0, U, L) of the training path's densenet stacks
NETS = (("critic", 256, 516, 2048, 2), ("actor", 256, 259, 2048, 2))


def candidates(m: int, n: int, k: int, num_sms: int,
               dx: bool) -> List[Tuple[int, int, int, int]]:
    """Every ``(config, tiles, splits, chunks_per_split)`` the register tile
    can run an (m, n) x k product with: both shapes, each distinct split
    whose parts keep ``_RT_MIN_CHUNKS_PER_SPLIT`` chunks (dW: at most 4
    splits, as its output is large)."""
    out = []
    for config, (bm, bn, bk) in stack._RT_CONFIGS.items():
        tiles = -(-m // bm) * -(-n // bn)
        chunks = -(-k // bk)
        most = max(1, chunks // stack._RT_MIN_CHUNKS_PER_SPLIT)
        seen = set()
        for want in range(1, (most if dx else min(most, 4)) + 1):
            per = -(-chunks // want)
            splits = -(-chunks // per)
            if splits not in seen:
                seen.add(splits)
                out.append((config, tiles, splits, per))
    return out


def _time_us(fn, reps: int = 20, runs: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(1e3 * start.elapsed_time(end) / reps)
    return statistics.median(samples)


def sweep(seed: int = 0) -> List[dict]:
    """The rows: one per product and candidate plan, with its time."""
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, m, d0, u, n_layers in NETS:
        x = torch.randn((m, d0), generator=gen, device=dev)
        ws, bs = [], []
        for i in range(n_layers):
            k = d0 + i * u
            ws.append(torch.empty((k, u), device=dev).uniform_(
                -1 / math.sqrt(k), 1 / math.sqrt(k), generator=gen))
            bs.append(torch.zeros((u,), device=dev))
        zs = torch.empty((m, n_layers * u), device=dev)
        out = stack._kernel_forward(x, ws, bs, "densenet", "swish", zs)
        g = torch.randn(out.shape, generator=gen, device=dev)
        bw = stack._Backward(m, u, "swish", dev)
        for i in reversed(range(n_layers)):
            k = d0 + i * u
            gz, gzt, _ = bw.act_grad(g, k, zs, i, False, True)
            wt = bw.transpose(ws[i])
            dw = torch.empty((k, u), device=dev)
            gb = torch.zeros((m, stack._pad4(k)), device=dev)[:, :k]
            a_dw = stack.operand(out)
            for dx in (False, True):
                mm, nn, kk = (m, k, u) if dx else (k, u, m)
                pick = stack.plan_bwd(mm, nn, kk, num_sms, dx=dx,
                                      vec=stack.vec_aligned(a_dw))
                for plan in candidates(mm, nn, kk, num_sms, dx):
                    if dx:
                        def run(plan=plan):
                            bw._product(plan, True, stack.operand(gzt),
                                        stack.operand(wt), gb, 0, 0, mm, nn,
                                        kk, True)
                    else:
                        def run(plan=plan):
                            bw._product(plan, False, a_dw,
                                        stack.operand(gz), dw, 0, 0, mm, nn,
                                        kk, False)
                    rows.append(dict(net=name, layer=i,
                                     product="dx" if dx else "dW",
                                     shape=(mm, nn, kk), plan=plan,
                                     picked=plan == pick, us=_time_us(run)))
    return rows


def main() -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    rows = sweep()
    print(f"# {torch.cuda.get_device_name(0)}; config 3 = 128x128, "
          f"4 = 128x64; * = plan_bwd's pick")
    key = None
    for r in rows:
        if (r["net"], r["layer"], r["product"]) != key:
            key = (r["net"], r["layer"], r["product"])
            print(f"{r['net']} layer {r['layer']} {r['product']} "
                  f"(m, n, k) = {r['shape']}:")
        config, _, splits, _ = r["plan"]
        print(f"  config {config} splits {splits:2d}: {r['us']:8.1f} us"
              f"{'  *' if r['picked'] else ''}")


if __name__ == "__main__":
    main()
