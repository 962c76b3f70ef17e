"""Tile and split sweep of the dense stack's products, on the card.

    python -m repro_torch.launch.bwd_sweep

For every product of the critic's and the actor's densenet stack at the
training path's M=256 (backward: dW_i over the batch, dx_i over U;
forward: z_i = stream @ W_i over d0 + i*U), times the register tile
(``dense_tile_rt.cuh``) at both shapes and every split of K the planner
may take, and marks the plan ``stack.plan_bwd`` / ``stack.plan_fwd``
picks: the measurements their rules follow. dx is timed as the product
alone, on the operands ``act_grad`` and the W^T transpose make; the
forward as one layer's launch with its epilogue, on stream^T. Then the
weight-streaming kernel of the forward at the serving slots 1, 8 and 32
for each of the actor's layers, at every split of K it can take, its
weights cycled through copies larger than the L2 as a serving tick finds
them. Times are CUDA events over back-to-back calls after a warm-up,
enqueued while the card is held busy (so the wrappers' host work is not in
them), the median of three runs; the card must be there
(``resolve_device``).
"""
from __future__ import annotations

import argparse
import math
import statistics
import time
from typing import List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels.dense_block import stack

# (name, M, d0, U, L) of the training path's densenet stacks
NETS = (("critic", 256, 516, 2048, 2), ("actor", 256, 259, 2048, 2))
# the serving slots the weight-streaming kernel is swept at
STREAM_SLOTS = (1, 8, 32)


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


def stream_candidates(m: int, n: int, k: int
                      ) -> List[Tuple[int, int, int, int]]:
    """Every plan of the weight-streaming kernel for an (m, n) x k layer:
    each distinct split from the fewest a block's A rows allow to parts of
    ``_STREAM_MIN_K`` rows, as ``(config, strips, splits, rows)``."""
    strips = -(-n // stack._STREAM_COLS)
    out, seen = [], set()
    for want in range(-(-k // stack._STREAM_MAX_K),
                      max(1, k // stack._STREAM_MIN_K) + 1):
        rows = -(-k // want)
        splits = -(-k // rows)
        if splits not in seen:
            seen.add(splits)
            out.append((stack._STREAM_CONFIG, strips, splits, rows))
    return out


def _time_us(fn, reps: int = 20, runs: int = 3, copies: int = 1) -> float:
    """Median over ``runs`` of the CUDA-event time of ``reps`` calls of
    ``fn(i)``, ``i`` cycling over ``range(copies)``, enqueued while the
    card is held busy, so the wrapper's host work is not in it."""
    for i in range(copies):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(reps):
        fn(r % copies)
    torch.cuda.synchronize()
    # hold the card ~3x the enqueue time (cycles at ~2 GHz, >= 2 ms)
    hold = int(2e9 * max(2e-3, 3 * (time.perf_counter() - t0)))
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold)
        start.record()
        for r in range(reps):
            fn(r % copies)
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
                                     picked=plan == pick,
                                     us=_time_us(lambda _: run())))
        rows += _forward_rows(name, out, ws, bs, d0, u, num_sms, gen)
    return rows


def _forward_rows(name: str, out: torch.Tensor, ws, bs, d0: int, u: int,
                  num_sms: int, gen: torch.Generator) -> List[dict]:
    """The forward's layers of one stack: the register tile at M=256 on
    stream^T (made from the forward's own output), every split of its
    128x64 tiles (the forward has no 128x128 case: its best split lost to
    128x64's by 8-12 us at each of these four products, PERF.md); then the
    streaming kernel at the serving slots, every split."""
    lib = stack._library()
    dev = out.device
    m = out.shape[0]
    stream_h = torch.cuda.current_stream(dev).cuda_stream
    act = stack._ACT_CODE["swish"]
    rows = []
    st = torch.empty((out.shape[1], stack._pad4(m)), device=dev)
    st[:, :m].copy_(out.t())
    y = torch.empty((m, u), device=dev)
    for i, (w, b) in enumerate(zip(ws, bs)):
        k = d0 + i * u
        pick = stack.plan_fwd(m, u, k, num_sms)
        for plan in candidates(m, u, k, num_sms, True):
            if plan[0] != stack._RT_FWD_CONFIG:   # the forward's tile only
                continue

            def run(_, plan=plan):
                stack._launch_layer(lib, plan, (out, 0), None, w, b, y, 0,
                                    act, stream_h, at=st)
            rows.append(dict(net=name, layer=i, product="fwd",
                             shape=(m, u, k), plan=plan, picked=plan == pick,
                             us=_time_us(run)))
    if name != "actor":                 # only the actor is served
        return rows
    # serving: the weights cold, as each tick finds them past the L2
    copies = [[w.clone() for w in ws] for _ in range(
        max(2, math.ceil(120e6 / (4 * sum(w.numel() for w in ws)))))]
    for ms in STREAM_SLOTS:
        x = torch.randn((ms, out.shape[1]), generator=gen, device=dev)
        y = torch.empty((ms, u), device=dev)
        for i, b in enumerate(bs):
            k = d0 + i * u
            pick = stack.plan_fwd(ms, u, k, num_sms)
            for plan in stream_candidates(ms, u, k):
                def run(c, plan=plan, i=i, b=b):
                    stack._launch_layer(lib, plan, (x, 0), None,
                                        copies[c][i], b, y, 0, act,
                                        stream_h)
                rows.append(dict(net=name, layer=i,
                                 product=f"fwd-stream M={ms}",
                                 shape=(ms, u, k), plan=plan,
                                 picked=plan == pick,
                                 us=_time_us(run, copies=len(copies))))
    return rows


def main() -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    rows = sweep()
    print(f"# {torch.cuda.get_device_name(0)}; config 3 = 128x128 (the "
          f"backward only), 4 = 128x64, 5 = the weight-streaming kernel (its "
          f"last number counts rows); * = plan_bwd's or plan_fwd's pick")
    key = None
    for r in rows:
        if (r["net"], r["layer"], r["product"]) != key:
            key = (r["net"], r["layer"], r["product"])
            print(f"{r['net']} layer {r['layer']} {r['product']} "
                  f"(m, n, k) = {r['shape']}:")
        config, _, splits, per = r["plan"]
        print(f"  config {config} splits {splits:2d} ({per:3d}): "
              f"{r['us']:8.1f} us{'  *' if r['picked'] else ''}")


if __name__ == "__main__":
    main()
