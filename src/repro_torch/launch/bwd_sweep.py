"""Tile and split sweep of the dense stack's products and of the fused
dense layer, on the card.

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
them. Then the whole-stack kernel at the OFENet stacks (``phi_s``,
``phi_sa``) at 1, 8, 32 and 256 rows, every row tile, beside the per-layer
kernels those stacks took before it (streaming up to 32 rows,
``dense_tile.cuh`` past them); and the fused dense kernel
(``fused_dense.cu``, 3xTF32) at the paper's Ant DenseNet layer 3 and the
``kernels_micro`` row, every tile config and split, beside
``silu(addmm)``; and the card's TF32 ``mma.sync`` rate
(``csrc/mma_peak.cu``), the ceiling of fused dense's 3xTF32. Times are CUDA events over back-to-back calls after a warm-up,
enqueued while the card is held busy (so the wrappers' host work is not in
them), the median of three runs; the card must be there
(``resolve_device``).
"""
from __future__ import annotations

import argparse
import math
import statistics
import time
from pathlib import Path
from typing import List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels.dense_block import dense_block, stack

# (name, M, d0, U, L) of the training path's densenet stacks
NETS = (("critic", 256, 516, 2048, 2), ("actor", 256, 259, 2048, 2))
# the serving slots the weight-streaming kernel is swept at
STREAM_SLOTS = (1, 8, 32)
# (name, d0, U, L) of the OFENet stacks, and the rows the whole-stack
# kernel is swept at: the serving slots and the training batch
OFENET = (("phi_s", 3, 64, 4), ("phi_sa", 260, 64, 4))
WHOLE_M = (1, 8, 32, 256)
# (name, M, parts, N) of the fused dense rows: the paper's Ant DenseNet
# layer 3 and the kernels_micro row
DENSE = (("ant_layer3", 256, (111, 2048, 2048), 2048),
         ("micro", 64, (111, 2048), 256))


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


def dense_candidates(m: int, n: int, chunks: int, num_sms: int
                     ) -> List[Tuple[int, int, int, int]]:
    """Every ``(config, tiles, splits, chunks_per_split)`` of the fused
    dense kernel for an (m, n) output over ``chunks`` BK-chunks: each tile
    config, each distinct split whose parts keep ``_MIN_CHUNKS_PER_SPLIT``
    chunks, up to four blocks per SM."""
    out = []
    for config, (bm, bn) in enumerate(dense_block.TILES):
        tiles = -(-m // bm) * -(-n // bn)
        most = max(1, min(chunks // dense_block._MIN_CHUNKS_PER_SPLIT,
                          4 * num_sms // tiles))
        seen = set()
        for want in range(1, most + 1):
            per = -(-chunks // want)
            splits = -(-chunks // per)
            if splits not in seen:
                seen.add(splits)
                out.append((config, tiles, splits, per))
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


def whole_rows(seed: int = 0) -> List[dict]:
    """The whole-stack kernel at every row tile and the per-layer kernels
    (``whole=False``) for each OFENet stack and row count of ``WHOLE_M``;
    weights cycled through 64 copies (they stay in L2, as in training)."""
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = stack._library()
    stream_h = torch.cuda.current_stream(dev).cuda_stream
    act = stack._ACT_CODE["swish"]
    rows = []
    for name, d0, u, n_layers in OFENET:
        ws = [torch.empty((d0 + i * u, u), device=dev).uniform_(
            -1 / math.sqrt(d0 + i * u), 1 / math.sqrt(d0 + i * u),
            generator=gen) for i in range(n_layers)]
        bs = [torch.zeros((u,), device=dev) for _ in range(n_layers)]
        copies = [([w.clone() for w in ws], [b.clone() for b in bs])
                  for _ in range(64)]
        for m in WHOLE_M:
            x = torch.randn((m, d0), generator=gen, device=dev)
            out = torch.empty((m, d0 + n_layers * u), device=dev)
            pick = stack.plan_fwd(m, u, d0, num_sms, stack=(d0, n_layers))
            per_layer = stack.fwd_kernel_of(
                stack.plan_fwd(m, u, d0, num_sms)[0])
            rows.append(dict(net=name, layer="all", product=f"M={m}",
                             shape=(m, d0, u, n_layers),
                             plan=f"per-layer {per_layer}", picked=False,
                             us=_time_us(lambda i: stack._kernel_forward(
                                 x, *copies[i], "densenet", "swish",
                                 whole=False), copies=len(copies))))
            for r in stack._WHOLE_ROW_TILES:
                def run(i, r=r):
                    stack._launch_whole(lib, x, *copies[i], out, None, act,
                                        r, stream_h)
                rows.append(dict(net=name, layer="all", product=f"M={m}",
                                 shape=(m, d0, u, n_layers),
                                 plan=f"whole, {r} rows a block",
                                 picked=pick[0] == stack._WHOLE_CONFIG
                                 and pick[3] == r,
                                 us=_time_us(run, copies=len(copies))))
    return rows


def dense_rows(seed: int = 0) -> List[dict]:
    """The fused dense kernel at each ``DENSE`` shape, every candidate of
    ``dense_candidates``, and ``silu(addmm)`` on the built concat; W cycled
    through copies larger than the L2."""
    import torch.nn.functional as F
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, m, widths, n in DENSE:
        k = sum(widths)
        parts = [torch.randn((m, w), generator=gen, device=dev)
                 for w in widths]
        w0 = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        b0 = torch.zeros((n,), device=dev)
        copies = [(w0.clone(), b0.clone()) for _ in range(
            max(2, math.ceil(120e6 / (4 * k * n))))]
        xcat = torch.cat(parts, 1)
        chunks = len(dense_block.chunks_of(widths))
        pick = dense_block.plan(m, n, chunks, num_sms)
        rows.append(dict(net=name, layer="-", product="silu(addmm)",
                         shape=(m, n, k), plan="library", picked=False,
                         us=_time_us(lambda i: F.silu(torch.addmm(
                             copies[i][1], xcat, copies[i][0])),
                             copies=len(copies))))
        for plan in dense_candidates(m, n, chunks, num_sms):
            def run(i, plan=plan):
                dense_block._launch(parts, copies[i][0], copies[i][1],
                                    "swish", plan)
            rows.append(dict(net=name, layer="-", product="fused dense",
                             shape=(m, n, k), plan=plan,
                             picked=plan == pick,
                             us=_time_us(run, copies=len(copies))))
    return rows


MMA_PEAK_SOURCE = Path(__file__).resolve().parent / "csrc" / "mma_peak.cu"


def mma_peak_rows(iters: int = 4096) -> List[dict]:
    """The TF32 ``mma.sync`` rate of the card (``csrc/mma_peak.cu``: 16
    independent MMAs a warp, register operands), at 4, 8 and 16 warps a
    block and four blocks an SM: the ceiling of fused dense's 3xTF32, three
    such MMAs for each fp32 one."""
    import ctypes

    from repro_torch.kernels import load_library
    dev = resolve_device(None)
    lib = load_library("mma_peak", [MMA_PEAK_SOURCE])
    fn = lib.tf32_mma_peak
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for warps in (4, 8, 16):
        out = torch.empty((blocks * warps * 32,), device=dev)

        def run(_, warps=warps, out=out):
            err = fn(out.data_ptr(), blocks, warps, iters, stream)
            if err != 0:
                raise RuntimeError(f"tf32_mma_peak: CUDA error {err}")
        us = _time_us(run, reps=3)
        flops = 2048.0 * 16 * iters * blocks * warps
        rows.append(dict(net="mma.sync", layer="-", product="tf32 m16n8k8",
                         shape=f"{blocks} blocks, {16 * iters} MMAs a warp",
                         plan=f"{warps} warps a block, "
                              f"{flops / us / 1e6:.1f} TFLOP/s",
                         picked=False, us=us))
    return rows


def main() -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    rows = sweep() + whole_rows() + dense_rows() + mma_peak_rows()
    print(f"# {torch.cuda.get_device_name(0)}; config 3 = 128x128 (the "
          f"backward only), 4 = 128x64, 5 = the weight-streaming kernel (its "
          f"last number counts rows); fused dense configs by (BM, BN): "
          f"{dict(enumerate(dense_block.TILES))}; * = plan_bwd's, "
          f"plan_fwd's or dense_block.plan's pick")
    key = None
    for r in rows:
        if (r["net"], r["layer"], r["product"]) != key:
            key = (r["net"], r["layer"], r["product"])
            print(f"{r['net']} layer {r['layer']} {r['product']} "
                  f"shape {r['shape']}:")
        if isinstance(r["plan"], str):
            what = r["plan"]
        else:
            config, _, splits, per = r["plan"]
            what = f"config {config} splits {splits:2d} ({per:3d})"
        print(f"  {what}: {r['us']:8.1f} us{'  *' if r['picked'] else ''}")


if __name__ == "__main__":
    main()
