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
(``csrc/mma_peak.cu``), the ceiling of fused dense's 3xTF32. Then the
sum-tree kernels (``replay_tree.cu``, built once for each candidate
launch shape with ``-D`` flags) at the replay's capacity 100,000: the
sample at B=256 for every (levels a round, lanes a target, staged top
levels, PDL) and the write at n = 32, 256 and 9,984 with PDL and
without, beside the port's first tree kernels (``csrc/tree_first.cu``),
each checked bitwise against the plain version and timed hot and cold
(the L2 flushed before every call); and the two latencies that floor
them (``csrc/latency_probe.cu``: an empty kernel, one dependent load
from L2 and from device memory). Times are CUDA events over back-to-back
calls after a warm-up, enqueued while the card is held busy (so the
wrappers' host work is not in them), the median of three runs; the card
must be there (``resolve_device``).

    python -m repro_torch.launch.bwd_sweep --only tree   # the tree rows
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
from repro_torch.kernels.replay_tree import ops as tree_ops, ref as tree_ref

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
# the replay's tree, the sample's batch and the writes of the training
# path (add, priority refresh, warm-up); the sample's launch shapes the
# sweep builds (ops.build_defines; levels a round, lanes a target, staged
# levels), each with PDL on and off
TREE_CAPACITY, TREE_BATCH, TREE_WRITES = 100_000, 256, (32, 256, 9984)
SAMPLE_SHAPES = tuple((k, lanes, top) for k, lanes in
                      ((3, 8), (4, 16), (5, 16), (5, 32), (6, 32))
                      for top in (0, 8, 11))


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


def l2_flusher(dev, nbytes: int = 128 << 20):
    """A call that evicts the card's 50 MB L2 (writes ``nbytes``)."""
    buf = torch.empty((nbytes // 4,), device=dev)
    return buf.zero_


def time_per_call_us(fn, flush=None, reps: int = 30) -> float:
    """Device time of one call of ``fn()``, each bracketed by its own CUDA
    events, after ``flush()`` where one is given (cold: the L2 evicted),
    all enqueued while the card is held busy; the mean of the middle half
    of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(2e6 * max(5.0, 0.2 * reps)))
    for start, end in events:
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    us = sorted(1e3 * a.elapsed_time(b) for a, b in events)
    mid = us[reps // 4:reps - reps // 4]
    return sum(mid) / len(mid)


LATENCY_SOURCE = Path(__file__).resolve().parent / "csrc" / \
    "latency_probe.cu"
FIRST_TREE_SOURCE = Path(__file__).resolve().parent / "csrc" / \
    "tree_first.cu"


def _latency_library():
    import ctypes

    from repro_torch.kernels import load_library
    lib = load_library("latency_probe", [LATENCY_SOURCE])
    if lib.chase_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.empty_launch.argtypes = [p]
        lib.chase_launch.argtypes = [p, i, i, p, p]
        lib.empty_launch.restype = lib.chase_launch.restype = ctypes.c_int
    return lib


def _check(what, err):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def latency_floor(dev=None, nbytes: int = 1 << 20) -> dict:
    """``{"empty_us", "l2_ns", "hbm_ns"}``: an empty kernel's time as
    ``_time_us`` takes it (back-to-back launches), and one dependent load's
    latency from a one-thread pointer chase over ``nbytes`` (the tree's 1
    MB) of 128-byte lines in a random cycle, each line once: hot (the
    buffer in L2) and cold (the L2 flushed just before)."""
    dev = resolve_device(dev)
    lib = _latency_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    empty_us = _time_us(lambda _: _check("empty", lib.empty_launch(stream)))
    lines = nbytes // 128
    order = torch.randperm(lines, generator=torch.Generator().manual_seed(0))
    nxt = torch.zeros((lines * 32,), dtype=torch.int32)
    nxt[order * 32] = (torch.roll(order, -1) * 32).to(torch.int32)
    nxt, out = nxt.to(dev), torch.empty((1,), dtype=torch.int32, device=dev)
    start = int(order[0]) * 32

    def chase():
        _check("chase", lib.chase_launch(nxt.data_ptr(), lines, start,
                                         out.data_ptr(), stream))
    flush = l2_flusher(dev)
    hot = time_per_call_us(chase, reps=8)
    cold = time_per_call_us(chase, flush, reps=8)
    return {"empty_us": empty_us, "l2_ns": 1e3 * hot / lines,
            "hbm_ns": 1e3 * cold / lines}


def tree_libraries(sample_shapes=SAMPLE_SHAPES):
    """``{(shape, pdl): library}``: ``replay_tree.cu`` built for each
    sample shape, PDL on and off, one nvcc each, all at once."""
    from concurrent.futures import ThreadPoolExecutor
    plans = [(shape, pdl) for shape in sample_shapes
             for pdl in (False, True)]

    def build(plan):
        defines = tree_ops.build_defines(*plan)
        name = "replay_tree_" + "_".join(d.split("=")[1] for d in defines)
        return plan, tree_ops.library(name, defines)
    with ThreadPoolExecutor(max_workers=8) as pool:
        return dict(pool.map(build, plans))


def _first_tree_library():
    import ctypes

    from repro_torch.kernels import load_library
    lib = load_library("tree_first", [FIRST_TREE_SOURCE])
    if lib.first_set.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.first_sample.argtypes = [p, i, i, p, i, p, p, p]
        lib.first_set.argtypes = [p, i, p, p, i, p, p, p]
        lib.first_sample.restype = lib.first_set.restype = ctypes.c_int
    return lib


def _tree_case(dev, gen):
    """A full tree of the replay's capacity and the sample's targets."""
    tree = tree_ops.sumtree_init(TREE_CAPACITY, dev)
    tree_ref.tree_set_ref(tree, torch.arange(TREE_CAPACITY, device=dev),
                          torch.rand((TREE_CAPACITY,), generator=gen,
                                     device=dev) * 2 + 1e-3)
    t = torch.rand((TREE_BATCH,), generator=gen, device=dev) * tree[1]
    return tree, t


def tree_rows(seed: int = 0) -> List[dict]:
    """The sum-tree kernels at every launch shape of ``tree_libraries``
    (the write has one, with PDL on and off) beside the port's first
    kernels (``csrc/tree_first.cu``), each bitwise against the plain
    version, hot (back to back, the tree in L2) and cold (one call right
    after the L2 was evicted); ``*`` marks ``SAMPLE_PLAN`` with ``PDL``.
    Then the latency floor."""
    dev = resolve_device(None)
    libs, first = tree_libraries(), _first_tree_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(seed)
    tree, t = _tree_case(dev, gen)
    depth = tree.shape[0].bit_length() - 1
    want = tree_ref.tree_sample_ref(tree, t, capacity=TREE_CAPACITY)
    want_pri = tree_ref.tree_get_ref(tree, want)
    leaf = torch.empty((TREE_BATCH,), dtype=torch.int32, device=dev)
    pri = torch.empty((TREE_BATCH,), device=dev)
    skipped = torch.zeros((1,), dtype=torch.int32, device=dev)
    owner = torch.empty((tree.shape[0] // 2,), dtype=torch.int32,
                        device=dev)
    flush = l2_flusher(dev)
    picked = (tree_ops.SAMPLE_PLAN, tree_ops.PDL)
    rows = []

    def row(product, plan, run, is_pick=False):
        rows.append(dict(net="tree", layer="-", product=product,
                         shape=f"{tree.shape[0]} nodes",
                         plan=f"{plan}, cold "
                              f"{time_per_call_us(run, flush):6.2f} us",
                         picked=is_pick, us=_time_us(lambda _: run())))

    def sample_run(entry):
        def run():
            _check("tree sample", entry(
                tree.data_ptr(), depth, TREE_CAPACITY, t.data_ptr(),
                TREE_BATCH, leaf.data_ptr(), pri.data_ptr(), stream))
        run()
        if not (torch.equal(leaf, want) and torch.equal(pri, want_pri)):
            raise AssertionError(f"{entry.__name__} != plain")
        return run
    row(f"sample B={TREE_BATCH}", "first design (a thread a target)",
        sample_run(first.first_sample))
    for (shape, pdl), lib in libs.items():
        row(f"sample B={TREE_BATCH}", f"k={shape[0]} lanes={shape[1]:2d} "
            f"top={shape[2]:2d} pdl={int(pdl)}", sample_run(lib.tree_sample),
            (shape, pdl) == picked)
    for n in TREE_WRITES:
        if n == TREE_BATCH:      # the priority refresh: sampled leaves
            idx = tree_ref.tree_sample_ref(tree, torch.rand(
                (n,), generator=gen, device=dev) * tree[1],
                capacity=TREE_CAPACITY)
        else:
            idx = torch.randperm(TREE_CAPACITY, generator=gen,
                                 device=dev)[:n].to(torch.int32)
        val = torch.rand((n,), generator=gen, device=dev) + 0.5
        want_tree = tree_ref.tree_set_ref(tree.clone(), idx, val)
        work = tree.clone()

        def set_run(call, what):
            def run(target=work):
                _check(what, call(target))
            check = tree.clone()
            run(check)
            if not torch.equal(check, want_tree):
                raise AssertionError(f"{what} n={n} != plain")
            return run
        row(f"set n={n}", "first design (owner scratch)", set_run(
            lambda w: first.first_set(
                w.data_ptr(), depth, idx.data_ptr(), val.data_ptr(), n,
                owner.data_ptr(), skipped.data_ptr(), stream), "first_set"))
        for pdl in (False, True):
            entry = libs[tree_ops.SAMPLE_PLAN, pdl].tree_set
            row(f"set n={n}", f"pdl={int(pdl)}", set_run(
                lambda w, entry=entry: entry(
                    w.data_ptr(), depth, idx.data_ptr(), val.data_ptr(), n,
                    skipped.data_ptr(), stream), "tree_set"),
                pdl == tree_ops.PDL)
    if int(skipped):
        raise AssertionError(f"{int(skipped)} writes skipped")
    floor = latency_floor(dev)
    rows.append(dict(net="tree", layer="-", product="latency floor",
                     shape="1 MB chase", plan=f"empty kernel "
                     f"{floor['empty_us']:.2f} us, L2 load "
                     f"{floor['l2_ns']:.0f} ns, HBM load "
                     f"{floor['hbm_ns']:.0f} ns", picked=False,
                     us=floor["empty_us"]))
    return rows


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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=("all", "tree"), default="all")
    only = parser.parse_args().only
    rows = tree_rows()
    if only == "all":
        rows = sweep() + whole_rows() + dense_rows() + mma_peak_rows() + rows
    print(f"# {torch.cuda.get_device_name(0)}; config 3 = 128x128 (the "
          f"backward only), 4 = 128x64, 5 = the weight-streaming kernel (its "
          f"last number counts rows); fused dense configs by (BM, BN): "
          f"{dict(enumerate(dense_block.TILES))}; * = plan_bwd's, "
          f"plan_fwd's, dense_block.plan's or the tree's SAMPLE_PLAN and "
          f"PDL pick")
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
        print(f"  {what}: {r['us']:8.2f} us{'  *' if r['picked'] else ''}")


if __name__ == "__main__":
    main()
