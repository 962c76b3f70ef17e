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
``dense_tile.cuh`` past them); the backward's whole-stack kernel at the
same stacks at the batch, every row tile of a sweep block, beside the
per-layer kernels; the register tile on fig3-width's mlp critic over h^T
(U=2048, M=256), every split of each layer, beside ``dense_tile.cuh``;
the thin first-layer backward products of the presets' wide stacks
(``THIN``: d0 under 128) on ``dense_tile.cuh`` and the register tile at
every split (``--only thin`` for these alone; ``--only stack`` runs the
whole-stack, fig3 and thin rows); and the fused dense kernel
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
from L2 and from device memory). Then flash attention
(``flash_attention.cu``, 3xTF32 on ``mma.sync``, built once for each
candidate with ``-D`` flags: warps a block, keys a tile, ``expf`` or
``__expf`` in the softmax) at the full shape (B=2 S=2048 H=16 KV=4 hd=64,
causal) and the ``kernels_micro`` row's (B=1 S=256 H=8 KV=4 hd=32),
float32 and bfloat16, each candidate held against the plain version,
beside the port's first flash kernel (``csrc/flash_first.cu``), two SDPA
yardsticks (the GQA call on the backend that takes q's dtype, math for
float32 and flash for bfloat16; the memory-efficient backend on K/V
already repeated to H heads), the plain version and the kernel's
arithmetic emulated (``ref.emulated_attention``), every error also
against a float64 attention. Then the SSD chunk (``ssd_scan.cu``, 3xTF32
on ``mma.sync``, built once for each candidate with ``-D`` flags: heads a
block sharing C B^T, warps, s-tile width, ``expf`` or ``__expf``; each build's registers and spilled bytes a thread beside it)
at the full shape (G=16 H=16 Q=256 N=P=64) and the ``kernels_micro``
row's chunk (G=8 H=4 Q=16 N=8 P=16), float32 and bfloat16, each
candidate held against the plain version, beside the port's first SSD
kernel (``csrc/ssd_first.cu``), the plain version and the kernel's
arithmetic emulated (``ref.emulated_ssd_chunk``), every error also against
a float64 chunk. Times are
CUDA events over back-to-back calls after a warm-up, enqueued while the
card is held busy (so the wrappers' host work is not in them), the median
of three runs; the card must be there (``resolve_device``).

    python -m repro_torch.launch.bwd_sweep --only tree    # the tree rows
    python -m repro_torch.launch.bwd_sweep --only flash   # the flash rows
    python -m repro_torch.launch.bwd_sweep --only ssd     # the SSD rows
    python -m repro_torch.launch.bwd_sweep --only stack   # the whole-stack
                                            # kernels and fig3's mlp rows
    python -m repro_torch.launch.bwd_sweep --only fwd     # the forward's
                                            # tensor-core tile against the
                                            # register tile, U 128..2048
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
from repro_torch.kernels.flash_attention import flash_attention as flash
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.replay_tree import ops as tree_ops, ref as tree_ref
from repro_torch.kernels.ssd_scan import ref as ssd_ref, ssd_scan

# (name, M, d0, U, L) of the training path's densenet stacks
NETS = (("critic", 256, 516, 2048, 2), ("actor", 256, 259, 2048, 2))
# the serving slots the weight-streaming kernel is swept at
STREAM_SLOTS = (1, 8, 32)
# (name, d0, U, L) of the OFENet stacks, and the rows the whole-stack
# kernel is swept at: the serving slots and the training batch
OFENET = (("phi_s", 3, 64, 4), ("phi_sa", 260, 64, 4))
WHOLE_M = (1, 8, 32, 256)
# the rows the backward's whole-stack kernel is swept at: the batch
WHOLE_BWD_M = (256,)
# a wide stack's thin first-layer products, as the presets run them
# (name, connectivity, M, d0, U): fig10-ablation's actor and critic (their
# 16-unit OFENet features), rl-distributed's actor, fig3-width's critic at
# 2048 units
THIN = (("fig10 actor", "densenet", 128, 35, 128),
        ("fig10 critic", "densenet", 128, 68, 128),
        ("rl-distributed actor", "densenet", 128, 67, 128),
        ("fig3 critic", "mlp", 256, 4, 2048))
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
# (name, B, S, H, KV, hd) of the flash rows, causal: the full shape and the
# kernels_micro row; the kernel's builds the sweep times (warps a block,
# keys a tile, fast exp; flash_attention.build_defines)
FLASH_PLANS = tuple((w, bkv, fe) for w in (4, 8) for bkv in (32, 64)
                    for fe in (1, 0))
FLASH_CASES = (("full", 2, 2048, 16, 4, 64), ("micro", 1, 256, 8, 4, 32))
# (name, G, H, Q, N, P) of the SSD rows: the full shape (B=2 S=2048 at
# chunk 256) and the kernels_micro row's chunk; the kernel's builds the
# sweep times (heads a block, warps, s-tile width, fast exp;
# ssd_scan.build_defines)
SSD_PLANS = ((1, 4, 32, 1), (2, 4, 32, 1), (4, 4, 32, 1), (1, 4, 64, 1),
             (2, 4, 64, 1), (2, 8, 32, 1), (4, 8, 32, 1), (2, 4, 32, 0))
SSD_CASES = (("full", 16, 16, 256, 64, 64), ("micro", 8, 4, 16, 8, 16))


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


def tc_candidates(m: int, n: int, k: int
                  ) -> List[Tuple[int, int, int, int]]:
    """Every ``(config, tiles, splits, chunks_per_split)`` the tensor-core
    tile (``dense_tile_tc.cuh``) may take for an ``(m, n)`` output and a
    reduction of ``k``: each split count that gives a distinct chunk
    partition, at least ``_TC_MIN_CHUNKS`` chunks a split."""
    bm, bn, bk = stack._TC_TILE
    tiles = -(-m // bm) * -(-n // bn)
    chunks = -(-k // bk)
    out, seen = [], set()
    for want in range(1, max(1, chunks // stack._TC_MIN_CHUNKS) + 1):
        per = -(-chunks // want)
        splits = -(-chunks // per)
        if splits not in seen:
            seen.add(splits)
            out.append((stack._TC_CONFIG, tiles, splits, per))
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
FIRST_FLASH_SOURCE = Path(__file__).resolve().parent / "csrc" / \
    "flash_first.cu"
FIRST_SSD_SOURCE = Path(__file__).resolve().parent / "csrc" / \
    "ssd_first.cu"


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


def flash_libraries(plans=FLASH_PLANS):
    """``{plan: library}``: ``flash_attention.cu`` built for each launch
    shape, one nvcc each, all at once."""
    from concurrent.futures import ThreadPoolExecutor

    def build(plan):
        defines = flash.build_defines(plan)
        name = "flash_attention_" + "_".join(map(str, plan))
        return plan, flash._library(name, defines)
    with ThreadPoolExecutor(max_workers=8) as pool:
        return dict(pool.map(build, plans))


def _first_flash_library():
    import ctypes

    from repro_torch.kernels import load_library
    lib = load_library("flash_first", [FIRST_FLASH_SOURCE])
    fn = lib.flash_first_fwd
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return lib


def sdpa_yardsticks(q, k, v):
    """Two SDPA calls computing causal GQA attention on ``(B, S, H, hd)``
    q and ``(B, S, KV, hd)`` k, v, as ``{label: fn}``, both pinned to their
    backend with ``sdpa_kernel``: the GQA call (``enable_gqa``) on the
    backend that takes it in q's dtype, math for float32 (flash takes no
    float32, and only flash and math take GQA), flash for bfloat16, labelled
    by its name; and the memory-efficient backend on K/V repeated to H
    heads, the repeat built here, outside the timed call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    g = q.shape[2] // k.shape[2]
    kr, vr = (t.repeat_interleave(g, 1) for t in (kt, vt))

    def pinned(backend, *args, **kw):
        def run(_=None):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(*args, is_causal=True,
                                                      **kw)
        return run
    backend = SDPBackend.MATH if q.dtype == torch.float32 else \
        SDPBackend.FLASH_ATTENTION
    return {f"sdpa {backend.name.lower()}, enable_gqa":
            pinned(backend, qt, kt, vt, enable_gqa=True),
            "sdpa efficient_attention, K/V repeated":
            pinned(SDPBackend.EFFICIENT_ATTENTION, qt, kr, vr)}


def flat_heads(t, heads: int):
    """``(B, S, KV, hd)`` -> ``(B*heads, S, hd)``, kv head i repeated for
    query heads i*G .. i*G + G - 1 (G = heads / KV)."""
    b, s, kvh, hd = t.shape
    return t.permute(0, 2, 1, 3).repeat_interleave(heads // kvh, 1).reshape(
        b * heads, s, hd)


def attention_f64(q, k, v):
    """Causal GQA attention of ``(B, S, H, hd)`` q and ``(B, S, KV, hd)``
    k, v in float64, ``(B*H, S, hd)``: what the float32 versions' errors
    are measured against."""
    h, s, hd = q.shape[2], q.shape[1], q.shape[3]
    q, k, v = (flat_heads(t, h).double() for t in (q, k, v))
    sc = (q * hd ** -0.5) @ k.transpose(1, 2)
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    return torch.where(ok, sc, -1e30).softmax(-1) @ v


def flash_rows(seed: int = 0) -> List[dict]:
    """Flash attention at each ``FLASH_CASES`` shape, float32 and bfloat16:
    every build of ``flash_libraries`` (each held against the plain
    version: 1e-4 float32, 2e-2 bfloat16, rtol and atol * max|plain|), the
    port's first kernel (``csrc/flash_first.cu``) and the SDPA yardsticks;
    ``*`` marks ``flash.PLAN``. Each row's max abs error is given against
    the plain version and (``f64``) against ``attention_f64``, beside the
    plain version's own and ``ref.emulated_attention``'s (not timed) with
    each exp, its sums rounded to nearest, and with the plan's exp, its
    sums rounded toward zero a k8 MMA at a time as the tensor cores round
    them: what sets the kernel's error."""
    dev = resolve_device(None)
    libs, first = flash_libraries(), _first_flash_library()
    gen = torch.Generator(device=dev).manual_seed(seed)
    view = lambda t: t.permute(0, 2, 1, 3)
    rows = []
    for name, b, s, h, kvh, hd in FLASH_CASES:
        for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q = torch.randn((b, s, h, hd), generator=gen, device=dev)
            k, v = (torch.randn((b, s, kvh, hd), generator=gen, device=dev)
                    for _ in range(2))
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            want = flash_ref.plain_attention(q, k, v).float()
            exact = attention_f64(q, k, v)
            to_flat = lambda t: flat_heads(t, h)
            f64 = lambda t: float((t.double() - exact).abs().max())
            out = torch.empty_like(q)
            label = f"{name} {str(dtype)[6:]}"
            shape = f"B={b} S={s} H={h} KV={kvh} hd={hd} causal"

            def run(entry):
                def call(_=None):
                    flash._launch(entry, view(q), view(k), view(v),
                                  view(out), True, 0, 0.0)
                call()
                err = (out.float() - want).abs()
                bar = rtol * want.abs() + rtol * want.abs().max()
                if not bool(torch.all(err <= bar)):
                    raise AssertionError(f"{entry.__name__} {label}: max "
                                         f"abs err {float(err.max()):.3e}")
                return call, (float(err.max()), f64(to_flat(out)))

            def row(plan, call, err=None, is_pick=False):
                what = plan if err is None else \
                    f"{plan}, err {err[0]:.1e} (f64 {err[1]:.1e})"
                rows.append(dict(net="flash", layer=label,
                                 product="attention", shape=shape, plan=what,
                                 picked=is_pick,
                                 us=None if call is None else
                                 _time_us(call)))
            plain = lambda _=None: flash_ref.plain_attention(q, k, v)
            row("plain version", plain, (0.0, f64(to_flat(want))))
            for fast, rz in ((0, False), (1, False), (flash.PLAN[2], True)):
                got = flash_ref.emulated_attention(
                    to_flat(q), to_flat(k), to_flat(v), causal=True,
                    fast_exp=bool(fast), mma_rz=rz)
                row(f"emulation (not timed), exp="
                    f"{'__expf' if fast else 'expf'}, sums "
                    f"{'toward zero a k8 MMA' if rz else 'to nearest'}", None,
                    (float((got - to_flat(want)).abs().max()), f64(got)))
            row("first design (SIMT, 8 warps, 64-key tiles)",
                *run(first.flash_first_fwd))
            for plan, lib in libs.items():
                row(f"warps={plan[0]} bkv={plan[1]:2d} "
                    f"exp={'__expf' if plan[2] else 'expf'}",
                    *run(lib.flash_attention_fwd), is_pick=plan == flash.PLAN)
            for what, call in sdpa_yardsticks(q, k, v).items():
                got = call().transpose(1, 2)
                row(what, call, (float((got.float() - want).abs().max()),
                                 f64(to_flat(got))))
    return rows


def ssd_libraries(plans=SSD_PLANS):
    """``{plan: library}``: ``ssd_scan.cu`` built for each plan, one nvcc
    each, all at once."""
    from concurrent.futures import ThreadPoolExecutor

    def build(plan):
        name = "ssd_scan_" + "_".join(map(str, plan))
        return plan, ssd_scan._library(name, ssd_scan.build_defines(plan))
    with ThreadPoolExecutor(max_workers=8) as pool:
        return dict(pool.map(build, plans))


def _first_ssd_library():
    import ctypes

    from repro_torch.kernels import load_library
    lib = load_library("ssd_first", [FIRST_SSD_SOURCE])
    fn = lib.ssd_first_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def ssd_f64(c, b, x, cum, dt, state, d_skip):
    """``ref.ssd_chunk_dual_ref``'s function in float64 (masked before the
    exp): what the float32 versions' errors are measured against."""
    c, b, x, cum, dt, state = (t.double() for t in
                               (c, b, x, cum, dt, state))
    q = c.shape[1]
    ok = torch.ones((q, q), dtype=torch.bool, device=c.device).tril()
    rel = torch.where(ok, cum[..., :, None] - cum[..., None, :], -math.inf)
    m = (c @ b.transpose(1, 2))[:, None] * rel.exp() * dt[:, :, None, :]
    return m @ x + cum.exp()[..., None] * (c[:, None] @ state.transpose(
        2, 3)) + d_skip.double()[None, :, None, None] * x


def ssd_rows(seed: int = 0) -> List[dict]:
    """The SSD chunk at each ``SSD_CASES`` shape, float32 and bfloat16:
    every build of ``ssd_libraries`` (each held against the plain version:
    1e-4 float32, 2e-2 bfloat16, rtol and atol * max|plain|; its registers
    and spilled bytes a thread at that P), the port's first kernel
    (``csrc/ssd_first.cu``) and the plain version; ``*`` marks
    ``ssd_scan.PLAN``. Each row's max abs error is given against the plain
    version and (``f64``) against ``ssd_f64``, beside
    ``ref.emulated_ssd_chunk``'s (not timed; the plan's exp, its sums
    rounded toward zero a k8 MMA at a time as the tensor cores round
    them)."""
    import ctypes
    import torch.nn.functional as F
    dev = resolve_device(None)
    libs, first = ssd_libraries(), _first_ssd_library()
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for name, g, h, q, n, p in SSD_CASES:
        for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
            c, b, x = (rnd(*s).to(dtype) for s in
                       ((g, q, n), (g, q, n), (g, h, q, p)))
            cum = torch.cumsum(-F.softplus(rnd(g, h, q)), -1)
            args = (c, b, x, cum, F.softplus(rnd(g, h, q)),
                    rnd(g, h, p, n), rnd(h))
            want = ssd_ref.ssd_chunk_dual_ref(*args).float()
            exact = ssd_f64(*args)
            f64 = lambda t: float((t.double() - exact).abs().max())
            out = torch.empty_like(x)
            label = f"{name} {str(dtype)[6:]}"
            shape = f"G={g} H={h} Q={q} N={n} P={p}"

            def run(entry):
                def call(_=None):
                    ssd_scan._launch(*args, out, entry=entry)
                call()
                err = (out.float() - want).abs()
                bar = rtol * want.abs() + rtol * want.abs().max()
                if not bool(torch.all(err <= bar)):
                    raise AssertionError(f"{entry.__name__} {label}: max "
                                         f"abs err {float(err.max()):.3e}")
                return call, (float(err.max()), f64(out))

            def row(plan, call, err=None, is_pick=False):
                what = plan if err is None else \
                    f"{plan}, err {err[0]:.1e} (f64 {err[1]:.1e})"
                rows.append(dict(net="ssd", layer=label, product="chunk",
                                 shape=shape, plan=what, picked=is_pick,
                                 us=None if call is None else
                                 _time_us(call)))
            row("plain version",
                lambda _=None: ssd_ref.ssd_chunk_dual_ref(*args),
                (0.0, f64(want)))
            emu = ssd_ref.emulated_ssd_chunk(
                *args, fast_exp=bool(ssd_scan.PLAN[3]), mma_rz=True,
                s_tile=ssd_scan.PLAN[2])
            row("emulation (not timed), sums toward zero a k8 MMA", None,
                (float((emu - want).abs().max()), f64(emu)))
            row("first design (SIMT, 256 threads, C B^T a head)",
                *run(first.ssd_first_fwd))
            regs, spill = ctypes.c_int(), ctypes.c_int()
            code = int(dtype == torch.bfloat16)
            for plan, lib in libs.items():
                lib.ssd_kernel_attrs(code, code, p, ctypes.byref(regs),
                                     ctypes.byref(spill))
                row(f"heads={plan[0]} warps={plan[1]} bs={plan[2]} "
                    f"exp={'__expf' if plan[3] else 'expf'} "
                    f"({regs.value} regs, {spill.value} B spilled)",
                    *run(lib.ssd_chunk_fwd), is_pick=plan == ssd_scan.PLAN)
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
            a_dw = stack._op(out)
            for dx in (False, True):
                mm, nn, kk = (m, k, u) if dx else (k, u, m)
                pick = stack.plan_bwd(mm, nn, kk, num_sms, dx=dx,
                                      vec=stack._vec(a_dw))
                for plan in candidates(mm, nn, kk, num_sms, dx):
                    if dx:
                        def run(plan=plan):
                            bw._product(plan, True, stack._op(gzt),
                                        stack._op(wt), gb, 0, 0, mm, nn,
                                        kk, True)
                    else:
                        def run(plan=plan):
                            bw._product(plan, False, a_dw,
                                        stack._op(gz), dw, 0, 0, mm, nn,
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


def whole_bwd_rows(seed: int = 0) -> List[dict]:
    """The backward's whole-stack kernel at every row tile of a sweep
    block, and the per-layer kernels (``whole=False``), for each OFENet
    stack at the training batch (``WHOLE_BWD_M``), every gradient asked
    for; then its parts at the planned tile (the sweeps alone, the
    reductions without dx, ...);
    weights cycled through 64 copies (they stay in L2, as in
    training)."""
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    act = stack._ACT_CODE["swish"]
    rows = []
    for name, d0, u, n_layers in OFENET:
        ws = [torch.empty((d0 + i * u, u), device=dev).uniform_(
            -1 / math.sqrt(d0 + i * u), 1 / math.sqrt(d0 + i * u),
            generator=gen) for i in range(n_layers)]
        bs = [torch.zeros((u,), device=dev) for _ in range(n_layers)]
        copies = [[w.clone() for w in ws] for _ in range(64)]
        need = [True] * n_layers
        for m in WHOLE_BWD_M:
            x = torch.randn((m, d0), generator=gen, device=dev)
            zs = torch.empty((m, n_layers * u), device=dev)
            out = stack._kernel_forward(x, ws, bs, "densenet", "swish", zs)
            g = torch.randn(out.shape, generator=gen, device=dev)
            rows.append(dict(net=name, layer="all", product=f"bwd M={m}",
                             shape=(m, d0, u, n_layers),
                             plan="per-layer kernels", picked=False,
                             us=_time_us(lambda i: stack._kernel_backward(
                                 (out, zs), copies[i], g, "densenet",
                                 "swish", True, need, need, whole=False),
                                 copies=len(copies))))
            for r in stack._WHOLE_BWD_ROW_TILES:
                if stack.whole_bwd_smem(d0, u, n_layers, r) is None:
                    continue

                def run(i, r=r):
                    stack._launch_whole_bwd(out, zs, copies[i], g, act,
                                            True, need, need, 0, r)
                rows.append(dict(
                    net=name, layer="all", product=f"bwd M={m}",
                    shape=(m, d0, u, n_layers),
                    plan=f"whole, {r} rows a sweep block",
                    picked=r == stack._WHOLE_BWD_ROWS,
                    us=_time_us(run, copies=len(copies))))
            # the parts at the planned rows: the sweeps alone (dx only: no
            # reduction task), and without dx (the sweep stops a layer
            # early, the reductions all there)
            none = [False] * n_layers
            top = [i == n_layers - 1 for i in range(n_layers)]
            bottom = [i == 0 for i in range(n_layers)]
            for what, args in (
                    ("dx alone", (True, none, none, 0)),
                    ("weights alone", (False, need, need, 0)),
                    ("db alone", (False, none, need, 0)),
                    ("the top layer's dW alone", (False, top, none,
                                                  n_layers - 1)),
                    ("dx and layer 0's dW", (True, bottom, none, 0))):
                def run(i, args=args):
                    stack._launch_whole_bwd(out, zs, copies[i], g, act,
                                            *args)
                rows.append(dict(net=name, layer="all", product=f"bwd M={m}",
                                 shape=(m, d0, u, n_layers),
                                 plan=f"whole, {what}", picked=False,
                                 us=_time_us(run, copies=len(copies))))
    return rows


def thin_rows(seed: int = 0) -> List[dict]:
    """The first layer's dW and dx of each ``THIN`` stack on
    ``dense_tile.cuh`` (``plan``, the path before) and on the register
    tile at every candidate, ``plan_bwd``'s pick marked."""
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, conn, m, d0, u in THIN:
        ws = [torch.empty((k, u), device=dev).uniform_(
            -1 / math.sqrt(k), 1 / math.sqrt(k), generator=gen)
            for k in (d0, d0 + u if conn == "densenet" else u)]
        bs = [torch.zeros((u,), device=dev) for _ in ws]
        x = torch.randn((m, d0), generator=gen, device=dev)
        zs = torch.empty((m, 2 * u), device=dev)
        out = stack._kernel_forward(x, ws, bs, conn, "swish", zs)
        bw = stack._Backward(m, u, "swish", dev)
        if conn == "densenet":
            g = torch.randn(out.shape, generator=gen, device=dev)
            gz, gzt, _ = bw.act_grad(g, d0, zs, 0, False, True)
            a_dw = stack._op(out)
        else:
            g = torch.randn((m, u), generator=gen, device=dev)
            gz, gzt, _ = bw.act_grad(g, 0, zs, 0, False, True)
            a_dw = stack._op(x)
        wt = bw.transpose(ws[0])
        dw = torch.empty((d0, u), device=dev)
        dx = torch.empty((m, stack._pad4(d0)), device=dev)[:, :d0]
        for is_dx in (False, True):
            mm, nn, kk = (m, d0, u) if is_dx else (d0, u, m)
            pick = stack.plan_bwd(mm, nn, kk, num_sms, dx=is_dx,
                                  vec=stack._vec(a_dw))
            plans = [stack.plan(mm, nn, kk, num_sms)] + \
                candidates(mm, nn, kk, num_sms, is_dx)
            for plan in plans:
                rt = plan[0] in stack._RT_CONFIGS
                if is_dx:
                    a, b = (gzt, wt) if rt else (gz, ws[0])

                    def run(plan=plan, a=a, b=b):
                        bw._product(plan, True, stack._op(a),
                                    stack._op(b), dx, 0, 0, mm, nn, kk,
                                    False)
                else:
                    def run(plan=plan):
                        bw._product(plan, False, a_dw, stack._op(gz),
                                    dw, 0, 0, mm, nn, kk, False)
                rows.append(dict(net=name, layer=0,
                                 product="dx" if is_dx else "dW",
                                 shape=(mm, nn, kk),
                                 plan=plan if rt else
                                 f"dense_tile.cuh, config {plan[0]}, "
                                 f"{plan[2]} splits",
                                 picked=plan == pick,
                                 us=_time_us(lambda _: run())))
    return rows


def hidden_rows(seed: int = 0) -> List[dict]:
    """The register tile on fig3-width's mlp critic at the batch (d0=4,
    U=2048, two layers, M=256) over h^T: each layer at every split of its
    128x64 tiles, marking ``plan_fwd``'s, beside the layer on
    ``dense_tile.cuh`` as ``plan`` plans it (the path before)."""
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = stack._library()
    stream_h = torch.cuda.current_stream(dev).cuda_stream
    act = stack._ACT_CODE["swish"]
    m, d0, u = 256, 4, 2048
    rows = []
    x = torch.randn((m, max(d0, u)), generator=gen, device=dev)
    xt = torch.empty((x.shape[1], stack._pad4(m)), device=dev)
    xt[:, :m].copy_(x.t())
    y = torch.empty((m, u), device=dev)
    yt = torch.empty((u, stack._pad4(m)), device=dev)[:, :m]
    for i, k in enumerate((d0, u)):
        w = torch.empty((k, u), device=dev).uniform_(
            -1 / math.sqrt(k), 1 / math.sqrt(k), generator=gen)
        b = torch.zeros((u,), device=dev)
        pick = stack.plan_fwd(m, u, k, num_sms)
        for plan in candidates(m, u, k, num_sms, True):
            if plan[0] != stack._RT_FWD_CONFIG:
                continue

            def run(_, plan=plan):
                stack._launch_layer(lib, plan, None, None, w, b, None, 0, act,
                                    stream_h, at=xt[:k, :m], yt=yt)
            rows.append(dict(net="fig3_critic", layer=i, product="fwd h^T",
                             shape=(m, u, k), plan=plan, picked=plan == pick,
                             us=_time_us(run)))
        old = stack.plan(m, u, k, num_sms)

        def run_old(_):
            stack._launch_layer(lib, old, (x[:, :k], 0), None, w, b, y, 0,
                                act, stream_h)
        rows.append(dict(net="fig3_critic", layer=i, product="fwd h^T",
                         shape=(m, u, k), plan=old, picked=False,
                         us=_time_us(run_old)))
    return rows


# the forward's widths and fleet sizes at the batch, where the tensor-core
# tile and the register tile both run: the crossover plan_fwd follows
FWD_U = (128, 256, 512, 1024, 2048)
FWD_MEMBERS = (None, 5)


def fwd_rows(seed: int = 0, m: int = 256) -> List[dict]:
    """One forward layer at M=256 for each width of ``FWD_U``, solo and as
    5 members (one member launch), at K = 4 (a pendulum critic's first
    layer), U (mlp's square layers), 259 + U and 259 + 2U (the densenet
    actor's stream at layers 1 and 2): the tensor-core tile at every split
    of ``tc_candidates`` (its input row-major, rows padded to 4 floats) and
    the register tile at ``plan_fwd``'s plan (over the transposed input),
    marking ``plan_fwd``'s pick for the launch's members."""
    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = stack._library()
    stream_h = torch.cuda.current_stream(dev).cuda_stream
    act = stack._ACT_CODE["swish"]
    rows = []
    for u in FWD_U:
        for e in FWD_MEMBERS:
            lead = () if e is None else (e,)
            members = e or 1
            name = f"U={u} E={members}"
            for k in (4, u, 259 + u, 259 + 2 * u):
                a = torch.randn((*lead, m, stack._pad4(k)), generator=gen,
                                device=dev)[..., :k]
                at = torch.empty((*lead, k, stack._pad4(m)),
                                 device=dev)[..., :m]
                at.copy_(a.transpose(-1, -2))
                w = torch.empty((*lead, k, u), device=dev).uniform_(
                    -1 / math.sqrt(k), 1 / math.sqrt(k), generator=gen)
                b = torch.zeros((*lead, u), device=dev)
                y = torch.empty((*lead, m, u), device=dev)
                pick = stack.plan_fwd(m, u, k, num_sms, members=members)
                for plan in tc_candidates(m, u, k):
                    def run(_, plan=plan):
                        stack._launch_tc(lib, plan, a, 0, w, b, (y, 0), None,
                                         None, act, stream_h)
                    rows.append(dict(net=name, layer=k, product="fwd tc",
                                     shape=(m, u, k), plan=plan,
                                     picked=plan == pick,
                                     us=_time_us(run)))
                rt = stack._plan_rt(m, u, k, num_sms)

                def run_rt(_):
                    stack._launch_layer(lib, rt, None, None, w, b, y, 0, act,
                                        stream_h, at=at)
                rows.append(dict(net=name, layer=k, product="fwd rt",
                                 shape=(m, u, k), plan=rt,
                                 picked=rt == pick, us=_time_us(run_rt)))
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
    parser.add_argument("--only", choices=("all", "tree", "flash", "ssd",
                                           "stack", "thin", "fwd"),
                        default="all")
    only = parser.parse_args().only
    if only == "fwd":
        rows = fwd_rows()
    elif only == "stack":
        rows = whole_rows() + whole_bwd_rows() + hidden_rows() + thin_rows()
    elif only == "thin":
        rows = thin_rows()
    else:
        rows = {"flash": flash_rows, "ssd": ssd_rows}.get(only, tree_rows)()
    if only == "all":
        rows = sweep() + fwd_rows() + whole_rows() + whole_bwd_rows() + \
            hidden_rows() + thin_rows() + dense_rows() + mma_peak_rows() + \
            rows + \
            flash_rows() + ssd_rows()
    print(f"# {torch.cuda.get_device_name(0)}; config 3 = 128x128 (the "
          f"backward only), 4 = 128x64, 5 = the weight-streaming kernel (its "
          f"last number counts rows), 7 = the forward's tensor-core tile "
          f"(128x128, chunks of 32); fused dense configs by (BM, BN): "
          f"{dict(enumerate(dense_block.TILES))}; * = plan_bwd's, "
          f"plan_fwd's, dense_block.plan's, the tree's SAMPLE_PLAN and "
          f"PDL, flash_attention.PLAN or ssd_scan.PLAN pick")
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
        if r["us"] is None:
            print(f"  {what}")
            continue
        print(f"  {what}: {r['us']:8.2f} us{'  *' if r['picked'] else ''}")


if __name__ == "__main__":
    main()
