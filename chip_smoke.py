#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing of JAX is imported):

1. Card and settings: the ``nvidia-smi`` name and power limit; TF32 off
   for matmul and cuDNN (the reference is fp32).
2. Build: compile the six CUDA sources from the checkout and the latency
   probe, one nvcc each, all at once (dense_stack_fwd.cu,
   dense_stack_bwd.cu, replay_tree.cu, fused_dense.cu, flash_attention.cu,
   ssd_scan.cu, launch/csrc/latency_probe.cu).
3. Kernels against their plain versions (new kernels in float32 within
   1e-4 and bfloat16 within 2e-2, as rtol and atol * max|plain|):
   - the stack forward (its four kernels: the whole-stack kernel for the
     narrow densenet stacks at every M, weight-streaming at M <= 32,
     register tile over ``stream^T`` at M=256 with U >= 128, the old tile
     for mlp/d2rl past 32 rows) for every fused connectivity x {swish,
     relu, tanh, identity}, at a ragged small shape, at the model's
     shapes (OFENet ``phi_s`` and the actor at every serving slot, 1, 2,
     4, 8, 16, 32, and at 256; the critic at 1, 8, 32, 256; ``phi_s`` and
     ``phi_sa`` at 33, 100, 128, 256, 257) and at two ragged shapes of the
     register tile (201/203 rows), with non-zero biases: |kernel - plain|
     <= 1e-4 * |plain| + 1e-4 * max|plain|, and two calls bitwise equal;
     the whole-stack kernel's pre-activations (``zs``, autograd's) within
     1e-4 of the plain ones, its output bitwise the same with and without
     them;
   - the stack backward (dx, dW, db) for the same 12 cases at the ragged
     shape, at the four nets the training path differentiates at M=256
     (actor, critic, ``phi_s``, ``phi_sa``) and at two ragged shapes of the
     register tile (201/203 rows): within 1e-3 (rtol and atol * max; relu's
     slope at the kernel forward's pre-activations), and two calls bitwise
     equal;
   - the sum-tree sample (B=256, edge targets 0 and total) and write
     (n=32, 256 with duplicates and siblings, 9,984, and 100,000 with
     repeats: many of the write's 1,024-entry passes) at capacity
     100,000: bitwise equal to the plain versions; a write with indices
     outside the leaves skips and counts exactly those;
   - fused dense (``dense_concat_matmul``, one launch, 3xTF32 on the
     tensor cores): 1, 2 and 3 segments, with and without bias, every
     activation, ragged (M=33, N=70) and full (the Ant DenseNet layer 3,
     M=256 K=4207 N=2048); the Ant layer's product alone also against a
     float64 product;
   - flash attention (3xTF32 on ``mma.sync``, one launch a call): causal
     and not, window 32, softcap 50, Sq != Skv, rows with no valid key
     (the mean of v), Sq and Skv at the tiles' edges (63, 65, 127, 129,
     2048), head dims 40 and 100, windows across key tiles, GQA G=4 up to
     the full B=2 S=2048 H=16 KV=4 hd=64, hd=128 at S=2048 and GQA views
     whose row strides rule out 16-byte copies;
   - SSD: ``ssd_chunk_dual`` at chunk 8, a ragged 100 and 256 (the full
     G=16 H=16 N=P=64), and the whole ``ssd_chunked_kernel`` against the
     plain ``ssd_chunked`` + D x at chunk 8 and 256.
4. Serving main path: the paper's "large" Fig. 10 SAC agent
   (``fig10-ablation`` at the paper budget, 2048 units, fused blocks,
   pendulum) is initialised on the card from a seed, saved with the port's
   checkpoint code, served through ``Policy.from_checkpoint`` +
   ``PolicyServer`` to 8 client threads (256 requests), checked against
   the plain path on the CPU, then hot-swapped to a second init. Every tick
   must launch the stack kernels as ``plan_fwd`` plans them: ``phi_s``
   whole (one launch), the actor's layers on the weight-streaming kernel.
   One tick at the most used slot is timed and traced with
   ``torch.profiler``.
5. Training main path: the same agent with the device replay and its
   kernels (``replay_backend="device"``, ``replay_kernel="pallas"``)
   through ``Experiment.from_spec(spec).run``: the warm-up (9,984
   transitions), one superstep on the card against the same superstep on
   the CPU plain path (same state, same draws), then 50 supersteps with
   the launches of every superstep asserted (``expected_launches``: the
   forward by kernel, its stream^T transposes, the backward, the tree),
   finite losses, a consistent replay count and tree total, and
   ``Policy.from_experiment`` checked against the plain path. Wall time
   per superstep and a ``torch.profiler`` breakdown (the forward's wide,
   whole, narrow, streaming and transpose classes; the sum-tree kernels'
   device time per superstep as the main path finds the tree,
   ``[tree-prof]``; the int32 fills of the whole superstep, read, not
   asserted). ``phase_fwd_fills`` then asserts that
   the stack forward itself issues no int32 fill.
   Kernel micro-benchmark path: ``repro_torch.launch.kernels_micro.run()``
   (the fused dense, flash and SSD kernels, which no training or serving
   path runs) with every count set to 0 just before; each row must launch
   its kernel once per call.
6. Times at the main paths' shapes, each beside its plain version, a
   library yardstick the port never calls, and the least time the card
   could take (bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s,
   H100 SXM data sheet; 3xTF32 operations at 495 TFLOP/s for fused dense
   and fp32 flash attention, their fp32 SIMT bounds logged beside them; bf16
   flash's operations at 989 TFLOP/s): the stack forward of the actor and
   ``phi_s`` at slots 1, 8, 32, 256 and of the critic and ``phi_sa`` at
   256 (weights read cold); the
   full stack backward of each net at M=256, and
   the critic's and the actor's product by product (``bwd_breakdown``:
   act_grad, db, dW, W^T, dx, each beside ``torch.mm`` of its shape and
   its bound) with the training profile's per-superstep time of the
   backward's product classes; the tree sample at B=256 and write at
   n=32/256/9,984, hot (the tree in L2) and cold (the L2 flushed before
   each call), beside a latency floor (an empty kernel plus the plan's
   dependent rounds times one load's latency, from L2 or device memory:
   ``bwd_sweep.latency_floor``); fused dense, flash attention and the SSD
   chunk at their full shapes (``phase_new_times``); flash in float32 and
   bfloat16, each beside SDPA's GQA call pinned to the backend that takes
   its dtype (math for float32, flash for bfloat16; named) and the
   memory-efficient backend on K/V repeated to H heads outside the timed
   call.
7. One JSON line of seven kernel records, then the device line, last.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM, fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12          # H100 SXM, TF32 on the tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM, bf16 on the tensor cores
# the paper budget of benchmarks/common.py (PAPER) + Fig. 10's large width
PAPER_BUDGET = dict(total_steps=1_000_000, warmup_steps=10_000,
                    eval_every=10_000, eval_episodes=10,
                    replay_capacity=100_000, batch_size=256,
                    ofenet_units=64, ofenet_layers=4)
SLOTS = (1, 8, 32, 256)


def log(msg: str) -> None:
    print(msg, flush=True)


def num_sms():
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


def close_enough(got, want, rtol=1e-4):
    """(ok, max_abs_err) at rtol, atol rtol * max|want|."""
    import torch
    err = (got - want).abs()
    tol = rtol * want.abs() + rtol * want.abs().max()
    return bool(torch.all(err <= tol)), float(err.max())


def stack_inputs(conn, L, d0, u, m, gen):
    """x, ws, bs on the card: fan-in uniform weights, non-zero biases."""
    import torch
    from repro_torch.kernels.dense_block import stack
    x = torch.randn((m, d0), generator=gen, device="cuda")
    ws, bs = [], []
    for i in range(L):
        k = stack.in_dim(conn, i, d0, u)
        bound = 1.0 / math.sqrt(k)
        ws.append(torch.empty((k, u), device="cuda").uniform_(
            -bound, bound, generator=gen))
        bs.append(0.1 * torch.randn((u,), generator=gen, device="cuda"))
    return x, ws, bs


# the nets whose stacks the training main path runs (name, M, d0, U, L)
TRAIN_NETS = (("actor", 256, 259, 2048, 2), ("critic", 256, 516, 2048, 2),
              ("phi_s", 256, 3, 64, 4), ("phi_sa", 256, 260, 64, 4))
# ragged shapes large enough for the register tile: no size a multiple of
# 4 (scalar loads), and strides that allow 16-byte loads
RAGGED_RT = (("ragged_rt", 201, 37, 301, 3),
             ("ragged_rt_vec", 203, 36, 300, 3))


def phase_parity(gen):
    import torch
    from repro_torch.kernels.dense_block import stack
    from repro_torch.launch.serve_policy import ServeConfig
    shapes = [("ragged", 5, 7, 40, 3)]
    # the served nets at every slot the server pads to (each row count of
    # the streaming kernel's templates) and at the training batch
    for m in sorted(set(ServeConfig().batch_slots) | set(SLOTS)):
        shapes += [("phi_s", m, 3, 64, 4), ("actor", m, 259, 2048, 2)]
    shapes += [("critic", m, 516, 2048, 2) for m in SLOTS]
    shapes += list(RAGGED_RT)
    # the OFENet stacks past 32 rows (the whole-stack kernel for densenet)
    # at full and ragged blocks of its 4 rows
    shapes += [(name, m, d0, 64, 4) for m in WHOLE_ROWS
               for name, d0 in (("phi_s", 3), ("phi_sa", 260))]
    # its other cases: U not a multiple of 4 (4-byte copies of W), U past
    # 64 (128 columns a ring row)
    shapes += [("ragged_whole", 37, 5, 61, 3), ("wide_whole", 7, 9, 100, 2)]
    worst = 0.0
    before = {k: stack.launch_count(k) for k in stack.FWD_KERNELS}
    for conn in stack.FUSED_CONNECTIVITIES:
        for act in ("swish", "relu", "tanh", "identity"):
            for name, m, d0, u, L in shapes:
                x, ws, bs = stack_inputs(conn, L, d0, u, m, gen)
                got = stack.dense_stack(x, ws, bs, connectivity=conn,
                                        activation=act)
                again = stack.dense_stack(x, ws, bs, connectivity=conn,
                                          activation=act)
                want = stack.dense_stack_ref(x, ws, bs, connectivity=conn,
                                             activation=act)
                ok, err = close_enough(got, want)
                worst = max(worst, err)
                if not ok:
                    raise AssertionError(
                        f"kernel != plain: {conn}/{act} {name} M={m} "
                        f"d0={d0} U={u} L={L}: max abs err {err:.3e}")
                if not torch.equal(got, again):
                    raise AssertionError(f"forward not bitwise repeatable: "
                                         f"{conn}/{act} {name} M={m}")
    ran = {k: stack.launch_count(k) - before[k] for k in stack.FWD_KERNELS}
    if not all(ran.values()):
        raise AssertionError(f"a forward kernel was not held: launches {ran}")
    worst_z = phase_whole_zs(gen)
    log(f"[parity] dense_stack kernel == plain: 3 connectivities x 4 "
        f"activations x {len(shapes)} shapes, max abs err {worst:.3e}; two "
        f"calls bitwise equal; launches by kernel {ran}; the whole-stack "
        f"kernel's pre-activations (zs) == plain, max abs err "
        f"{worst_z:.3e}")
    return worst


# rows of the whole-stack kernel's parity: full and ragged 4-row blocks
WHOLE_ROWS = (33, 100, 128, 256, 257)


def phase_whole_zs(gen):
    """The whole-stack kernel with autograd's ``zs`` (phi_s and phi_sa at
    ``WHOLE_ROWS``, every activation): one launch a call, its output
    bitwise the one without ``zs``, two calls bitwise equal, and ``zs``
    within 1e-4 of the plain pre-activations ``stream[:, :d0+i*U] @ W_i +
    b_i``."""
    import torch
    from repro_torch.kernels.dense_block import stack
    worst = 0.0
    for name, d0 in (("phi_s", 3), ("phi_sa", 260)):
        for m in WHOLE_ROWS:
            for act in ("swish", "relu", "tanh", "identity"):
                x, ws, bs = stack_inputs("densenet", 4, d0, 64, m, gen)
                zs = torch.empty((m, 4 * 64), device="cuda")
                zs2 = torch.empty_like(zs)
                before = stack.launch_count("whole")
                got = stack._kernel_forward(x, ws, bs, "densenet", act, zs)
                again = stack._kernel_forward(x, ws, bs, "densenet", act,
                                              zs2)
                plain_out = stack._kernel_forward(x, ws, bs, "densenet", act)
                if stack.launch_count("whole") - before != 3:
                    raise AssertionError(f"{name} M={m}: not one launch of "
                                         f"the whole-stack kernel a call")
                want = stack.dense_stack_ref(x, ws, bs, activation=act)
                zw = torch.cat([want[:, :d0 + i * 64] @ ws[i] + bs[i]
                                for i in range(4)], 1)
                ok, err = close_enough(zs, zw)
                ok2, err2 = close_enough(got, want)
                worst = max(worst, err)
                if not (ok and ok2):
                    raise AssertionError(
                        f"whole-stack kernel != plain: {name} M={m} {act}: "
                        f"zs {err:.3e}, output {err2:.3e}")
                if not (torch.equal(got, again) and torch.equal(zs, zs2)
                        and torch.equal(got, plain_out)):
                    raise AssertionError(f"whole-stack kernel not bitwise "
                                         f"repeatable: {name} M={m} {act}")
    return worst


def grads_close(got, want):
    """(ok, max_abs_err) over matching tensors, each at rtol 1e-3 and atol
    1e-3 * max|want| (the repo's gradient bar: reassociation only)."""
    results = [close_enough(a, b, 1e-3) for a, b in zip(got, want)]
    return all(ok for ok, _ in results), max(err for _, err in results)


def stack_grads(stack, x, ws, bs, g, conn, act):
    """(dx, dws, dbs) through the CUDA forward + backward kernels."""
    import torch
    var = [t.detach().requires_grad_(True) for t in (x, *ws, *bs)]
    out = stack.dense_stack(var[0], var[1:1 + len(ws)], var[1 + len(ws):],
                            connectivity=conn, activation=act)
    grads = torch.autograd.grad(out, var, g)
    return grads[0], list(grads[1:1 + len(ws)]), list(grads[1 + len(ws):])


def phase_backward_parity(gen):
    """dx, dW, db of the backward kernels against autograd of the plain
    version (relu's slope taken at the kernel forward's pre-activations:
    ``dense_stack_grads_ref``), and bitwise-equal across two calls."""
    import torch
    from repro_torch.kernels.dense_block import stack
    shapes = (("ragged", 5, 7, 40, 3),) + TRAIN_NETS + RAGGED_RT
    worst = 0.0
    for conn in stack.FUSED_CONNECTIVITIES:
        for act in ("swish", "relu", "tanh", "identity"):
            for name, m, d0, u, L in shapes:
                x, ws, bs = stack_inputs(conn, L, d0, u, m, gen)
                g = torch.randn((m, stack.feature_dim(conn, L, d0, u)),
                                generator=gen, device="cuda")
                before = stack.bwd_launch_count()
                got = stack_grads(stack, x, ws, bs, g, conn, act)
                again = stack_grads(stack, x, ws, bs, g, conn, act)
                if stack.bwd_launch_count() - before != 2:
                    raise AssertionError("backward did not go through the "
                                         "kernel")
                # relu's slope at the kernel forward's own pre-activations
                zs = torch.empty((m, L * u), device="cuda")
                stack._kernel_forward(x, ws, bs, conn, act, zs)
                want = stack.dense_stack_grads_ref(
                    x, ws, bs, g, connectivity=conn, activation=act, zs=zs)
                flat = lambda t: [t[0], *t[1], *t[2]]
                ok, err = grads_close(flat(got), flat(want))
                worst = max(worst, err)
                if not ok:
                    raise AssertionError(
                        f"backward kernel != plain: {conn}/{act} {name} "
                        f"M={m} d0={d0} U={u} L={L}: max abs err {err:.3e}")
                if not all(torch.equal(a, b)
                           for a, b in zip(flat(got), flat(again))):
                    raise AssertionError(f"backward not bitwise repeatable:"
                                         f" {conn}/{act} {name}")
    log(f"[parity] dense_stack backward == plain (dx, dW, db): 3 "
        f"connectivities x 4 activations x {len(shapes)} shapes, max abs "
        f"err {worst:.3e}; two calls bitwise equal")
    return worst


def tree_case(gen, capacity=100_000):
    """A full tree at the replay's capacity with priorities in (0, 2)."""
    import torch
    from repro_torch.kernels.replay_tree import ops, ref
    tree = ops.sumtree_init(capacity, "cuda")
    pr = (torch.rand((capacity,), generator=gen, device="cuda") * 2
          + 1e-3)
    ref.tree_set_ref(tree, torch.arange(capacity, device="cuda"), pr)
    return tree


def phase_tree_parity(gen, capacity=100_000):
    """Sample and write kernels against the plain versions at capacity
    100,000: sample at B=256 with the edge targets 0 and total; write at
    n=32, n=256 with duplicates and siblings, n=9,984 and n=100,000 with
    repeats (98 of the kernel's 1,024-entry passes, in order), bitwise;
    then a write with indices outside the leaves, which the card skips
    and counts (``ops.skipped_writes``): the count must rise by exactly
    their number and the tree be the plain write of the rest."""
    import torch
    from repro_torch.kernels.replay_tree import ops, ref
    tree = tree_case(gen, capacity)
    total = tree[1]
    t = torch.rand((256,), generator=gen, device="cuda") * total
    t[0], t[1] = 0.0, total
    before = ops.launch_count("sample")
    leaf, pri = ops.sumtree_sample(tree, t, capacity=capacity)
    if ops.launch_count("sample") - before != 1:
        raise AssertionError("tree_sample did not launch")
    want = ref.tree_sample_ref(tree, t, capacity=capacity)
    if not torch.equal(leaf, want) or not torch.equal(
            pri, ref.tree_get_ref(tree, want)):
        raise AssertionError("tree_sample kernel != plain")
    cases = []
    for n in (32, 256, 9984):
        idx = torch.randperm(capacity, generator=gen, device="cuda")[:n]
        cases.append((f"n={n} unique", idx))
    dup = torch.randint(0, capacity, (128,), generator=gen, device="cuda")
    sib = dup ^ 1                           # the sibling of every leaf
    idx = torch.cat([dup, sib])[torch.randperm(256, generator=gen,
                                               device="cuda")]
    idx[200:] = idx[:56]                    # repeated indices
    cases.append(("n=256 dup+siblings", idx.clamp(max=capacity - 1)))
    cases.append(("n=100,000 with repeats", torch.randint(
        0, capacity, (100_000,), generator=gen, device="cuda")))
    worst = 0.0
    for name, idx in cases:
        val = torch.rand(idx.shape, generator=gen, device="cuda") * 2
        got, want = tree.clone(), tree.clone()
        before = ops.launch_count("set")
        ops.sumtree_set(got, idx, val)
        if ops.launch_count("set") - before != 1:
            raise AssertionError("tree_set did not launch")
        ref.tree_set_ref(want, idx, val)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise AssertionError(f"tree_set {name}: not bitwise the plain "
                                 f"version (max abs err {err:.3e})")
    half = tree.shape[0] // 2
    idx = torch.randint(0, capacity, (300,), generator=gen, device="cuda")
    idx[::50] = torch.tensor([-1, half, half + 7, -half, 1 << 30, -5],
                             device="cuda")
    valid = (idx >= 0) & (idx < half)
    val = torch.rand(idx.shape, generator=gen, device="cuda") * 2
    before = ops.skipped_writes("cuda")
    got = ops.sumtree_set(tree.clone(), idx, val)
    skipped = ops.skipped_writes("cuda") - before
    same = torch.equal(got, ref.tree_set_ref(tree.clone(), idx[valid],
                                             val[valid]))
    if skipped != int((~valid).sum()) or not same:
        raise AssertionError(f"tree_set with {int((~valid).sum())} indices "
                             f"outside the leaves: {skipped} skipped; the "
                             f"rest bitwise the plain write: {same}")
    log(f"[parity] tree_sample == plain (B=256, edge targets 0 and total);"
        f" tree_set == plain bitwise for unique n in (32, 256, 9984), at "
        f"n=256 with duplicates+siblings and at n=100,000 with repeats "
        f"(keep-last); {skipped} indices outside the leaves skipped and "
        f"counted")
    return worst


def perturb_biases(params, gen):
    """Every dense bias gets N(0, 0.05^2) (``dense_init`` zeroes them)."""
    import torch
    if isinstance(params, dict):
        for k, v in params.items():
            if k == "b" and isinstance(v, torch.Tensor):
                v.add_(0.05 * torch.randn(v.shape, generator=gen,
                                          device=v.device))
            else:
                perturb_biases(v, gen)
    elif isinstance(params, list):
        for v in params:
            perturb_biases(v, gen)


def phase_main_path(spec, acfg):
    import torch
    from repro_torch.kernels.dense_block import stack
    from repro_torch.launch.serve_policy import PolicyServer, ServeConfig
    from repro_torch.rl import sac
    from repro_torch.rl.policy import Policy, save_params

    def init(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = sac.sac_init(acfg, gen, device="cuda")["params"]
        perturb_biases(params, gen)
        return params

    params = init(0)
    n_actor = sum(l["dense"]["w"].numel()
                  for l in params["actor"]["layers"])
    ckpt_dir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "fig10_large.npz")
    t0 = time.perf_counter()
    save_params(path, spec, params)
    pol = Policy.from_checkpoint(path)
    log(f"[main] fig10-ablation large: actor stack {n_actor} fp32 weights; "
        f"checkpoint save+load {time.perf_counter() - t0:.2f}s, "
        f"{os.path.getsize(path) / 1e6:.1f} MB")
    os.remove(path)
    os.remove(path + ".meta.json")
    for a, b in zip(_leaves(params), _leaves(pol.params)):
        if not torch.equal(a, b):
            raise AssertionError("checkpoint round trip changed a leaf")
    # launches a tick by kernel: phi_s whole (one launch), the actor's
    # layers on the streaming kernel (every slot is at most 32 rows)
    tick_kinds = {}
    for blk in ([acfg.ofenet.state_block] if acfg.ofenet else []) \
            + [acfg.actor_block()]:
        kind = stack.fwd_kernel_of(stack.plan_fwd(
            32, blk.num_units, blk.in_dim, num_sms(),
            stack=(blk.in_dim, blk.num_layers))[0])
        tick_kinds[kind] = tick_kinds.get(kind, 0) + (
            1 if kind == "whole" else blk.num_layers)
    per_tick = sum(tick_kinds.values())

    deltas = []

    class CountingPolicy(Policy):
        """Records the stack kernel's launches of every tick's forward."""

        def act_deterministic(self, obs):
            before = stack.launch_count()
            out = super().act_deterministic(obs)
            deltas.append(stack.launch_count() - before)
            return out

    for slot in ServeConfig(max_batch=32).batch_slots:   # warm up
        pol.act_deterministic(np.zeros((slot, pol.obs_dim), np.float32))
    served = CountingPolicy(pol._core, pol.params, pol.device)
    server = PolicyServer(served, ServeConfig(max_batch=32)).start()
    rng = np.random.default_rng(0)

    def fire(obs_all, n_clients):
        out = [None] * len(obs_all)
        lock = threading.Lock()
        it = iter(range(len(obs_all)))

        def client():
            while True:
                with lock:
                    i = next(it, None)
                if i is None:
                    return
                t = server.submit_async(obs_all[i])
                out[i] = (t.result(timeout=120.0), t.generation)

        threads = [threading.Thread(target=client) for _ in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
            if t.is_alive():
                raise AssertionError("client thread hung")
        return out

    def check(out, obs_all, ref_params, gen_want, what):
        acts = np.stack([a for a, _ in out])
        gens = {g for _, g in out}
        if gens != {gen_want}:
            raise AssertionError(f"{what}: generations {gens} != "
                                 f"{{{gen_want}}}")
        if not np.all(np.isfinite(acts)) or np.abs(acts).max() > 1.0:
            raise AssertionError(f"{what}: actions not finite in [-1, 1]")
        ref = pol.with_params(ref_params).to("cpu").act_deterministic(
            obs_all).numpy()
        err = float(np.abs(acts - ref).max())
        if err > 1e-4:
            raise AssertionError(f"{what}: served != plain path, max abs "
                                 f"err {err:.3e}")
        return err

    obs_a = rng.standard_normal((256, pol.obs_dim)).astype(np.float32)
    stack.reset_launch_count()
    t0 = time.perf_counter()
    out_a = fire(obs_a, 8)
    wall = time.perf_counter() - t0
    launches = stack.launch_count()
    ticks = server.stats["ticks"]
    if not deltas or any(d != per_tick for d in deltas) \
            or launches != per_tick * ticks or launches == 0:
        raise AssertionError(f"stack launches per tick {sorted(set(deltas))}"
                             f" (want {per_tick}), total {launches} over "
                             f"{ticks} ticks")
    by_kind = {k: stack.launch_count(k) for k in stack.FWD_KERNELS}
    if any(by_kind[k] != n * ticks for k, n in tick_kinds.items()) \
            or sum(by_kind.values()) != launches or stack.transpose_count():
        raise AssertionError(f"serving launched {by_kind} over {ticks} ticks"
                             f" (want {tick_kinds} a tick), "
                             f"{stack.transpose_count()} transposes")
    err_a = check(out_a, obs_a, params, 0, "generation 0")
    hist = dict(sorted(server.stats["batch_hist"].items()))
    lat = np.asarray(server.stats["latencies_ms"])
    log(f"[main] 256 requests / 8 clients in {wall:.3f}s "
        f"({256 / wall:.0f} req/s), p50 {np.percentile(lat, 50):.2f} ms, "
        f"p99 {np.percentile(lat, 99):.2f} ms; {ticks} ticks, batch_hist "
        f"{hist}; stack launches {launches} = {per_tick}/tick ({tick_kinds} "
        f"by kernel); max abs err vs plain {err_a:.2e}")

    params_b = init(1)
    server.push_params(params_b)
    obs_b = rng.standard_normal((64, pol.obs_dim)).astype(np.float32)
    out_b = fire(obs_b, 4)
    server.close()
    err_b = check(out_b, obs_b, params_b, 1, "generation 1")
    if server.generation != 1 or server.stats["swaps"] != 1:
        raise AssertionError("hot-swap did not land exactly once")
    log(f"[main] push_params: 64 later requests all generation 1, max abs "
        f"err vs plain {err_b:.2e}")
    # the slot the served ticks padded to most often
    slot_hist = {}
    for n, c in hist.items():
        s = ServeConfig(max_batch=32).slot_for(n)
        slot_hist[s] = slot_hist.get(s, 0) + c
    return launches, max(slot_hist, key=slot_hist.get), pol


def phase_tick_profile(pol, slot, ticks=50):
    """Where one serving tick's time goes: wall clock per tick (H2D copy,
    forward, D2H copy, as ``PolicyServer`` runs it) against the device time
    ``torch.profiler`` sees, and the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    obs = np.random.default_rng(1).standard_normal(
        (slot, pol.obs_dim)).astype(np.float32)
    for _ in range(5):
        pol.act_deterministic(obs).cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(ticks):
        pol.act_deterministic(obs).cpu().numpy()
    wall_ms = 1e3 * (time.perf_counter() - t0) / ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            pol.act_deterministic(obs).cpu().numpy()
    # device-side events only (kernels, memcpys): the CPU op around a
    # ctypes launch also reports that kernel's time as its own
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / ticks
    log(f"[tick] slot {slot}: {wall_ms * 1e3:.1f} us wall per tick; device "
        f"busy {busy_ms * 1e3:.1f} us per tick (torch.profiler), idle share "
        f"{100 * (1 - busy_ms / wall_ms):.0f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[tick]   {e.self_device_time_total / ticks:8.1f} us/tick "
            f"{e.count / ticks:5.1f}x  {e.key[:90]}")
    if not events:
        log("[tick] the profiler saw no device time: busy share not measured")


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def time_ms(fn, copies, reps=20, repeats=5):
    """``(device_ms, host_ms)`` of one call, cycling ``fn`` over the weight
    copies. Device: median over ``repeats`` of the CUDA-event time of
    ``reps`` calls enqueued while the card is held busy (so the host's
    dispatch cost is not in it). Host: wall clock of ``reps`` calls and a
    synchronize, the rate a caller gets back to back."""
    import torch
    for c in copies:                         # warm up (and build)
        fn(c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(copies[i % len(copies)])
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / reps
    # hold the card ~3x the enqueue time (cycles at ~2 GHz, >= 5 ms)
    hold = int(2e6 * max(5.0, 3 * host_ms * reps))
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold)
        start.record()
        for i in range(reps):
            fn(copies[i % len(copies)])
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return float(np.median(samples)), host_ms


def device_kernels(fn, copies, calls=5):
    """``[(kernel name, us per call)]`` of the device kernels ``calls``
    calls of ``fn`` launch (``torch.profiler``), longest first: which
    library kernels a yardstick runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(copies[i % len(copies)])
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    return [(e.key, e.self_device_time_total / calls) for e in
            sorted(events, key=lambda e: -e.self_device_time_total)]


def time_stack(name, ws, bs, m, gen):
    """One densenet stack forward (swish) at M rows: the kernels, the plain
    version and the library yardstick (``addmm`` + ``silu`` per layer into
    a stream built once), each cycling its weights through copies larger
    than the 50 MB L2 (at most 64 copies: a narrow stack's stay in L2),
    beside the bound (the weight bytes and the stream read and written
    once at 3.35 TB/s, or the fp32 operations at 67 TFLOP/s)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.dense_block import stack
    d0, u, L = ws[0].shape[0], ws[0].shape[1], len(ws)
    wbytes = 4 * sum(w.numel() + b.numel() for w, b in zip(ws, bs))
    n_copies = min(64, max(2, math.ceil(120e6 / wbytes)))
    copies = [([w.clone() for w in ws], [b.clone() for b in bs])
              for _ in range(n_copies)]
    x = torch.randn((m, d0), generator=gen, device="cuda")
    feat = d0 + L * u
    stream = torch.empty((m, feat), device="cuda")

    def kernel(c):
        return stack.dense_stack(x, c[0], c[1])

    def plain(c):
        return stack.dense_stack_ref(x, c[0], c[1])

    def library(c):
        stream[:, :d0].copy_(x)
        for i, (w, b) in enumerate(zip(*c)):
            d = d0 + i * u
            stream[:, d:d + u] = F.silu(torch.addmm(b, stream[:, :d], w))
        return stream

    _, err = close_enough(kernel(copies[0]), plain(copies[0]))
    t_k, h_k = time_ms(kernel, copies)
    t_p, _ = time_ms(plain, copies)
    t_l, _ = time_ms(library, copies)
    t_k2, _ = time_ms(kernel, copies)
    flops = 2 * m * sum(w.shape[0] * w.shape[1] for w in ws)
    nbytes = wbytes + 4 * m * (d0 + feat)
    bound_ms, bound_by = _bound(nbytes, flops)
    r = dict(ms=min(t_k, t_k2), plain_ms=t_p, library_ms=t_l,
             bound_ms=bound_ms, max_abs_err=err, host_ms=h_k,
             bound_by=bound_by)
    kind = stack.fwd_kernel_of(stack.plan_fwd(m, u, d0, num_sms(),
                                              stack=(d0, L))[0])
    log(f"[time] {name} stack M={m:3d} d0={d0} U={u} L={L} ({kind}): "
        f"kernel {r['ms'] * 1e3:8.1f} us (runs {t_k * 1e3:.1f}/"
        f"{t_k2 * 1e3:.1f}), plain {t_p * 1e3:8.1f} us, library "
        f"{t_l * 1e3:8.1f} us ({'faster' if r['ms'] <= t_l else 'SLOWER'} "
        f"than it), bound {bound_ms * 1e3:6.1f} us ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
        f"{100 * bound_ms / r['ms']:.0f}% of bound, max abs err {err:.2e}")
    if name == "actor":
        seen = device_kernels(library, copies)[:4]
        log(f"[time]   library kernels at M={m}: " + ("; ".join(
            f"{us:.1f} us {key[:70]}" for key, us in seen)
            or "none seen by the profiler"))
    return r


def phase_times(params, gen):
    """The stack forward's times: the served actor (its weights) and the
    OFENet ``phi_s`` stack at every slot, the critic and ``phi_sa`` stacks
    at the training batch (random weights from the seed). Keys ``(stack,
    M)``."""
    actor = ([l["dense"]["w"] for l in params["actor"]["layers"]],
             [l["dense"]["b"] for l in params["actor"]["layers"]])
    rows = {}
    for m in SLOTS:
        rows[("actor", m)] = time_stack("actor", *actor, m, gen)
    _, ws, bs = stack_inputs("densenet", 2, 516, 2048, 256, gen)
    rows[("critic", 256)] = time_stack("critic", ws, bs, 256, gen)
    for m in SLOTS:
        _, ws, bs = stack_inputs("densenet", 4, 3, 64, m, gen)
        rows[("phi_s", m)] = time_stack("phi_s", ws, bs, m, gen)
    _, ws, bs = stack_inputs("densenet", 4, 260, 64, 256, gen)
    rows[("phi_sa", 256)] = time_stack("phi_sa", ws, bs, 256, gen)
    return rows


def expected_launches(tr):
    """Kernel launches of one training superstep, read off the code.

    Stack forwards: collect's ``sample_action`` (phi_s + actor) at the
    actor pool's rows; ``sac_update``, at the batch's: the aux loss (phi_s
    + phi_sa), the target's ``sample_action`` (phi_s + actor) and
    ``q_values`` (phi_s + phi_sa + q1 + q2), the critic loss's, the actor
    loss's and the priorities' ``q_values`` (4 nets each) and the actor
    loss's ``sample_action``: 24 calls, 13*Lo + 11*L layers, of which
    12*Lo + 10*L at the batch (7 phi_s calls, 5 phi_sa, 2 actor, 8
    critic). ``fwd_<kernel>`` counts launches by the kernel ``plan_fwd``
    gives each call: one a layer, but one a stack on the whole-stack
    kernel (phi_s and phi_sa at the batch); the actor and the critics take
    the register tile at 256 rows, every stack the streaming kernel at 32;
    ``fwd_t`` counts the register tile's stream^T inits, one per wide
    stack call (2 actor + 8 critic calls). Stack backwards: aux (phi_sa,
    phi_s), critic loss (q1, q2), actor loss (q1, q2, phi_sa for dx, the
    actor for dW): 8. Tree: one sample, two writes (the add, the priority
    refresh)."""
    from repro_torch.kernels.dense_block import stack
    acfg = tr.acfg
    want = {f"fwd_{k}": 0 for k in stack.FWD_KERNELS}
    want["fwd_t"] = 0
    layers = 0

    def calls(n, m, blk):
        nonlocal layers
        dense = blk.connectivity == "densenet"
        kind = stack.fwd_kernel_of(stack.plan_fwd(
            m, blk.num_units, blk.in_dim, num_sms(), transposed=dense,
            stack=(blk.in_dim, blk.num_layers) if dense else None)[0])
        want[f"fwd_{kind}"] += n * (1 if kind == "whole"
                                    else blk.num_layers)
        layers += n * blk.num_layers
        if kind == "rt":
            want["fwd_t"] += n
    lo = acfg.ofenet.num_layers if acfg.ofenet else 0
    if acfg.ofenet:
        phi_s, phi_sa = acfg.ofenet.state_block, acfg.ofenet.sa_block
        for n, m, blk in ((1, tr.n_actors, phi_s), (7, tr.batch_size, phi_s),
                          (5, tr.batch_size, phi_sa)):
            calls(n, m, blk)
    for n, m, blk in ((1, tr.n_actors, acfg.actor_block()),
                      (2, tr.batch_size, acfg.actor_block()),
                      (8, tr.batch_size, acfg.critic_block())):
        calls(n, m, blk)
    if layers != 13 * lo + 11 * acfg.num_layers:
        raise AssertionError(f"expected forward layers do not add up: "
                             f"{layers}, {want}")
    want["fwd"] = sum(want[f"fwd_{k}"] for k in stack.FWD_KERNELS)
    want.update(bwd=8 if lo else 5, sample=1, set=2)
    return want


def _counts():
    from repro_torch.kernels.dense_block import stack
    from repro_torch.kernels.replay_tree import ops
    return {"fwd": stack.launch_count(),
            **{f"fwd_{k}": stack.launch_count(k) for k in stack.FWD_KERNELS},
            "fwd_t": stack.transpose_count(),
            "bwd": stack.bwd_launch_count(),
            "sample": ops.launch_count("sample"),
            "set": ops.launch_count("set")}


def _reset_counts():
    from repro_torch.kernels.dense_block import stack
    from repro_torch.kernels.replay_tree import ops
    stack.reset_launch_count()
    ops.reset_launch_count()


def state_to(ls, device):
    """A copy of a TrainLoopState on ``device`` (its generator kept)."""
    from repro_torch.common import tree_map
    from repro_torch.rl.envs import EnvState
    mv = lambda t: t.detach().to(device).clone()
    return type(ls)(tree_map(mv, ls.agent), EnvState(*map(mv, ls.actors)),
                    None if ls.nstep is None else tree_map(mv, ls.nstep),
                    tree_map(mv, ls.replay), ls.gen, mv(ls.step))


TRAIN_KEYS = ("critic_loss", "actor_loss", "aux_loss", "alpha", "q_mean",
              "td_error", "staleness_mean")


def phase_train_parity(spec, exp):
    """One superstep on the card against the same superstep on the CPU
    plain path, from the same state with the same draws."""
    import torch
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.rl.runner import Trainer
    tr = exp.trainer
    draws = tr.draws(exp._ls.gen)
    t0 = time.perf_counter()
    card, cm, _ = tr.step(state_to(exp._ls, "cuda"), draws)
    cpu_tr = Trainer(spec, device="cpu")
    cpu, pm, _ = cpu_tr.step(state_to(exp._ls, "cpu"),
                             tree_map(lambda t: t.cpu(), draws))
    torch.cuda.synchronize()
    lr = tr.acfg.lr
    worst_mu = 0.0
    for name in cpu.agent["opt"]:
        ok, err = grads_close(
            [t.cpu() for t in tree_leaves(card.agent["opt"][name]["mu"])],
            tree_leaves(cpu.agent["opt"][name]["mu"]))
        worst_mu = max(worst_mu, err)
        if not ok:
            raise AssertionError(f"superstep card != CPU: opt/{name}/mu "
                                 f"(the gradients), max abs err {err:.3e}")
    diffs = torch.cat([(a.cpu() - b).abs().flatten() for a, b in zip(
        tree_leaves(card.agent["params"]), tree_leaves(cpu.agent["params"]))])
    p_max, p_frac = float(diffs.max()), float((diffs > 1e-6).float().mean())
    # one Adam step moves a weight by at most lr: two runs differ by < 2 lr
    if p_max > 2 * lr or p_frac > 1e-4:
        raise AssertionError(f"superstep card != CPU: params max abs err "
                             f"{p_max:.3e}, {p_frac:.2e} of them > 1e-6")
    for k in TRAIN_KEYS:
        ok, err = close_enough(cm[k].cpu(), pm[k], 1e-3)
        if not ok:
            raise AssertionError(f"superstep card != CPU: {k} "
                                 f"{float(cm[k]):.6g} vs {float(pm[k]):.6g}")
    ok, err_pr = close_enough(cm["priorities"].cpu(), pm["priorities"],
                              1e-3)
    # leaves (priorities near 1) and root (their sum) each on their own
    # scale: an atol set by the root would hide a wrong or missing leaf
    half, cap = cpu.replay["tree"].shape[0] // 2, tr.dcfg.capacity
    ok2, err_leaf = close_enough(card.replay["tree"][half:half + cap].cpu(),
                                 cpu.replay["tree"][half:half + cap], 1e-3)
    ok3, err_root = close_enough(card.replay["tree"][1:2].cpu(),
                                 cpu.replay["tree"][1:2], 1e-3)
    if not (ok and ok2 and ok3):
        raise AssertionError(f"superstep card != CPU: priorities "
                             f"{err_pr:.3e}, tree leaves {err_leaf:.3e}, "
                             f"root {err_root:.3e}")
    for k, v in cpu.replay["store"]["data"].items():
        ok, err = close_enough(card.replay["store"]["data"][k].cpu(), v,
                                   1e-4)
        if not ok:
            raise AssertionError(f"superstep card != CPU: store/{k} "
                                 f"{err:.3e}")
    log(f"[train] one superstep card vs CPU plain path, same state and "
        f"draws ({time.perf_counter() - t0:.1f}s): grads (AdamW mu) max abs "
        f"err {worst_mu:.2e} (rtol 1e-3 bar), params max abs err "
        f"{p_max:.2e} ({p_frac:.1e} of them > 1e-6; bar 2*lr), priorities "
        f"{err_pr:.2e}, tree leaves {err_leaf:.2e} and root {err_root:.2e} "
        f"(each rtol 1e-3 on its own scale), losses within 1e-3 "
        f"(critic {float(cm['critic_loss']):.5g} vs "
        f"{float(pm['critic_loss']):.5g})")


def phase_train(spec, steps=50, warm=10):
    """The training main path on the card: Experiment.from_spec(spec).run
    through Trainer's superstep, with per-superstep launch counts."""
    import torch
    from repro_torch.rl.experiment import Experiment
    from repro_torch.rl.policy import Policy
    from repro_torch.kernels.replay_tree import ops
    skipped = ops.skipped_writes("cuda")    # phase_tree_parity's
    exp = Experiment.from_spec(spec)
    tr = exp.trainer
    want = expected_launches(tr)
    t0 = time.perf_counter()
    exp._ensure_init()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rep = exp._ls.replay
    n_warm = int(rep["store"]["count"])
    warm_rows = max(spec.execution.warmup_steps // tr.n_actors, 1) \
        * tr.n_actors
    leaves = rep["tree"][rep["tree"].shape[0] // 2:]
    if n_warm != warm_rows or abs(float(rep["tree"][1])
                                  - float(leaves.sum())) > 1e-3 * n_warm:
        raise AssertionError(f"warm-up: {n_warm} rows (want {warm_rows}), "
                             f"tree total {float(rep['tree'][1])}")
    log(f"[train] fig10-ablation large, paper budget: {tr.n_params} params,"
        f" {tr.n_actors} actors, batch {tr.batch_size}, capacity "
        f"{tr.dcfg.capacity}; warm-up {n_warm} transitions in {t_init:.2f}s")
    phase_train_parity(spec, exp)

    per_step, scal = [], []
    step_fn = tr.step

    def counted(ls, draws=None):
        before = _counts()
        out = step_fn(ls, draws)
        after = _counts()
        per_step.append({k: after[k] - before[k] for k in after})
        scal.append(torch.stack([out[1][k] for k in TRAIN_KEYS]))
        return out

    tr.step = counted
    exp.run(warm)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    exp.run(steps - warm)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / (steps - warm)
    launches = _counts()
    bad = [c for c in per_step if c != want]
    if bad or any(launches[k] != want[k] * (steps - warm) for k in want) \
            or not all(launches[k] for k in want if want[k]):
        raise AssertionError(f"launches per superstep {bad[:2]} (want "
                             f"{want}), totals {launches}")
    vals = torch.stack(scal).cpu()
    if not torch.all(torch.isfinite(vals)):
        raise AssertionError("training produced a non-finite loss")
    skipped = ops.skipped_writes("cuda") - skipped
    if skipped:
        raise AssertionError(f"tree_set skipped {skipped} entries with an "
                             f"index outside the leaves")
    rep = exp._ls.replay
    count = int(rep["store"]["count"])
    leaves = rep["tree"][rep["tree"].shape[0] // 2:]
    total, lsum = float(rep["tree"][1]), float(leaves.sum())
    if count != min(n_warm + steps * tr.n_actors, tr.dcfg.capacity) \
            or abs(total - lsum) > 1e-4 * lsum or int(exp._ls.step) != steps:
        raise AssertionError(f"after {steps} supersteps: {count} rows, tree "
                             f"total {total} vs leaves {lsum}, step "
                             f"{int(exp._ls.step)}")
    last = dict(zip(TRAIN_KEYS, vals[-1].tolist()))
    log(f"[train] {steps} supersteps: {wall * 1e3:.2f} ms wall per "
        f"superstep (host clock, steps {warm + 1}-{steps}); launches per "
        f"superstep {want} on every one; last losses "
        + ", ".join(f"{k} {v:.4g}" for k, v in last.items())
        + f"; replay {count} rows, tree total {total:.6g} = sum of leaves "
        f"{lsum:.6g}; no tree_set entry skipped")
    pol = Policy.from_experiment(exp)
    obs = np.random.default_rng(2).standard_normal(
        (64, pol.obs_dim)).astype(np.float32)
    a = pol.act_deterministic(obs).cpu()
    ref = pol.to("cpu").act_deterministic(obs)
    err = float((a - ref).abs().max())
    if err > 1e-4 or not torch.all(a.abs() <= 1):
        raise AssertionError(f"trained policy: card != plain path "
                             f"({err:.3e})")
    log(f"[train] Policy.from_experiment on the trained params: 64 actions,"
        f" max abs err vs the CPU plain path {err:.2e}")
    return exp, launches


def bwd_product_class(key):
    """'dW', 'dx', 'act_grad' or None for a profiler kernel name: the
    register-tiled kernels by name (dx with the transpose of W it reads,
    act_grad with its db pass), dense_tile.cuh's by their layout template
    arguments (TA, TW): (true, false) for dW, (false, true) for dx."""
    if "act_grad_kernel" in key or "db_sum_kernel" in key:
        return "act_grad"
    if "dw_tile_kernel" in key or ("tile_kernel<" in key
                                   and "true, false>" in key):
        return "dW"
    if "dx_tile_kernel" in key or "transpose_kernel<false>" in key or (
            "tile_kernel<" in key and "false, true>" in key):
        return "dx"
    return None


def fwd_class(key):
    """The forward kernel class of a profiler kernel name, or None:
    'wide' (the register tile over stream^T), 'whole' (the whole-stack
    kernel), 'narrow' (dense_tile.cuh's forward: its layout template
    arguments are (false, false)), 'stream' (the weight-streaming kernel)
    or 'transpose' (the stream^T init, the copying case of dense_tile.cuh's
    transpose; the backward's W^T is the other)."""
    if "transpose_kernel<true>" in key:
        return "transpose"
    if "whole_stack_kernel<" in key:
        return "whole"
    if "stream_kernel<" in key:
        return "stream"
    if "fwd_tile_kernel" in key:
        return "wide"
    if "tile_kernel<" in key and "false, false>" in key and not any(
            t in key for t in ("dw_tile_kernel", "dx_tile_kernel")):
        return "narrow"
    return None


def tree_class(key):
    """'sample' or 'set' for the sum-tree kernels' profiler names."""
    for c in ("sample", "set"):
        if f"tree_{c}_kernel" in key:
            return c
    return None


def phase_train_profile(exp, steps=10):
    """Where a superstep's time goes: wall clock against the device time
    torch.profiler sees, and the kernels that take it. Returns the
    backward's product classes per superstep, ``{class: (ms, launches)}``,
    the int32 fills per superstep (``torch.zeros`` of int32: split
    counters were made so before), the forward's classes and the tree's
    (sample, set)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exp.run(steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    log(f"[train-prof] {wall_ms:.2f} ms wall per superstep under the "
        f"profiler; device busy {busy_ms:.2f} ms per superstep, idle share "
        f"{100 * (1 - busy_ms / wall_ms):.0f}%; "
        f"{sum(e.count for e in events) / steps:.0f} device ops/superstep")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[train-prof]   {e.self_device_time_total / steps / 1e3:8.3f} "
            f"ms/step {e.count / steps:6.1f}x  {e.key[:90]}")
    if not events:
        log("[train-prof] the profiler saw no device time: busy share not "
            "measured")
    classes = {c: [0.0, 0.0] for c in ("dW", "dx", "act_grad")}
    fwd = {c: [0.0, 0.0] for c in ("wide", "whole", "narrow", "stream",
                                   "transpose")}
    fills = 0.0
    tree = {"sample": [0.0, 0.0], "set": [0.0, 0.0]}
    for e in events:
        for table, c in ((classes, bwd_product_class(e.key)),
                         (fwd, fwd_class(e.key)),
                         (tree, tree_class(e.key))):
            if c is not None:
                table[c][0] += e.self_device_time_total / 1e3 / steps
                table[c][1] += e.count / steps
        if "FillFunctor<int>" in e.key:
            fills += e.count / steps
    log("[tree-prof] training superstep, sum-tree device time per "
        "superstep as the main path finds the tree (after the update "
        "streamed the weights): "
        + ", ".join(f"{c} {1e3 * ms:.2f} us over {n:.1f} launches"
                    for c, (ms, n) in tree.items()))
    log("[fwd-prof] training superstep, forward device time per superstep:"
        f" {sum(ms for ms, _ in fwd.values()):.3f} ms = "
        + ", ".join(f"{c} {ms:.3f} ms over {n:.1f} launches"
                    for c, (ms, n) in fwd.items())
        + f"; int32 fills (torch.zeros of int32, any op) {fills:.1f} per "
        f"superstep")
    return {c: tuple(v) for c, v in classes.items()}, fills, \
        {c: tuple(v) for c, v in fwd.items()}, \
        {c: tuple(v) for c, v in tree.items()}


def phase_fwd_fills(gen):
    """The int32 fills the stack forward itself issues (split counters
    once came from a ``torch.zeros`` per launch): ``torch.profiler`` over
    one forward with autograd of every stack the training path runs, at
    its batch and at the actor pool's 32 rows, and of the served actor and
    ``phi_s`` at every slot. Must be 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.dense_block import stack
    cases = [(name, mm, d0, u, L) for name, m, d0, u, L in TRAIN_NETS
             for mm in (m, 32)]
    cases += [(name, m, d0, u, L) for name, _, d0, u, L in TRAIN_NETS[::2]
              for m in SLOTS[:-1]]
    inputs = []
    for name, m, d0, u, L in cases:
        x, ws, bs = stack_inputs("densenet", L, d0, u, m, gen)
        inputs.append([t.requires_grad_(True) for t in (x, *ws, *bs)])
    planned = {stack.fwd_kernel_of(stack.plan_fwd(
        m, u, d0, num_sms(), stack=(d0, L))[0]) for _, m, d0, u, L in cases}
    torch.cuda.synchronize()
    before = {k: stack.launch_count(k) for k in stack.FWD_KERNELS}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for (name, m, d0, u, L), var in zip(cases, inputs):
            stack.dense_stack(var[0], var[1:1 + L], var[1 + L:])
        torch.cuda.synchronize()
    ran = {k: stack.launch_count(k) - before[k] for k in stack.FWD_KERNELS}
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    fills = sum(e.count for e in events if "FillFunctor<int>" in e.key)
    if not events or fills or not all(ran[k] for k in planned):
        raise AssertionError(f"stack forward: {fills} int32 fills over "
                             f"{len(cases)} calls (launches {ran}); the "
                             f"profiler saw {len(events)} device kernels")
    log(f"[fwd-prof] {len(cases)} stack forwards with autograd (every "
        f"training stack at 256 and 32 rows, actor and phi_s at slots "
        f"{SLOTS[:-1]}; launches {ran}): 0 int32 fills")


def _bound(nbytes, flops):
    """``(bound_ms, "bytes" or "operations")`` at 3.35 TB/s and fp32
    67 TFLOP/s."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bwd_breakdown(name, x, ws, out, zs, g):
    """Each layer's products of a densenet stack backward (swish), timed
    alone, one line each: ``act_grad`` (gz, gz^T and the per-row-block
    sums; beside gz, db and gz^T in plain torch ops), its second pass
    ``db``, dW_i, the transpose of W_i that dx reads (beside
    ``W.t().contiguous()``), and dx_i (the transpose included, added into
    the gradient stream); the products with both register-tiled shapes
    (128x128 and 128x64) and the one ``plan_bwd`` picks, beside
    ``torch.mm`` of the same shape, the bound and the share of it reached.
    Returns the records."""
    import torch
    from repro_torch.kernels.dense_block import stack
    m, d0 = x.shape
    u, L = ws[0].shape[1], len(ws)
    bw = stack._Backward(m, u, "swish", x.device)
    feat = g.shape[1]                   # the stream of _kernel_backward
    gb = torch.empty((m, stack._pad4(feat)), device=x.device)[:, :feat]
    gb.copy_(g)
    shape_name = {c: f"{bm}x{bn}" for c, (bm, bn, _) in
                  stack._RT_CONFIGS.items()}
    recs = []

    def add(layer, product, shape, ms, mm_ms, nbytes, flops, configs=None,
            plan=None):
        bound, by = _bound(nbytes, flops)
        rec = dict(layer=layer, product=product, shape=shape, ms=ms,
                   mm_ms=mm_ms, bound_ms=bound, bound_by=by,
                   configs=configs, plan=plan)
        alt = "" if configs is None else " (" + ", ".join(
            f"{c} {v * 1e3:.1f}" for c, v in configs.items()) + \
            f"; plan {list(plan)})"
        log(f"[bwd-prod] {name} layer {layer} {product:8s} {shape:>18s}: "
            f"kernel {ms * 1e3:7.1f} us{alt}; "
            f"{'torch' if configs is None else 'torch.mm'} "
            f"{mm_ms * 1e3:7.1f} us; bound {bound * 1e3:6.1f} us ({by}), "
            f"{100 * bound / ms:.0f}% of bound")
        recs.append(rec)

    for i in reversed(range(L)):
        k = d0 + i * u
        zi, gi = zs[:, i * u:(i + 1) * u], gb[:, k:k + u]

        def plain_act_grad(_):
            sg = torch.sigmoid(zi)
            gzp = gi * (sg * (1 + zi * (1 - sg)))
            return gzp, gzp.sum(0), gzp.t().contiguous()
        gz, gzt, part = bw.act_grad(gb, k, zs, i, True, True)
        add(i, "act_grad", f"({m}, {u})",
            time_ms(lambda _: bw.act_grad(gb, k, zs, i, True, True), [0])[0],
            time_ms(plain_act_grad, [0])[0],
            4 * (4 * m * u + stack._ACT_ROW_BLOCKS * u), 0)
        db = torch.empty((u,), device=x.device)
        add(i, "db", f"({stack._ACT_ROW_BLOCKS}, {u})",
            time_ms(lambda _: bw.db(part, db), [0])[0],
            time_ms(lambda _: part.sum(0), [0])[0],
            4 * (stack._ACT_ROW_BLOCKS + 1) * u, 0)

        dw = torch.empty((k, u), device=x.device)
        plan = stack.plan_bwd(k, u, m, bw.num_sms, vec=stack.vec_aligned(
            stack.operand(out)))
        cfgs = {shape_name[c]: time_ms(
            lambda _, c=c: bw.dw(out, 0, k, gz, dw, 0, config=c), [0])[0]
            for c in stack._RT_CONFIGS}
        inp = out[:, :k]
        add(i, "dW", f"({k}, {u}) K={m}", cfgs[shape_name[plan[0]]],
            time_ms(lambda _: torch.mm(inp.t(), gz), [0])[0],
            4 * (m * k + m * u + k * u), 2 * m * k * u, cfgs, plan)

        add(i, "W^T", f"({k}, {u})",
            time_ms(lambda _: bw.transpose(ws[i]), [0])[0],
            time_ms(lambda _: ws[i].t().contiguous(), [0])[0],
            4 * 2 * k * u, 0)
        plan = stack.plan_bwd(m, k, u, bw.num_sms, dx=True)
        cfgs = {shape_name[c]: time_ms(
            lambda _, c=c: bw.dinput(gz, gzt, ws[i], 0, k, gb, 0, True,
                                     config=c), [0])[0]
            for c in stack._RT_CONFIGS}
        add(i, "dx", f"({m}, {k}) K={u}", cfgs[shape_name[plan[0]]],
            time_ms(lambda _: torch.mm(gz, ws[i].t()), [0])[0],
            4 * (m * u + k * u + 2 * m * k), 2 * m * k * u, cfgs, plan)
    alone = [r for r in recs if r["product"] != "W^T"]   # inside dx's
    log(f"[bwd-prod] {name}: act_grad, db, dW and dx alone sum to "
        f"{sum(r['ms'] for r in alone) * 1e3:.1f} us (torch and torch.mm: "
        f"{sum(r['mm_ms'] for r in alone) * 1e3:.1f} us)")
    return recs


def phase_bwd_times(gen, profile_classes=None):
    """One full stack backward (dx, every dW and db) at the main path's
    M=256 for each net: the kernels, the plain version (autograd of the
    concat loop, backward only), and a cuBLAS yardstick (per layer: the
    swish derivative, ``mm`` for dW, ``sum`` for db, ``addmm_`` into the
    gradient stream), beside the bound (fp32 operations of dW + dx at
    67 TFLOP/s vs the bytes at 3.35 TB/s). Then each product of the
    critic and the actor on its own (``bwd_breakdown``), and the training
    profile's device time per superstep of the three product classes."""
    import torch
    from repro_torch.kernels.dense_block import stack
    rows = {}
    for name, m, d0, u, L in TRAIN_NETS:
        x, ws, bs = stack_inputs("densenet", L, d0, u, m, gen)
        feat = d0 + L * u
        g = torch.randn((m, feat), generator=gen, device="cuda")
        zs = torch.empty((m, L * u), device="cuda")
        out = stack._kernel_forward(x, ws, bs, "densenet", "swish", zs)
        need = [True] * L

        def kernel(_):
            return stack._kernel_backward((out, zs), ws, g, "densenet",
                                          "swish", True, need, need)
        var = [t.detach().requires_grad_(True) for t in (x, *ws, *bs)]
        pout = stack.dense_stack_ref(var[0], var[1:1 + L], var[1 + L:])

        def plain(_):
            return torch.autograd.grad(pout, var, g, retain_graph=True)

        def library(_):
            gb = g.clone()
            for i in reversed(range(L)):
                k = d0 + i * u
                z = zs[:, i * u:(i + 1) * u]
                sg = torch.sigmoid(z)
                gz = gb[:, k:k + u] * (sg * (1 + z * (1 - sg)))
                torch.mm(out[:, :k].t(), gz)
                gz.sum(0)
                gb[:, :k].addmm_(gz, ws[i].t())
            return gb
        got = kernel(0)
        want = stack.dense_stack_grads_ref(x, ws, bs, g)
        _, err = grads_close([got[0], *got[1], *got[2]],
                             [want[0], *want[1], *want[2]])
        t_k, h_k = time_ms(kernel, [0])
        t_p, _ = time_ms(plain, [0])
        t_l, _ = time_ms(library, [0])
        t_k2, _ = time_ms(kernel, [0])
        ksum = sum(w.shape[0] * w.shape[1] for w in ws)
        flops = 4 * m * ksum
        nbytes = 4 * (2 * m * feat + m * L * u + 2 * ksum + L * u + m * d0)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
        bound_ms = 1e3 * max(t_bytes, t_ops)
        rows[name] = dict(ms=min(t_k, t_k2), plain_ms=t_p, library_ms=t_l,
                          bound_ms=bound_ms, max_abs_err=err, host_ms=h_k,
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations")
        r = rows[name]
        log(f"[time] backward {name} M={m} d0={d0} U={u} L={L}: kernel "
            f"{r['ms'] * 1e3:8.1f} us (runs {t_k * 1e3:.1f}/"
            f"{t_k2 * 1e3:.1f}), plain {t_p * 1e3:8.1f} us, library "
            f"{t_l * 1e3:8.1f} us, bound {bound_ms * 1e3:6.1f} us "
            f"({r['bound_by']}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
            f"GFLOP), {100 * bound_ms / r['ms']:.0f}% of bound, max abs err "
            f"{err:.2e}")
        if name in ("critic", "actor"):
            r["products"] = bwd_breakdown(name, x, ws, out, zs, g)
    if profile_classes is not None:
        classes, fills = profile_classes[:2]
        log("[bwd-prof] training superstep, device time per superstep: "
            + ", ".join(f"{c} {ms:.3f} ms over {n:.1f} launches"
                        for c, (ms, n) in classes.items())
            + f"; int32 fills {fills:.1f} (none from the stack: "
            f"[fwd-prof])")
    return rows


def _tree_nodes(tree, leaves):
    """Distinct tree nodes the write of ``leaves`` touches (leaf level
    up to the root)."""
    import torch
    node = torch.unique(leaves.long() + tree.shape[0] // 2)
    n = 0
    while node.numel():
        n += node.numel()
        node = torch.unique(node // 2)
        node = node[node >= 1]
    return n


def _sample_rounds(depth, k, top):
    """Dependent global rounds of one sample at this plan: the staged top
    (one coalesced load, beside the targets'), then k levels a round."""
    staged = min(top, depth)
    return -(-(depth - max(staged, 1)) // k) + (staged > 0)


def _write_rounds(n, depth, tile=1024):
    """Dependent global rounds of one write (a model of the kernel's
    schedule, for the floor in the log): for each pass of ``tile``
    entries, their load, then a round a level above the leaves."""
    return -(-n // tile) * depth


def phase_tree_times(gen, capacity=100_000, b=256):
    """The sample at B=256 and the write at n=32/256/9,984 on a full tree
    of the replay's capacity: kernel, plain version, and for the sample
    the library yardstick ``searchsorted(cumsum(leaves), targets,
    right=True)`` (the same function up to rounding); the write has no
    one-call library counterpart. Each kernel hot (``time_ms``, back to
    back, the tree in L2; and per call, between its own events) and cold
    (per call, right after a 128 MB write evicted the L2). Bounds: bytes
    (the nodes this data touches, read or written once) at 3.35 TB/s;
    both kernels are bound by the latency of their dependent memory
    rounds instead, so beside it the floor: an empty kernel plus the
    plan's dependent rounds times one load's latency (L2 hot, device
    memory cold; ``bwd_sweep.latency_floor``)."""
    import torch
    from repro_torch.kernels.replay_tree import ops, ref
    from repro_torch.launch.bwd_sweep import (l2_flusher, latency_floor,
                                              time_per_call_us)
    lat = latency_floor()
    flush = l2_flusher("cuda")
    log(f"[time] latency floor: empty kernel {lat['empty_us']:.2f} us "
        f"(back to back, time_ms), one dependent load {lat['l2_ns']:.0f} ns "
        f"from L2, {lat['hbm_ns']:.0f} ns from device memory (1 MB "
        f"pointer chase)")

    def timed(kernel, rounds):
        t_k, h_k = time_ms(kernel, [0])
        return dict(ms=t_k, host_ms=h_k,
                    hot_call_ms=time_per_call_us(lambda: kernel(0)) / 1e3,
                    cold_ms=time_per_call_us(lambda: kernel(0), flush) / 1e3,
                    rounds=rounds,
                    floor_ms=(lat["empty_us"] + rounds * lat["l2_ns"] / 1e3)
                    / 1e3,
                    floor_cold_ms=(lat["empty_us"]
                                   + rounds * lat["hbm_ns"] / 1e3) / 1e3)

    def say(r):
        return (f"hot {r['ms'] * 1e3:.2f} us (per call "
                f"{r['hot_call_ms'] * 1e3:.2f}), cold "
                f"{r['cold_ms'] * 1e3:.2f} us; floor {r['rounds']} rounds: "
                f"{r['floor_ms'] * 1e3:.2f} us hot, "
                f"{r['floor_cold_ms'] * 1e3:.2f} cold")
    tree = tree_case(gen, capacity)
    half = tree.shape[0] // 2
    t = torch.rand((b,), generator=gen, device="cuda") * tree[1]
    depth = tree.shape[0].bit_length() - 1
    leaf_k, pri_k = ops.sumtree_sample(tree, t, capacity=capacity)
    leaf_p = ref.tree_sample_ref(tree, t, capacity=capacity)
    pri_p = ref.tree_get_ref(tree, leaf_p)
    err_s = max(float((leaf_k - leaf_p).abs().max()),
                float((pri_k - pri_p).abs().max()))
    if not (torch.equal(leaf_k, leaf_p) and torch.equal(pri_k, pri_p)):
        raise AssertionError(f"tree_sample B={b}: kernel != plain (max abs "
                             f"err over leaf and priority {err_s:.3e})")

    def kernel(_):
        return ops.sumtree_sample(tree, t, capacity=capacity)

    def plain(_):
        leaf = ref.tree_sample_ref(tree, t, capacity=capacity)
        return leaf, ref.tree_get_ref(tree, leaf)

    def library(_):
        return torch.searchsorted(torch.cumsum(tree[half:half + capacity],
                                               0), t, right=True)
    lib_leaf = torch.clamp(library(0), max=capacity - 1)
    agree = float((lib_leaf == leaf_k.long()).float().mean())
    k, lanes, top = ops.SAMPLE_PLAN
    r = timed(kernel, _sample_rounds(depth, k, top))
    t_p, _ = time_ms(plain, [0])
    t_l, _ = time_ms(library, [0])
    nbytes = 4 * b * (depth - 1) + 4 * b + 8 * b
    rows = {"sample": dict(
        r, plain_ms=t_p, library_ms=t_l,
        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
        max_abs_err=err_s)}
    log(f"[time] tree_sample B={b}, capacity {capacity}, plan "
        f"{ops.SAMPLE_PLAN}: max abs err vs plain {err_s:.3e} (leaf and "
        f"priority); kernel {say(r)}; plain {t_p * 1e3:.1f} us, library "
        f"(searchsorted over cumsum) {t_l * 1e3:.1f} us (same leaf for "
        f"{100 * agree:.1f}% of targets; float sums round differently), "
        f"bytes bound {1e9 * nbytes / HBM_BYTES_PER_S:.2f} ns ({nbytes} B)")
    for n in (256, 32, 9984):
        if n == 256:       # the priority refresh: sampled leaves, repeats
            idx = ops.sumtree_sample(tree, torch.rand(
                (n,), generator=gen, device="cuda") * tree[1],
                capacity=capacity)[0]
        else:
            idx = torch.randperm(capacity, generator=gen,
                                 device="cuda")[:n].to(torch.int32)
        val = torch.rand((n,), generator=gen, device="cuda") + 0.5
        got = ops.sumtree_set(tree.clone(), idx, val)
        want = ref.tree_set_ref(tree.clone(), idx, val)
        err_w = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"tree_set n={n}: kernel != plain (max abs "
                                 f"err {err_w:.3e})")
        work = tree.clone()

        def wkernel(_):
            return ops.sumtree_set(work, idx, val)

        def wplain(_):
            return ref.tree_set_ref(work, idx, val)
        r = timed(wkernel, _write_rounds(n, depth))
        t_p, _ = time_ms(wplain, [0])
        touched = _tree_nodes(tree, idx)
        nbytes = 8 * n + 4 * touched
        log(f"[time] tree_set n={n}, pdl {ops.PDL}: max abs err vs "
            f"plain {err_w:.3e} ({len(torch.unique(idx))} distinct leaves);"
            f" kernel {say(r)}; plain {t_p * 1e3:.1f} us, library none, "
            f"bytes bound {1e9 * nbytes / HBM_BYTES_PER_S:.2f} ns "
            f"({touched} nodes touched)")
        rows[f"set{n}"] = dict(r, plain_ms=t_p, library_ms=None,
                               bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                               bound_by="bytes", max_abs_err=err_w)
    return rows


def _rand_segments(gen, widths, m, n, dtype, bias=True):
    """Parts (M, k_i), a fan-in scaled W (sum k_i, N) and a bias, on the
    card in ``dtype``."""
    import torch
    k = sum(widths)
    parts = [torch.randn((m, w), generator=gen, device="cuda").to(dtype)
             for w in widths]
    w = (torch.randn((k, n), generator=gen, device="cuda")
         / math.sqrt(k)).to(dtype)
    b = (0.1 * torch.randn((n,), generator=gen, device="cuda")).to(dtype) \
        if bias else None
    return parts, w, b


# dtype -> the bar of |kernel - plain| (rtol, and atol rtol * max|plain|)
NEW_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# full shapes: the paper's Ant DenseNet layer 3 (Table 2); flash and SSD at
# the sizes of the reference kernels' own docstrings and defaults
DENSE_FULL = dict(m=256, widths=(111, 2048, 2048), n=2048)
FLASH_FULL = dict(b=2, s=2048, h=16, kv=4, hd=64)
SSD_FULL = dict(b=2, s=2048, h=16, p=64, n=64, chunk=256)


def phase_dense_parity(gen):
    """fused_dense / dense_concat_matmul against the plain version: 1, 2 and
    3 segments, with and without bias, every activation, float32 and
    bfloat16, at ragged small shapes and at the full ones."""
    import torch
    from repro_torch.kernels.dense_block import dense_block, ops, ref
    m, n = DENSE_FULL["m"], DENSE_FULL["n"]
    shapes = [((13,), 33, 70), ((7, 30), 33, 70), ((5, 11, 21), 33, 70),
              ((111 + 2048 + 2048,), m, n), ((111, 2048), 64, 256),
              (DENSE_FULL["widths"], m, n)]
    worst = {}
    for dname, rtol in NEW_RTOL.items():
        dtype = getattr(torch, dname)
        for widths, mm, nn in shapes:
            for bias in (True, False):
                parts, w, b = _rand_segments(gen, widths, mm, nn, dtype, bias)
                for act in sorted(dense_block.ACT_CODE):
                    before = dense_block.launch_count()
                    got = ops.dense_concat_matmul(parts, w, b, activation=act)
                    if dense_block.launch_count() - before != 1:
                        raise AssertionError("dense_concat_matmul did not "
                                             "launch once")
                    want = ref.dense_concat_matmul_ref(parts, w, b, act)
                    ok, err = close_enough(got.float(), want.float(), rtol)
                    worst[dname] = max(worst.get(dname, 0.0), err)
                    if not ok:
                        raise AssertionError(
                            f"fused_dense kernel != plain: {dname} parts "
                            f"{widths} M={mm} N={nn} bias={bias} {act}: max "
                            f"abs err {err:.3e}")
    # 3xTF32's agreement at the Ant layer (identity, no bias: the product
    # alone) with the fp32 plain version and with a float64 product
    parts, w, _ = _rand_segments(gen, DENSE_FULL["widths"], m, n,
                                 torch.float32, bias=False)
    got = ops.dense_concat_matmul(parts, w, activation="identity")
    want = ref.dense_concat_matmul_ref(parts, w, None, "identity")
    exact = torch.cat(parts, 1).double() @ w.double()
    _, err_plain = close_enough(got, want)
    err64 = float((got.double() - exact).abs().max())
    plain64 = float((want.double() - exact).abs().max())
    log(f"[parity] fused_dense == plain: 1/2/3 segments x bias/none x "
        f"{len(dense_block.ACT_CODE)} activations x {len(shapes)} shapes "
        f"(ragged M=33 N=70; K=4207 as 1 and 3 parts at M=256 N=2048; "
        f"[111|2048] at M=64 N=256), max abs err f32 (3xTF32) "
        f"{worst['float32']:.2e}, bf16 {worst['bfloat16']:.2e}; Ant layer "
        f"product alone: 3xTF32 vs fp32 plain {err_plain:.2e}, vs float64 "
        f"{err64:.2e} (fp32 plain vs float64 {plain64:.2e}, max|product| "
        f"{float(exact.abs().max()):.2f})")
    worst["ant_vs_fp64"] = err64
    return worst


def phase_flash_parity(gen):
    """flash_attention / gqa_flash against the plain versions: causal and
    not, window 32, softcap 50, GQA G=4, Sq != Skv, rows with no valid key
    (the mean of v), Sq and Skv at the 64-row and 64-key tiles' edges (63,
    65, 127, 129), head dims 40 and 100 (zero-padded k8 steps), windows
    across key-tile edges, GQA views whose row strides rule out 16-byte
    copies, in float32 and bfloat16, small and full shape (and hd=128 at
    S=2048, the path that holds q in shared memory); one launch a call."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops, ref
    flat = ((100, 100, 32, True, 0, 0.0), (128, 256, 16, False, 0, 0.0),
            (128, 128, 64, True, 32, 0.0), (64, 64, 32, True, 0, 50.0),
            (200, 130, 128, False, 32, 50.0), (128, 64, 32, True, 16, 0.0),
            (63, 65, 40, True, 0, 0.0), (129, 127, 100, True, 0, 0.0),
            (65, 2048, 64, False, 0, 0.0), (2048, 129, 32, True, 0, 0.0),
            (300, 300, 100, True, 65, 0.0), (200, 70, 64, True, 30, 0.0))
    f = FLASH_FULL
    gqa = ((2, 96, 80, 8, 2, 32, True, 32, 0.0, 0),
           (f["b"], f["s"], f["s"], f["h"], f["kv"], f["hd"], True, 0, 0.0,
            0),
           (f["b"], f["s"], f["s"], f["h"], f["kv"], f["hd"], False, 0,
            50.0, 0),
           (1, f["s"], f["s"], f["h"], f["kv"], 128, True, 0, 0.0, 0),
           (2, 129, 200, 8, 2, 64, True, 0, 0.0, 3))
    worst = {}
    for dname, rtol in NEW_RTOL.items():
        dtype = getattr(torch, dname)
        rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(
            dtype)
        for sq, skv, d, causal, window, cap in flat:
            q, k, v = rnd(3, sq, d), rnd(3, skv, d), rnd(3, skv, d)
            before = fa.launch_count()
            got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=cap)
            if fa.launch_count() - before != 1:
                raise AssertionError("flash_attention did not launch once")
            want = ref.attention_ref(q, k, v, causal=causal, window=window,
                                     softcap=cap)
            ok, err = close_enough(got.float(), want.float(), rtol)
            worst[dname] = max(worst.get(dname, 0.0), err)
            if not ok:
                raise AssertionError(f"flash kernel != plain: {dname} Sq={sq}"
                                     f" Skv={skv} d={d} causal={causal} "
                                     f"window={window} softcap={cap}: {err:.3e}")
            first = skv + window - 1         # rows first.. see no key
            if window and first < sq:
                mean_v = v.float().mean(1, keepdim=True).expand(
                    -1, sq - first, -1)
                ok, err = close_enough(got[:, first:].float(), mean_v, rtol)
                if not ok:
                    raise AssertionError(f"flash rows with no valid key are "
                                         f"not the mean of v ({err:.3e})")
        for b, sq, skv, h, kvh, hd, causal, window, cap, pad in gqa:
            # pad > 0: views of rows hd + pad wide (no 16-byte copies)
            q, k, v = (rnd(*shape, hd + pad)[..., :hd] for shape in
                       ((b, sq, h), (b, skv, kvh), (b, skv, kvh)))
            before = fa.launch_count()
            got = ops.gqa_flash(q, k, v, causal=causal, window=window,
                                softcap=cap)
            if fa.launch_count() - before != 1:
                raise AssertionError("gqa_flash did not launch once")
            want = ref.plain_attention(q, k, v, causal=causal,
                                       window=window or None, attn_cap=cap)
            ok, err = close_enough(got.float(), want.float(), rtol)
            worst[dname] = max(worst.get(dname, 0.0), err)
            if not ok:
                raise AssertionError(f"gqa_flash kernel != plain: {dname} "
                                     f"B={b} S={sq}/{skv} H={h} KV={kvh} "
                                     f"hd={hd}: {err:.3e}")
    log(f"[parity] flash_attention == plain: {len(flat)} flat cases (causal "
        f"and not, window 32, softcap 50, Sq != Skv, rows with no valid key "
        f"= mean of v, tile edges 63/65/127/129, hd 40 and 100, windows "
        f"across key tiles) + {len(gqa)} GQA cases (G=4, the full B=2 S=2048 "
        f"H=16 KV=4 hd=64, hd=128 at S=2048, views without 16-byte rows), "
        f"one launch each, max abs err f32 {worst['float32']:.2e}, bf16 "
        f"{worst['bfloat16']:.2e}")
    return worst


def _ssd_chunk_inputs(gen, g, h, q, n, p, dtype):
    import torch
    import torch.nn.functional as F
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    c, b, x = rnd(g, q, n).to(dtype), rnd(g, q, n).to(dtype), \
        rnd(g, h, q, p).to(dtype)
    cum = torch.cumsum(-F.softplus(rnd(g, h, q)), -1)
    return c, b, x, cum, F.softplus(rnd(g, h, q)), rnd(g, h, p, n), rnd(h)


def _ssd_seq_inputs(gen, b, s, h, p, n):
    import torch
    import torch.nn.functional as F
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    return (rnd(b, s, h, p), rnd(b, s, n), rnd(b, s, n),
            F.softplus(rnd(b, s, h)), 0.3 * rnd(h), rnd(h))


def phase_ssd_parity(gen):
    """ssd_chunk_dual against the plain version at chunk 8 and 256 (and a
    ragged 100), float32 and bfloat16; the whole ssd_chunked_kernel
    against the plain ssd_chunked + D x at chunk 8 and 256."""
    import torch
    from repro_torch.kernels.ssd_scan import ops, ref, ssd_scan
    s = SSD_FULL
    chunks = ((4, 2, 8, 4, 16), (3, 2, 100, 24, 40),
              (s["b"] * s["s"] // 256, s["h"], 256, s["n"], s["p"]))
    worst = {}
    for dname, rtol in NEW_RTOL.items():
        dtype = getattr(torch, dname)
        for shape in chunks:
            args = _ssd_chunk_inputs(gen, *shape, dtype)
            got = ssd_scan.ssd_chunk_dual(*args)
            want = ref.ssd_chunk_dual_ref(*args)
            ok, err = close_enough(got.float(), want.float(), rtol)
            worst[dname] = max(worst.get(dname, 0.0), err)
            if not ok:
                raise AssertionError(f"ssd kernel != plain: {dname} (G, H, Q,"
                                     f" N, P)={shape}: {err:.3e}")
    for chunk in (8, 256):
        x, b, c, dt, log_a, d_skip = _ssd_seq_inputs(
            gen, s["b"], s["s"], s["h"], s["p"], s["n"])
        before = ssd_scan.launch_count()
        y, final = ops.ssd_chunked_kernel(x, b, c, dt, log_a, d_skip,
                                          chunk=chunk)
        if ssd_scan.launch_count() - before != 1:
            raise AssertionError("ssd_chunked_kernel did not launch once")
        y_p, f_p = ref.ssd_chunked(x, b, c, dt, log_a, chunk=chunk)
        y_p = y_p + d_skip[None, None, :, None] * x
        ok, err = close_enough(y, y_p)
        ok2, err2 = close_enough(final, f_p)
        worst["float32"] = max(worst["float32"], err)
        if not (ok and ok2):
            raise AssertionError(f"ssd_chunked_kernel != plain ssd_chunked + "
                                 f"D x at chunk {chunk}: y {err:.3e}, final "
                                 f"state {err2:.3e}")
    log(f"[parity] ssd_chunk_dual == plain at (G, H, Q, N, P) {chunks}; "
        f"ssd_chunked_kernel == plain ssd_chunked + D x (and final state) at "
        f"B=2 S=2048 H=16 P=N=64, chunk 8 and 256; max abs err f32 "
        f"{worst['float32']:.2e}, bf16 {worst['bfloat16']:.2e}")
    return worst


def phase_micro():
    """The port's kernel micro-benchmark, the path of the three kernels
    that no training or serving path runs: ``kernels_micro.run()`` with
    every count set to 0 just before; each row launches its kernel once
    per call."""
    from repro_torch.kernels.dense_block import dense_block
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import kernels_micro
    _reset_counts()
    for mod in (dense_block, flash_attention, ssd_scan):
        mod.reset_launch_count()
    rows = kernels_micro.run()
    counts = {"fused_dense": dense_block.launch_count(),
              "flash_attention": flash_attention.launch_count(),
              "ssd_chunk_dual": ssd_scan.launch_count()}
    for r, (kernel, n) in zip(rows, counts.items()):
        log(f"[micro] {r['name']}: {r['us_per_call']:.1f} us/call (CUDA "
            f"events), plain {r['ref_us']:.1f} us, {r['derived']}, "
            f"{r['launches']} launches / {r['calls']} calls ({kernel}), "
            f"{r['device']}")
        if r["launches"] != r["calls"] or n != r["calls"] \
                or r["maxerr"] > 1e-3:
            raise AssertionError(f"kernels_micro {r['name']}: {r['launches']}"
                                 f" launches for {r['calls']} calls ({n} "
                                 f"counted), maxerr {r['maxerr']:.3e}")
    if any(_counts().values()):
        raise AssertionError(f"kernels_micro launched a kernel of another "
                             f"path: {_counts()}")
    return counts


def _time_row(name, kernel, plain, library, copies, nbytes, flops, err,
              peak=FP32_FLOPS_PER_S):
    """Kernel, plain and library times beside the bound: ``nbytes`` at
    3.35 TB/s or ``flops`` at ``peak`` (fp32 outside the tensor cores
    unless the kernel's operations are of another type)."""
    t_k, h_k = time_ms(kernel, copies)
    t_p, _ = time_ms(plain, copies)
    t_l = None if library is None else time_ms(library, copies)[0]
    t_k2, _ = time_ms(kernel, copies)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    r = dict(ms=min(t_k, t_k2), plain_ms=t_p, library_ms=t_l,
             bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
             host_ms=h_k)
    lib = "none" if t_l is None else f"{t_l * 1e3:.1f} us"
    log(f"[time] {name}: kernel {r['ms'] * 1e3:.1f} us (runs "
        f"{t_k * 1e3:.1f}/{t_k2 * 1e3:.1f}), plain {t_p * 1e3:.1f} us, "
        f"library {lib}, bound {bound_ms * 1e3:.1f} us ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at "
        f"{peak / 1e12:.0f} TFLOP/s), {100 * bound_ms / r['ms']:.0f}% of "
        f"bound, max abs err {err:.2e}")
    return r


def phase_new_times(gen):
    """The three kernels at their full shapes, float32: kernel, plain
    version, library yardstick, bound. Fused dense: the Ant DenseNet layer
    3 with bias and swish, W cycled through copies larger than L2;
    library ``silu(addmm(b, x, W))`` on the concat already built. Flash:
    causal GQA at B=2 S=2048 H=16 KV=4 hd=64, float32 (bound 3 x the
    operations at the TF32 rate, the fp32 SIMT bound beside it) and
    bfloat16 (the operations at the bf16 rate); library: SDPA's GQA call
    pinned to the backend that takes q's dtype, math for float32, flash for
    bfloat16 (``bwd_sweep.sdpa_yardsticks``, named), and beside it the
    memory-efficient backend on K/V repeated to H heads outside the timed
    call; operations counted over the causal half. The fp32 SIMT bounds
    are logged, not recorded.
    SSD: one ``ssd_chunk_dual`` at
    B=2 S=2048 (G=16 cells) H=16 Q=256 N=P=64; no library call; C B^T
    counted once per cell (the heads share it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.dense_block import ops as dops
    from repro_torch.kernels.dense_block import ref as dref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import bwd_sweep
    rows = {}
    m, n, widths = DENSE_FULL["m"], DENSE_FULL["n"], DENSE_FULL["widths"]
    k = sum(widths)
    parts, w, b = _rand_segments(gen, widths, m, n, torch.float32)
    wbytes = 4 * (k * n + n)
    copies = [(w.clone(), b.clone())
              for _ in range(max(2, math.ceil(120e6 / wbytes)))]
    xcat = torch.cat(parts, 1)
    got = dops.dense_concat_matmul(parts, w, b)
    _, err = close_enough(got, dref.dense_concat_matmul_ref(parts, w, b))
    # the kernel does three TF32 tensor-core products for each fp32 one
    # (3xTF32): its bound is theirs; an fp32 SIMT product's beside it
    flops = 2 * m * k * n
    nbytes = 4 * (m * k + k * n + n + m * n)
    rows["fused_dense"] = r = _time_row(
        f"fused_dense M={m} parts {list(widths)} N={n} (swish, bias; "
        f"3xTF32)",
        lambda c: dops.dense_concat_matmul(parts, c[0], c[1]),
        lambda c: dref.dense_concat_matmul_ref(parts, c[0], c[1]),
        lambda c: F.silu(torch.addmm(c[1], xcat, c[0])), copies,
        nbytes, 3 * flops, err, peak=TF32_FLOPS_PER_S)
    log(f"[time]   fused_dense bounds: 3xTF32 tensor {r['bound_ms'] * 1e3:.1f}"
        f" us (3 x {flops / 1e9:.2f} GFLOP at 495 TFLOP/s), fp32 SIMT "
        f"{_bound(nbytes, flops)[0] * 1e3:.1f} us ({flops / 1e9:.2f} GFLOP at "
        f"67 TFLOP/s); kernel {r['ms'] * 1e3:.1f} us, silu(addmm) "
        f"{r['library_ms'] * 1e3:.1f} us ("
        f"{'faster' if r['ms'] <= r['library_ms'] else 'SLOWER'} than it)")

    f = FLASH_FULL
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    q = rnd(f["b"], f["s"], f["h"], f["hd"])
    kk, v = rnd(f["b"], f["s"], f["kv"], f["hd"]), \
        rnd(f["b"], f["s"], f["kv"], f["hd"])
    pairs = f["s"] * (f["s"] + 1) // 2             # causal (q, k) pairs
    flops = 4 * f["hd"] * pairs * f["b"] * f["h"]
    nbytes = 4 * f["b"] * f["s"] * f["hd"] * (2 * f["h"] + 2 * f["kv"])
    name = (f"gqa_flash B={f['b']} S={f['s']} H={f['h']} KV={f['kv']} "
            f"hd={f['hd']} causal")
    for dname, rtol in NEW_RTOL.items():
        dtype = getattr(torch, dname)
        qd, kd, vd = q.to(dtype), kk.to(dtype), v.to(dtype)
        _, err = close_enough(fops.gqa_flash(qd, kd, vd).float(),
                              fref.plain_attention(qd, kd, vd).float(), rtol)
        (lib, lib_fn), (rep_name, rep_fn) = bwd_sweep.sdpa_yardsticks(
            qd, kd, vd).items()
        # fp32: three TF32 products a pair on the tensor cores (3xTF32),
        # its bound theirs, an fp32 SIMT bound beside it; bf16: two TF32
        # products, against the card's bf16 tensor rate
        split = dname == "float32"
        r = _time_row(
            f"{name} {dname} ({'3xTF32' if split else 'TF32 x2'}; library "
            f"{lib})",
            lambda _: fops.gqa_flash(qd, kd, vd),
            lambda _: fref.plain_attention(qd, kd, vd), lib_fn, [0],
            nbytes // (1 if split else 2), 3 * flops if split else flops,
            err, peak=TF32_FLOPS_PER_S if split else BF16_FLOPS_PER_S)
        r["library"] = lib
        r["library_repeat_kv_ms"] = time_ms(rep_fn, [0])[0]
        line = (f"[time]   flash {dname}: kernel {r['ms'] * 1e3:.1f} us; "
                f"{lib} {r['library_ms'] * 1e3:.1f} us, {rep_name} "
                f"{r['library_repeat_kv_ms'] * 1e3:.1f} us; bound ")
        if split:
            rows["flash_attention"] = r
            log(line + f"3xTF32 tensor {r['bound_ms'] * 1e3:.1f} us (3 x "
                f"{flops / 1e9:.2f} GFLOP at 495 TFLOP/s), fp32 SIMT "
                f"{_bound(nbytes, flops)[0] * 1e3:.1f} us (at 67 TFLOP/s)")
        else:
            rows["flash_attention"]["bf16"] = r
            log(line + f"{r['bound_ms'] * 1e3:.1f} us ({flops / 1e9:.2f} "
                f"GFLOP at 989 TFLOP/s, bf16 tensor)")

    s = SSD_FULL
    g, qq = s["b"] * s["s"] // s["chunk"], s["chunk"]
    args = _ssd_chunk_inputs(gen, g, s["h"], qq, s["n"], s["p"],
                             torch.float32)
    _, err = close_enough(ssd_scan.ssd_chunk_dual(*args),
                          sref.ssd_chunk_dual_ref(*args))
    tri = qq * (qq + 1) // 2
    flops = g * 2 * s["n"] * tri + g * s["h"] * (
        2 * s["p"] * tri + 2 * qq * s["p"] * s["n"] + 2 * qq * s["p"])
    nbytes = 4 * (2 * g * qq * s["n"] + 2 * g * s["h"] * qq * s["p"]
                  + 2 * g * s["h"] * qq + g * s["h"] * s["p"] * s["n"]
                  + s["h"])
    rows["ssd_chunk_dual"] = _time_row(
        f"ssd_chunk_dual G={g} H={s['h']} Q={qq} N={s['n']} P={s['p']}",
        lambda _: ssd_scan.ssd_chunk_dual(*args),
        lambda _: sref.ssd_chunk_dual_ref(*args), None, [0], nbytes, flops,
        err)
    return rows


def build_all():
    """Build the six kernel libraries and the latency probe, one nvcc
    each, all at once."""
    from repro_torch.kernels import build_seconds
    from repro_torch.kernels.dense_block import dense_block, stack
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.replay_tree import ops
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import bwd_sweep
    builders = {"dense_stack_fwd": stack._library,
                "dense_stack_bwd": stack._bwd_library,
                "replay_tree": ops.library,
                "fused_dense": dense_block._library,
                "flash_attention": flash_attention._library,
                "ssd_scan": ssd_scan._library,
                "latency_probe": bwd_sweep._latency_library}
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:           # re-raised below, in this thread
            errors.append(e)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(f,))
               for f in builders.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    log(f"[build] " + ", ".join(f"{n} {build_seconds(n):.1f}s"
                                for n in builders)
        + f" (in parallel: {time.perf_counter() - t0:.1f}s)")


# the tree records' measured times beside the contract's: hot per call and
# cold (the modelled rounds and the floor stay in the [time] lines)
TREE_KEYS = ("hot_call_ms", "cold_ms")


def record(name, source, replaces, launches, r, shape, **extra):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "host_ms")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            **{k: r[k] for k in keys}, "shape": shape, **extra}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card; none is visible")
    from repro_torch.kernels.dense_block import stack
    from repro_torch.rl import presets
    from repro_torch.rl.envs import make_env
    from repro_torch.rl.policy import algo_config

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    build_all()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    phase_parity(gen)
    phase_backward_parity(gen)
    phase_tree_parity(gen)
    phase_dense_parity(gen)
    phase_flash_parity(gen)
    phase_ssd_parity(gen)

    spec = presets.get("fig10-ablation").override(
        **PAPER_BUDGET, num_units=2048, block_backend="fused")
    acfg = algo_config(spec, make_env(spec.env))
    _reset_counts()
    serve_launches, main_slot, pol = phase_main_path(spec, acfg)
    phase_tick_profile(pol, main_slot)

    train_spec = spec.override(replay_backend="device",
                               replay_kernel="pallas")
    exp, train_launches = phase_train(train_spec)
    profile_classes = phase_train_profile(exp)
    phase_fwd_fills(gen)
    micro_launches = phase_micro()

    rows = phase_times(pol.params, gen)
    bwd = phase_bwd_times(gen, profile_classes)
    tree = phase_tree_times(gen)
    new = phase_new_times(gen)
    r = rows[("actor", main_slot)]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")
    fwd_rec = record(
        "dense_stack_fwd",
        "src/repro_torch/kernels/dense_block/csrc/dense_stack_fwd.cu",
        "src/repro/kernels/dense_block/stack.py:315",
        train_launches["fwd"], r,
        f"actor stack d0=259 U=2048 L=2, M={main_slot} (the serving main "
        f"path's most used slot)",
        launches_by_path={"serve": serve_launches,
                          "train": train_launches["fwd"]},
        launches_by_kernel={k: train_launches[f"fwd_{k}"]
                            for k in stack.FWD_KERNELS},
        stream_t_inits=train_launches["fwd_t"],
        by_shape={f"{name} M={m}": {k: v[k] for k in keys}
                  for (name, m), v in rows.items()},
        profile_ms=dict(profile_classes[2]))
    print(json.dumps({"kernels": [
        fwd_rec,
        record("dense_stack_bwd",
               "src/repro_torch/kernels/dense_block/csrc/dense_stack_bwd.cu",
               "src/repro/kernels/dense_block/stack.py:334",
               train_launches["bwd"], bwd["critic"],
               "critic stack d0=516 U=2048 L=2, M=256: dx + dW + db"),
        record("tree_sample",
               "src/repro_torch/kernels/replay_tree/csrc/replay_tree.cu",
               "src/repro/kernels/replay_tree/replay_tree.py:36",
               train_launches["sample"], tree["sample"],
               "tree 2^18 nodes (capacity 100,000), B=256",
               **{k: tree["sample"][k] for k in TREE_KEYS},
               profile_ms=profile_classes[3]["sample"][0]),
        record("tree_set",
               "src/repro_torch/kernels/replay_tree/csrc/replay_tree.cu",
               "src/repro/kernels/replay_tree/replay_tree.py:87",
               train_launches["set"], tree["set256"],
               "tree 2^18 nodes, n=256 (the priority refresh)",
               also_replaces="src/repro/kernels/replay_tree/"
                             "replay_tree.py:127",
               **{k: tree["set256"][k] for k in TREE_KEYS},
               by_n={n: {k: tree[f"set{n}"][k] for k in ("ms", *TREE_KEYS)}
                     for n in (32, 9984)},
               profile_ms=profile_classes[3]["set"][0]),
        record("fused_dense",
               "src/repro_torch/kernels/dense_block/csrc/fused_dense.cu",
               "src/repro/kernels/dense_block/dense_block.py:36",
               micro_launches["fused_dense"], new["fused_dense"],
               f"M={DENSE_FULL['m']}, parts {list(DENSE_FULL['widths'])}, "
               f"N={DENSE_FULL['n']}, swish + bias (Ant DenseNet layer 3); "
               f"launches from kernels_micro.run(); 3xTF32 on the tensor "
               f"cores, bound_ms theirs"),
        record("flash_attention",
               "src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
               "src/repro/kernels/flash_attention/flash_attention.py:33",
               micro_launches["flash_attention"], new["flash_attention"],
               "gqa_flash B=2 S=2048 H=16 KV=4 hd=64 causal, float32; "
               "launches from kernels_micro.run(); 3xTF32 on the tensor "
               "cores, bound_ms theirs; bf16: the same shape in bfloat16",
               **{k: new["flash_attention"][k] for k in (
                   "library", "library_repeat_kv_ms")},
               bf16={k: new["flash_attention"]["bf16"][k] for k in (
                   "ms", "plain_ms", "library_ms", "library",
                   "library_repeat_kv_ms", "bound_ms", "bound_by",
                   "max_abs_err")}),
        record("ssd_chunk_dual",
               "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd_scan/ssd_scan.py:24",
               micro_launches["ssd_chunk_dual"], new["ssd_chunk_dual"],
               "G=16 H=16 Q=256 N=P=64 (B=2 S=2048 at chunk 256); launches "
               "from kernels_micro.run()"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
