#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing of JAX is imported):

1. Card and settings: the ``nvidia-smi`` name and power limit; TF32 off
   for matmul and cuDNN (the reference is fp32).
2. Build: compile the three CUDA sources from the checkout, one nvcc each,
   all at once (dense_stack_fwd.cu, dense_stack_bwd.cu, replay_tree.cu).
3. Kernels against their plain versions:
   - the stack forward for every fused connectivity x {swish, relu, tanh,
     identity}, at a ragged small shape and at the served model's shapes
     (OFENet ``phi_s`` and the actor stack) for M in {1, 32, 256}, with
     non-zero biases: |kernel - plain| <= 1e-4 * |plain| + 1e-4 *
     max|plain|;
   - the stack backward (dx, dW, db) for the same 12 cases at the ragged
     shape and at the four nets the training path differentiates at M=256
     (actor, critic, ``phi_s``, ``phi_sa``): within 1e-3 (rtol and
     atol * max), and two calls bitwise equal;
   - the sum-tree sample (B=256, edge targets 0 and total) and write
     (n=32, 256 with duplicates and siblings, 9,984) at capacity 100,000:
     bitwise equal to the plain versions.
4. Serving main path: the paper's "large" Fig. 10 SAC agent
   (``fig10-ablation`` at the paper budget, 2048 units, fused blocks,
   pendulum) is initialised on the card from a seed, saved with the port's
   checkpoint code, served through ``Policy.from_checkpoint`` +
   ``PolicyServer`` to 8 client threads (256 requests), checked against
   the plain path on the CPU, then hot-swapped to a second init. Every tick
   must launch the stack kernel once per layer it runs. One tick at the
   most used slot is timed and traced with ``torch.profiler``.
5. Training main path: the same agent with the device replay and its
   kernels (``replay_backend="device"``, ``replay_kernel="pallas"``)
   through ``Experiment.from_spec(spec).run``: the warm-up (9,984
   transitions), one superstep on the card against the same superstep on
   the CPU plain path (same state, same draws), then 50 supersteps with
   the launches of every superstep asserted (``expected_launches``),
   finite losses, a consistent replay count and tree total, and
   ``Policy.from_experiment`` checked against the plain path. Wall time
   per superstep and a ``torch.profiler`` breakdown.
6. Times at the main paths' shapes, each beside its plain version, a
   library yardstick the port never calls, and the least time the card
   could take (bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s,
   H100 SXM data sheet): the actor-stack forward at slots 1, 8, 32, 256
   (weights read cold); the full stack backward of each net at M=256; the
   tree sample at B=256 and write at n=32/256/9,984.
7. One JSON line of kernel records, then the device line, last.
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
# the paper budget of benchmarks/common.py (PAPER) + Fig. 10's large width
PAPER_BUDGET = dict(total_steps=1_000_000, warmup_steps=10_000,
                    eval_every=10_000, eval_episodes=10,
                    replay_capacity=100_000, batch_size=256,
                    ofenet_units=64, ofenet_layers=4)
SLOTS = (1, 8, 32, 256)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_parity(gen):
    from repro_torch.kernels.dense_block import stack
    shapes = [("ragged", 5, 7, 40, 3)]
    for m in (1, 32, 256):
        shapes += [("phi_s", m, 3, 64, 4), ("actor", m, 259, 2048, 2)]
    worst = 0.0
    for conn in stack.FUSED_CONNECTIVITIES:
        for act in ("swish", "relu", "tanh", "identity"):
            for name, m, d0, u, L in shapes:
                x, ws, bs = stack_inputs(conn, L, d0, u, m, gen)
                got = stack.dense_stack(x, ws, bs, connectivity=conn,
                                        activation=act)
                want = stack.dense_stack_ref(x, ws, bs, connectivity=conn,
                                             activation=act)
                ok, err = close_enough(got, want)
                worst = max(worst, err)
                if not ok:
                    raise AssertionError(
                        f"kernel != plain: {conn}/{act} {name} M={m} "
                        f"d0={d0} U={u} L={L}: max abs err {err:.3e}")
    log(f"[parity] dense_stack kernel == plain: 3 connectivities x 4 "
        f"activations x {len(shapes)} shapes, max abs err {worst:.3e}")
    return worst


# the nets whose stacks the training main path runs (name, M, d0, U, L)
TRAIN_NETS = (("actor", 256, 259, 2048, 2), ("critic", 256, 516, 2048, 2),
              ("phi_s", 256, 3, 64, 4), ("phi_sa", 256, 260, 64, 4))


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
    version, and bitwise-equal across two calls."""
    import torch
    from repro_torch.kernels.dense_block import stack
    shapes = (("ragged", 5, 7, 40, 3),) + TRAIN_NETS
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
                want = stack.dense_stack_grads_ref(
                    x, ws, bs, g, connectivity=conn, activation=act)
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
    n=32, n=256 with duplicates and siblings, n=9,984 (bitwise)."""
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
    log(f"[parity] tree_sample == plain (B=256, edge targets 0 and total);"
        f" tree_set == plain bitwise for unique n in (32, 256, 9984) and "
        f"at n=256 with duplicates+siblings (keep-last)")
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
    per_tick = (acfg.ofenet.num_layers if acfg.ofenet else 0) \
        + acfg.num_layers

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
    err_a = check(out_a, obs_a, params, 0, "generation 0")
    hist = dict(sorted(server.stats["batch_hist"].items()))
    lat = np.asarray(server.stats["latencies_ms"])
    log(f"[main] 256 requests / 8 clients in {wall:.3f}s "
        f"({256 / wall:.0f} req/s), p50 {np.percentile(lat, 50):.2f} ms, "
        f"p99 {np.percentile(lat, 99):.2f} ms; {ticks} ticks, batch_hist "
        f"{hist}; stack launches {launches} = {per_tick}/tick; max abs err "
        f"vs plain {err_a:.2e}")

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


def phase_times(params, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.dense_block import stack
    ws = [l["dense"]["w"] for l in params["actor"]["layers"]]
    bs = [l["dense"]["b"] for l in params["actor"]["layers"]]
    d0, u, L = ws[0].shape[0], ws[0].shape[1], len(ws)
    wbytes = 4 * sum(w.numel() + b.numel() for w, b in zip(ws, bs))
    n_copies = max(2, math.ceil(120e6 / wbytes))   # > 2x the 50 MB L2
    copies = [([w.clone() for w in ws], [b.clone() for b in bs])
              for _ in range(n_copies)]
    rows = {}
    for m in SLOTS:
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
        t_p, h_p = time_ms(plain, copies)
        t_l, h_l = time_ms(library, copies)
        t_k2, _ = time_ms(kernel, copies)
        flops = 2 * m * sum(w.shape[0] * w.shape[1] for w in ws)
        nbytes = wbytes + 4 * m * (d0 + feat)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
        bound_ms = 1e3 * max(t_bytes, t_ops)
        rows[m] = dict(ms=min(t_k, t_k2), plain_ms=t_p, library_ms=t_l,
                       bound_ms=bound_ms, max_abs_err=err, host_ms=h_k,
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
        r = rows[m]
        log(f"[time] actor stack M={m:3d}: kernel {r['ms'] * 1e3:8.1f} us "
            f"(runs {t_k * 1e3:.1f}/{t_k2 * 1e3:.1f}), plain "
            f"{t_p * 1e3:8.1f} us, library {t_l * 1e3:8.1f} us, bound "
            f"{bound_ms * 1e3:6.1f} us ({r['bound_by']}: {nbytes / 1e6:.1f}"
            f" MB, {flops / 1e9:.2f} GFLOP), {100 * bound_ms / r['ms']:.0f}%"
            f" of bound, max abs err {err:.2e}")
    return rows


def expected_launches(acfg):
    """Kernel launches of one training superstep, read off the code.

    Stack forwards (one launch per layer): collect's ``sample_action``
    (phi_s + actor); ``sac_update``: the aux loss (phi_s + phi_sa), the
    target's ``sample_action`` (phi_s + actor) and ``q_values`` (phi_s +
    phi_sa + q1 + q2), the critic loss's, the actor loss's and the
    priorities' ``q_values`` (4 nets each) and the actor loss's
    ``sample_action``: 24 calls, 13*Lo + 11*L layers. Stack backwards: aux
    (phi_sa, phi_s), critic loss (q1, q2), actor loss (q1, q2, phi_sa for
    dx, the actor for dW): 8. Tree: one sample, two writes (the add, the
    priority refresh)."""
    lo = acfg.ofenet.num_layers if acfg.ofenet else 0
    return {"fwd": 13 * lo + 11 * acfg.num_layers, "bwd": 8 if lo else 5,
            "sample": 1, "set": 2}


def _counts():
    from repro_torch.kernels.dense_block import stack
    from repro_torch.kernels.replay_tree import ops
    return {"fwd": stack.launch_count(), "bwd": stack.bwd_launch_count(),
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
    exp = Experiment.from_spec(spec)
    tr = exp.trainer
    want = expected_launches(tr.acfg)
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
    if bad or any(launches[k] != want[k] * (steps - warm) for k in want):
        raise AssertionError(f"launches per superstep {bad[:2]} (want "
                             f"{want}), totals {launches}")
    vals = torch.stack(scal).cpu()
    if not torch.all(torch.isfinite(vals)):
        raise AssertionError("training produced a non-finite loss")
    from repro_torch.kernels.replay_tree import ops
    if ops.skipped_writes("cuda"):
        raise AssertionError(f"tree_set skipped {ops.skipped_writes('cuda')}"
                             f" entries with an index outside the leaves")
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


def phase_train_profile(exp, steps=10):
    """Where a superstep's time goes: wall clock against the device time
    torch.profiler sees, and the kernels that take it."""
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


def phase_bwd_times(gen):
    """One full stack backward (dx, every dW and db) at the main path's
    M=256 for each net: the kernels, the plain version (autograd of the
    concat loop, backward only), and a cuBLAS yardstick (per layer: the
    swish derivative, ``mm`` for dW, ``sum`` for db, ``addmm_`` into the
    gradient stream), beside the bound (fp32 operations of dW + dx at
    67 TFLOP/s vs the bytes at 3.35 TB/s)."""
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


def phase_tree_times(gen, capacity=100_000, b=256):
    """The sample at B=256 and the write at n=32/256/9,984 on a full tree
    of the replay's capacity: kernel, plain version, and for the sample
    the library yardstick ``searchsorted(cumsum(leaves), targets,
    right=True)`` (the same function up to rounding); the write has no
    one-call library counterpart. Bounds: bytes (the nodes this data
    touches, read or written once) at 3.35 TB/s; both kernels are bound by
    the latency of the descent's dependent loads instead."""
    import torch
    from repro_torch.kernels.replay_tree import ops, ref
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
    t_k, h_k = time_ms(kernel, [0])
    t_p, _ = time_ms(plain, [0])
    t_l, _ = time_ms(library, [0])
    nbytes = 4 * b * (depth - 1) + 4 * b + 8 * b
    rows = {"sample": dict(
        ms=t_k, plain_ms=t_p, library_ms=t_l,
        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
        max_abs_err=err_s, host_ms=h_k)}
    log(f"[time] tree_sample B={b}, capacity {capacity}: max abs err vs "
        f"plain {err_s:.3e} (leaf and priority); kernel "
        f"{t_k * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, library "
        f"(searchsorted over cumsum) {t_l * 1e3:.1f} us (same leaf for "
        f"{100 * agree:.1f}% of targets; float sums round differently), "
        f"bytes bound {1e9 * nbytes / HBM_BYTES_PER_S:.2f} ns "
        f"({nbytes} B); bound in practice by {depth - 1} dependent loads")
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
        t_k, h_k = time_ms(wkernel, [0])
        t_p, _ = time_ms(wplain, [0])
        touched = _tree_nodes(tree, idx)
        nbytes = 8 * n + 4 * touched
        log(f"[time] tree_set n={n}: max abs err vs plain {err_w:.3e} "
            f"({len(torch.unique(idx))} distinct leaves); kernel "
            f"{t_k * 1e3:.1f} us, plain "
            f"{t_p * 1e3:.1f} us, library none, bytes bound "
            f"{1e9 * nbytes / HBM_BYTES_PER_S:.2f} ns ({touched} nodes "
            f"touched); bound in practice by {depth} dependent levels")
        rows[f"set{n}"] = dict(ms=t_k, plain_ms=t_p, library_ms=None,
                               bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                               bound_by="bytes", max_abs_err=err_w,
                               host_ms=h_k)
    return rows


def build_all():
    """Build the three kernel libraries, one nvcc each, all at once."""
    from repro_torch.kernels import build_seconds
    from repro_torch.kernels.dense_block import stack
    from repro_torch.kernels.replay_tree import ops
    builders = {"dense_stack_fwd": stack._library,
                "dense_stack_bwd": stack._bwd_library,
                "replay_tree": ops._library}
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

    spec = presets.get("fig10-ablation").override(
        **PAPER_BUDGET, num_units=2048, block_backend="fused")
    acfg = algo_config(spec, make_env(spec.env))
    _reset_counts()
    serve_launches, main_slot, pol = phase_main_path(spec, acfg)
    phase_tick_profile(pol, main_slot)

    train_spec = spec.override(replay_backend="device",
                               replay_kernel="pallas")
    exp, train_launches = phase_train(train_spec)
    phase_train_profile(exp)

    rows = phase_times(pol.params, gen)
    bwd = phase_bwd_times(gen)
    tree = phase_tree_times(gen)
    r = rows[main_slot]
    fwd_rec = record(
        "dense_stack_fwd",
        "src/repro_torch/kernels/dense_block/csrc/dense_stack_fwd.cu",
        "src/repro/kernels/dense_block/stack.py:315",
        train_launches["fwd"], r,
        f"actor stack d0=259 U=2048 L=2, M={main_slot} (the serving main "
        f"path's most used slot)",
        launches_by_path={"serve": serve_launches,
                          "train": train_launches["fwd"]})
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
               "tree 2^18 nodes (capacity 100,000), B=256"),
        record("tree_set",
               "src/repro_torch/kernels/replay_tree/csrc/replay_tree.cu",
               "src/repro/kernels/replay_tree/replay_tree.py:87",
               train_launches["set"], tree["set256"],
               "tree 2^18 nodes, n=256 (the priority refresh)",
               also_replaces="src/repro/kernels/replay_tree/"
                             "replay_tree.py:127"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
