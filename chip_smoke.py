#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing of JAX is imported):

1. Card and settings: the ``nvidia-smi`` name and power limit; TF32 off
   for matmul and cuDNN (the reference is fp32).
2. Build: compile the CUDA kernels from the checkout's sources.
3. Kernel against its plain version: ``dense_stack`` for every fused
   connectivity x {swish, relu, tanh, identity}, at a ragged small shape
   and at the served model's shapes (OFENet ``phi_s`` and the actor stack)
   for M in {1, 32, 256}, with non-zero biases. Pass: |kernel - plain| <=
   1e-4 * |plain| + 1e-4 * max|plain|.
4. Main path: the paper's "large" Fig. 10 SAC agent (``fig10-ablation`` at
   the paper budget, 2048 units, fused blocks, pendulum) is initialised on
   the card from a seed, saved with the port's checkpoint code, served
   through ``Policy.from_checkpoint`` + ``PolicyServer`` to 8 client
   threads (256 requests), checked against the plain path on the CPU, then
   hot-swapped to a second init (later responses must carry generation 1).
   Every tick must launch the stack kernel once per layer it runs.
   Then one tick at the most used slot is timed on the host clock and
   traced with ``torch.profiler`` (device busy time, top kernels).
5. Times of one actor-stack forward at slots 1, 8, 32 and 256: the kernel,
   its plain version, and a library yardstick (per-layer ``torch.addmm`` +
   activation into a preallocated stream, which the port never calls),
   beside the least time the card could take (bytes over 3.35 TB/s or fp32
   operations over 67 TFLOP/s, H100 SXM data sheet). Weights rotate
   through copies larger than the 50 MB L2, so each call reads them cold;
   the device time is taken with the host ahead of the card, and the
   host-bound time per back-to-back call is printed beside it.
6. One JSON line of kernel records, then the device line, last.
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


def close_enough(got, want):
    """(ok, max_abs_err) at rtol 1e-4, atol 1e-4 * max|want|."""
    import torch
    err = (got - want).abs()
    tol = 1e-4 * want.abs() + 1e-4 * want.abs().max()
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card; none is visible")
    from repro_torch.kernels import build_seconds
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

    stack._library()
    log(f"[build] dense_stack_fwd.cu built in "
        f"{build_seconds('dense_stack_fwd'):.1f}s")

    gen = torch.Generator(device="cuda").manual_seed(1234)
    phase_parity(gen)

    spec = presets.get("fig10-ablation").override(
        **PAPER_BUDGET, num_units=2048, block_backend="fused")
    acfg = algo_config(spec, make_env(spec.env))
    launches, main_slot, pol = phase_main_path(spec, acfg)
    phase_tick_profile(pol, main_slot)

    rows = phase_times(pol.params, gen)
    r = rows[main_slot]
    record = {
        "name": "dense_stack_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/dense_block/csrc/"
                  "dense_stack_fwd.cu",
        "replaces": "src/repro/kernels/dense_block/stack.py:315",
        "launches": launches, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "host_ms": r["host_ms"],
        "shape": f"actor stack d0=259 U=2048 L=2, M={main_slot} (the "
                 f"main path's most used slot)",
    }
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
