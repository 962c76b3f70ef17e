"""Serving load and stack-forward times of the port on the card.

    PYTHONPATH=<checkout>/src python src/repro_torch/launch/probe.py

The file imports whichever ``repro_torch`` the path gives, so two
checkouts of the port are measured by the same code on one card (run
them interleaved: A, B, B, A). It prints the package it imported, then
one JSON line:

* ``serve``: the paper's large Fig. 10 SAC agent (``fig10-ablation``,
  2048 units, OFENet 64 x 4, fused blocks, pendulum; random weights from a
  seed) behind ``PolicyServer`` (``ServeConfig()``), ``--rounds`` rounds of
  ``--requests`` requests from ``--clients`` closed-loop client threads:
  req/s, p50 and p99 latency (ms) per round, from the clients' clocks.
* ``tick_ms``: the host wall time of one ``act_deterministic`` at a slot
  (the tick's forward with its copies in and out), median of 200.
* ``enqueue_us``: the host time of one actor stack forward
  (``dense_stack``) at a slot, enqueued while the card is held busy, so it
  is the wrapper's host work alone; median of 5 runs of 50 calls.
* ``stack_us``: device time of one stack forward (CUDA events around 20
  back-to-back calls while the card is held busy, median of 5): the narrow
  OFENet stacks at the training batch (``phi_s`` 3 -> 259, ``phi_sa``
  260 -> 516, U = 64, 4 layers) and the actor at slot 8 and at 256.
"""
from __future__ import annotations

import argparse
import json
import statistics
import threading
import time
from typing import Dict, List

import numpy as np
import torch

import repro_torch
from repro_torch import resolve_device
from repro_torch.kernels.dense_block import stack
from repro_torch.launch.serve_policy import PolicyServer, ServeConfig
from repro_torch.rl import presets, sac
from repro_torch.rl.envs import make_env
from repro_torch.rl.policy import Policy, algo_config

SLOTS = (1, 8, 32)


def serve_load(policy: Policy, rounds: int, requests: int, clients: int,
               seed: int = 0) -> List[Dict[str, float]]:
    """``rounds`` rounds of ``requests`` requests from ``clients``
    closed-loop threads against a ``PolicyServer`` of ``policy``: per round
    ``req_s``, ``p50_ms``, ``p99_ms`` and the server's ``ticks``."""
    rng = np.random.default_rng(seed)
    out = []
    with PolicyServer(policy, ServeConfig()).start() as server:
        for _ in range(rounds):
            obs = rng.standard_normal(
                (requests, policy.obs_dim)).astype(np.float32)
            lat = [0.0] * requests
            lock = threading.Lock()
            todo = iter(range(requests))
            ticks = server.stats["ticks"]

            def client():
                while True:
                    with lock:
                        i = next(todo, None)
                    if i is None:
                        return
                    t0 = time.perf_counter()
                    server.submit(obs[i], timeout=120.0)
                    lat[i] = 1e3 * (time.perf_counter() - t0)
            threads = [threading.Thread(target=client)
                       for _ in range(clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300.0)
                if t.is_alive():
                    raise RuntimeError("client thread hung")
            wall = time.perf_counter() - t0
            out.append(dict(req_s=requests / wall,
                            p50_ms=float(np.percentile(lat, 50)),
                            p99_ms=float(np.percentile(lat, 99)),
                            ticks=server.stats["ticks"] - ticks))
    return out


def _hold(ms: float) -> None:
    """Keep the card busy for about ``ms`` (cycles at ~2 GHz)."""
    torch.cuda._sleep(int(2e6 * ms))


def device_us(fn, reps: int = 20, runs: int = 5) -> float:
    """Median over ``runs`` of the CUDA-event time of one of ``reps``
    back-to-back calls, enqueued while the card is held busy."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _hold(20.0)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(1e3 * start.elapsed_time(end) / reps)
    return statistics.median(samples)


def enqueue_us(fn, reps: int = 50, runs: int = 5) -> float:
    """Median over ``runs`` of the host time of one of ``reps`` calls,
    enqueued while the card is held busy (no call waits for the card)."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(runs):
        _hold(50.0)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        samples.append(1e6 * (time.perf_counter() - t0) / reps)
        torch.cuda.synchronize()
    return statistics.median(samples)


def _stack_params(gen, d0: int, u: int, layers: int, dev):
    ws = [torch.empty((d0 + i * u, u), device=dev).uniform_(
        -(d0 + i * u) ** -0.5, (d0 + i * u) ** -0.5, generator=gen)
        for i in range(layers)]
    bs = [0.1 * torch.randn((u,), generator=gen, device=dev)
          for _ in range(layers)]
    return ws, bs


def run(rounds: int = 5, requests: int = 1024, clients: int = 8,
        seed: int = 0) -> dict:
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = presets.get("fig10-ablation").override(
        num_units=2048, ofenet_units=64, ofenet_layers=4,
        block_backend="fused")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = sac.sac_init(algo_config(spec, make_env(spec.env)), gen,
                          device=dev)["params"]
    pol = Policy.from_spec(spec, params, device=dev)
    for slot in ServeConfig().batch_slots:              # warm up, build
        pol.act_deterministic(np.zeros((slot, pol.obs_dim), np.float32))
    torch.cuda.synchronize()
    rows = serve_load(pol, rounds, requests, clients, seed)

    tick, enq = {}, {}
    actor = ([l["dense"]["w"] for l in params["actor"]["layers"]],
             [l["dense"]["b"] for l in params["actor"]["layers"]])
    for slot in SLOTS:
        obs = np.random.default_rng(slot).standard_normal(
            (slot, pol.obs_dim)).astype(np.float32)
        times = []
        for _ in range(200):
            t0 = time.perf_counter()
            pol.act_deterministic(obs).cpu().numpy()
            times.append(1e3 * (time.perf_counter() - t0))
        tick[slot] = statistics.median(times)
        x = torch.randn((slot, actor[0][0].shape[0]), generator=gen,
                        device=dev)
        with torch.inference_mode():
            enq[slot] = enqueue_us(lambda: stack.dense_stack(x, *actor))

    stack_us, err = {}, {}
    nets = [("phi_s", 256, 3, 64, 4), ("phi_sa", 256, 260, 64, 4)]
    for name, m, d0, u, layers in nets:
        ws, bs = _stack_params(gen, d0, u, layers, dev)
        x = torch.randn((m, d0), generator=gen, device=dev)
        with torch.inference_mode():
            got = stack.dense_stack(x, ws, bs)
            want = stack.dense_stack_ref(x, ws, bs)
            err[f"{name} M={m}"] = float((got - want).abs().max())
            stack_us[f"{name} M={m}"] = device_us(
                lambda: stack.dense_stack(x, ws, bs))
    for m in (8, 256):
        x = torch.randn((m, actor[0][0].shape[0]), generator=gen, device=dev)
        with torch.inference_mode():
            stack_us[f"actor M={m}"] = device_us(
                lambda: stack.dense_stack(x, *actor))
    return dict(repro_torch=str(repro_torch.__file__),
                card=torch.cuda.get_device_name(dev), serve=rows,
                req_s_median=statistics.median(r["req_s"] for r in rows),
                tick_ms=tick, enqueue_us=enq, stack_us=stack_us,
                max_abs_err=err)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--requests", type=int, default=1024)
    ap.add_argument("--clients", type=int, default=8)
    args = ap.parse_args()
    print(f"# repro_torch from {repro_torch.__file__}", flush=True)
    print(json.dumps(run(args.rounds, args.requests, args.clients)),
          flush=True)


if __name__ == "__main__":
    main()
