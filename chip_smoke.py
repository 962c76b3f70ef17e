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
     register tile over a transposed input at M=256 with U >= 128 (every
     connectivity: densenet's stream^T, mlp's and d2rl's h^T), the old
     tile for mlp/d2rl past 32 rows below U=128) for every fused
     connectivity x {swish, relu, tanh, identity}, at a ragged small
     shape, at the model's shapes (OFENet ``phi_s`` and the actor at every
     serving slot, 1, 2, 4, 8, 16, 32, and at 256; the critic at 1, 8, 32,
     256; ``phi_s`` and ``phi_sa`` at 33, 100, 128, 256, 257; fig3-width's
     actor and critic, d0=3 and 4, U=2048, at 256) and at two ragged
     shapes of the register tile (201/203 rows), with non-zero biases:
     |kernel - plain|
     <= 1e-4 * |plain| + 1e-4 * max|plain|, and two calls bitwise equal;
     the whole-stack kernel's pre-activations (``zs``, autograd's) within
     1e-4 of the plain ones, its output bitwise the same with and without
     them;
   - the stack backward (dx, dW, db) for the same 12 cases at the ragged
     shape, at the four nets the training path differentiates at M=256
     (actor, critic, ``phi_s``, ``phi_sa``) and at two ragged shapes of the
     register tile (201/203 rows): within 1e-3 (rtol and atol * max; relu's
     slope at the kernel forward's pre-activations), and two calls bitwise
     equal; the whole-stack backward alone (``phase_whole_bwd``: ``phi_s``
     and ``phi_sa`` at 256 and 257 rows, every activation, each row tile,
     with every gradient, dx alone, the weights alone and the top layers'
     alone) within 1e-3, one launch a call, bitwise from call to call;
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
   - SSD (3xTF32 on ``mma.sync``, one launch a call): ``ssd_chunk_dual``
     at chunk 8, a ragged 100, 256 (the full G=16 H=16 N=P=64) and 1024
     (longer than the t-tile), H=3 (not a multiple of the heads a block),
     N=4 with P=8 (padding), P=100 and 128, and x views whose row stride
     rules out 16-byte copies; the whole ``ssd_chunked_kernel`` (its state
     pass a fixed number of torch ops) against the plain ``ssd_chunked`` +
     D x, and its final state, at chunk 8 and 256.
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
   kernels (``replay_backend="device"``, the spec's own
   ``replay_kernel="xla"``: the card runs the tree kernels for either)
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
   ``execution.loop="scan"`` (``phase_graph``, ``[graph]`` lines): the
   same spec's superstep captured as a CUDA graph by ``Trainer.chunk_fn``,
   with the wrapper counts of the warm-up and the captured superstep held
   to ``expected_launches``; 20 replays against 20 eager supersteps from
   one state, bitwise on every state tensor and the generator's state,
   then an eval after each, bitwise too; wall per superstep of both loops
   in turns (host clock, 40 supersteps a run); a replay's device time
   (CUDA events) and, from ``torch.profiler``, its device busy (the union
   of the device intervals), idle share, kernels per replay, the
   copy-back's time and a breakdown by class (``[graph-prof]``);
   ``Experiment.run`` in chunks of 17 + 23 supersteps against one call of
   40 and ``loop="python"`` (eval every 10, srank every 5), bitwise on the
   state, returns and sranks; the epilogue's srank against
   ``effective_rank`` on the CPU over the same features; checkpoints
   under the graph, for this spec and the TD3 one: ``run(17); save;
   Experiment.restore; run(23)`` through a file in a temporary directory
   against ``run(40)``, bitwise on the state, the generator, returns,
   eval steps and sranks, with the save and restore seconds and the
   file's bytes.
   The sharded replay (``phase_sharded``, ``[sharded-tree]``,
   ``[sharded]`` lines; ROADMAP A.8): the same spec at
   ``execution.mesh_shards=4`` (4 shards of 25,000 rows on a leading
   axis, 8 actors and 64 sampled rows a shard): the member tree kernels
   at those shapes (E=4 trees of 2^16 nodes, B=64, writes of 8 and 64)
   bitwise 4 solo launches and the plain versions, timed hot and cold
   beside them; ``mesh_shards=1`` bitwise ``mesh_shards=0`` over 40
   supersteps under the graph; at 4 shards (n_step 1 and 3) the launches
   of the warm-up and the captured superstep held to
   ``expected_launches`` (one member-axis sample and two member-axis
   writes for all shards), 20 replays bitwise 20 eager supersteps; the
   graph's wall beside the unsharded one in turns, each replay's CUDA-event
   time, idle share and kernels under the profiler; ``run(17); save;
   Experiment.restore; run(23)`` bitwise ``run(40)``; obs and the guard
   on in both loops, bitwise the scan loop with both off.
   TD3 training (``phase_td3``, ``[td3]`` lines): the same spec with
   ``algo="td3"``: the warm-up, one superstep on the card against the CPU
   plain path, the launches of the warm-up and the captured superstep
   held to ``expected_launches``' TD3 branch, 20 replays (both parities
   of the delayed policy update) against 20 eager supersteps, bitwise on
   every state tensor and the generator, the launches of 40 eager
   supersteps counted from 0 (each kernel of the path launched, each
   superstep as ``expected_launches``), both loops' wall in turns, 10
   eager supersteps and a replay's under the profiler (busy, idle,
   kernels, by class) and a replay's CUDA-event time.
   Obs and the guard (``phase_obs_guard``, ``[obs]``, ``[guard]``,
   ``[serve-watch]`` lines), at the same SAC spec: 40 supersteps under the
   graph with obs on (jsonl, every step, a profiler trace of the first
   chunk; chunks of 10) against obs off, bitwise on the state; the
   jsonl's train rows against the eager loop's per-step metrics, bitwise;
   the path's launches counted from 0 (warm-up and capture:
   ``expected_launches`` each); the trace ``done`` with its
   ``repro.chunk_dispatch`` span; a TD3 run's stream keys (the
   reference's: no ``alpha``); the wall per superstep in chunks of 5 with
   both off, obs (jsonl, every 5th step, grad-norm taps on and off) and
   the guard (policy skip), in turns, all ending in one state, bitwise;
   ``arm_nan_step(at_step=10)`` halting at step 11 under the graph; a
   rollback from a ``DurableStore`` of the full state against
   ``Experiment.restore`` + ``fold_in(gen, 1)`` + the rest of the run,
   bitwise, with the store's save and verify seconds;
   ``PolicyServer.watch`` adopting that run's next checkpoint while 4
   clients are served, each response within 1e-4 of the plain path under
   its stamped generation; ``python -m repro_torch.guard.supervise smoke``
   on the card with ``kill-in-save@6`` (saves every 3), resumed from
   step 3 to the uninterrupted card run's ``params_sha256``.
   The host NumPy replay (``phase_host``, ``[host]``, ``[host-prof]``):
   the same agent with the preset's own replay (``replay.backend=
   "host"``, capacity 100,000 in NumPy): the warm-up's ``add_batch`` of
   9,984 rows timed; ``Experiment.run(40)`` in the python loop with the
   counts set to 0 first, every superstep's launches
   ``expected_launches`` (no tree kernel), finite losses, the tree's
   total the sum of its leaves, no staleness keys; 20 supersteps through
   ``StepGraph``'s two graphs (collect rows, then the update, the NumPy
   add, sample and refresh between them) against 20 eager supersteps,
   bitwise on every state tensor, the generator, the buffer's arrays, its
   tree, ``ptr``/``count``/``max_priority`` and the NumPy generator's
   state, the launches of the warm-up and the capture 2 x
   ``expected_launches``; the wall per superstep of the eager loop and
   the two graphs beside the device replay's graph of the same spec, in
   turns; both under ``torch.profiler`` (busy, idle share, each host
   span's ms, each copy's ms, with the copies' bytes); ``run(17); save;
   Experiment.restore; run(23)`` against ``run(40)`` under the graphs,
   bitwise, the host buffer and NumPy generator included; ``python -m
   repro_torch.guard.supervise smoke`` with no override (the host replay)
   resumed to the uninterrupted card run's ``params_sha256``.
   The return band (``phase_band``, ``[band]``, ROADMAP A.11):
   ``table1-orig`` (host replay) at 10,000 supersteps for the 5 seeds of
   ``tests/data/return_band.json``, one process a seed at once on the
   card, the curves held to the JAX package's by the rule of
   ``tests/data/return_band.py`` (a two-sample z <= 3 on each seed's
   late mean); an untrained agent's returns on the card must fail it.
   Vmapped fleets (``phase_fleet``, ``[fleet-tree]``, ``[fleet]``,
   ``[fleet-smoke]``, ``[fleet-guard]`` lines): the sum-tree kernels with a
   member axis (E=5 trees of 2^18 nodes, B=256 targets a member, writes
   of n=32 and 256 with repeats) as one launch, bitwise 5 solo launches
   and the plain versions over the member axis, a write outside the
   leaves skipped and counted, and their hot and cold times beside 5 solo
   launches' and, at E=1, beside the solo entry's; the paper's widest
   Fig. 3 row (``fig3-width`` at the paper budget, 2048 units) as a fleet
   of 5 seeds (``rl.sweep.Fleet``) on the card, its warm-up vmapped, its
   superstep ``torch.func.vmap`` of the solo one captured once as a CUDA
   graph (the wrapper launches of the warm-up and the captured superstep:
   one member-axis sample, two member-axis writes), with the counts set
   to 0 first and read over the fleet run; member 0 against a solo
   ``Experiment`` of seed 0 after 1 and 40 supersteps (the reference's
   ``SOLO_PARITY`` tolerance; the largest difference per leaf printed);
   20 replays bitwise 20 eager vmapped supersteps; ``run(17); save;
   Fleet.restore; run(23)`` bitwise ``run(40)``; member 2 frozen for a
   chunk while the others stay bitwise an unmasked run, and resuming bit
   for bit; fleet and solo walls in turns, CUDA-event time, idle share
   and kernels per replay, also for ``fleet-smoke`` at E=8; a fleet
   rollback of a poisoned member from a ``DurableStore``, its neighbours
   bitwise.
   Fused fleets (``phase_fleet_fused``, ``[fleet-fused]``,
   ``[fleet-fused-train]`` lines): the stack kernels with a member axis
   at E=5 (the whole-stack kernel on ``phi_s`` and ``phi_sa`` at 256
   rows, streaming on the actor at 1 and 32, the register tile on the
   critic at 256 and, over h^T, on fig3-width's mlp actor and critic and
   a d2rl stack at U=2048, each beside the old ``dense_tile.cuh`` path;
   the backward of the critic and, whole, of ``phi_s`` and ``phi_sa``,
   each beside the per-layer kernels): one launch per solo
   launch for all members, bitwise five solo launches (output,
   pre-activations, every gradient), within 1e-4 / 1e-3 of the members
   twin, timed beside five solo calls, the twin, the jnp fleet's
   ``baddbmm`` products and the bound times E; the fig3-width U=2048 x 5
   fleet with ``block_backend="fused"`` from the jnp fleet's initial
   state, its warm-up and captured supersteps each launching one solo
   superstep's kernels (``expected_launches``), 40 supersteps, member 0
   against a solo fused run of seed 0 at ``SOLO_PARITY`` after every
   superstep (a sample flip, a superstep whose batches differ, which a
   rounding difference in the priorities can make and no tolerance
   covers, passes only where ``launch/fleet_parity.py``'s ``flip_cause``
   rebuilds both runs' trees and draws, reproduces both batches and
   finds each differing row's draw within float32 rounding of the
   boundary between its two rows in both trees; the solo run then
   restarts from member 0's state), its walls in
   turns with the jnp fleet's graph, CUDA-event time, idle share and
   kernels per replay; the training cell's spec (fig10-ablation U=2048,
   densenet, OFENet, device replay, 32 actors) as a fused fleet of 2
   seeds, its launches at capture, 20 supersteps, its replay against two
   solo replays in turns.
   Kernel micro-benchmark path: ``repro_torch.launch.kernels_micro.run()``
   (the fused dense, flash and SSD kernels, which no training or serving
   path runs) with every count set to 0 just before; each row must launch
   its kernel once per call.
6. Times at the main paths' shapes, each beside its plain version, a
   library yardstick the port never calls, and the least time the card
   could take (bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s,
   H100 SXM data sheet; 3xTF32 operations at 495 TFLOP/s for fused dense
   and fp32 flash attention, their fp32 SIMT bounds logged beside them; bf16
   flash's operations at 989 TFLOP/s; fp32 SSD: the larger of its bytes
   and 3xTF32 operations, bf16 SSD its operations at 989): the stack
   forward of the actor and
   ``phi_s`` at slots 1, 8, 32, 256 and of the critic and ``phi_sa`` at
   256 (weights read cold); fig3-width's mlp actor and critic and a d2rl
   stack at U=2048, M=256 (``time_hidden``: the register tile, the old
   ``dense_tile.cuh`` path, plain, ``addmm`` + silu, bound); the
   full stack backward of each net at M=256 (``phi_s`` and ``phi_sa``
   beside their old per-layer kernels), and
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
   call; the SSD chunk in float32 and bfloat16.
7. The port's gates and its quickstart (``[check]``, ``[quickstart]``
   lines): ``repro_torch.check.dynamic`` on the card for ``smoke`` and the
   sharded cell's spec cut to 12 supersteps (zero findings, D001 run: the
   steady-state pass under ``torch.cuda.set_sync_debug_mode("error")``),
   and ``smoke`` with a ``float()`` of a device tensor injected after
   every chunk, which D001 must report; ``python -m
   repro_torch.launch.quickstart --steps 16 --serve --log-dir`` (the
   served actions "match" the direct ones) and ``python -m
   repro_torch.obs.report`` over its log directory.
8. The paper's figure drivers (``phase_figs``, ``[figs]`` lines; ROADMAP
   A.10; last, because after its runs the profiler has been seen to drop
   device kernels), with the counts set to 0 first and read at its end:
   C14's checks (``figures.presets_smoke`` builds all 14 presets as shipped on
   the card; ``figures.rl_distributed --steps 32`` trains the
   ``rl-distributed`` preset as shipped, its device replay at the default
   ``replay.kernel="xla"``, under the scan loop's graph; a fig3-width U=256
   fleet of 2 seeds and a solo ``rl-distributed`` run, each under "xla"
   and "pallas", bitwise one state, tree and return); every driver's
   ``run("quick")`` at a budget cut by ``figures.common.cut_budget``
   (``FIG_CUT``) and ``figures.width_study``, their rows printed and held
   to the reference drivers' names and fields (``FIG_ROWS``), each
   driver's wall; the full-width rows at the paper budget cut to 8
   supersteps: fig3-width's U=2048 point x 5 seeds from
   ``fig3_width.grid("paper")`` as a fleet, its wall per replay within 5%
   of ``phase_fleet``'s in the same run, and ``fig10_full`` (the host
   replay) through ``bench_run``; the J_Q surface (9 x 9, span 1.0,
   ``loss_landscape_bench.surface``) of the training cell's U=2048
   critics on a replay batch of 256, through the stack forward kernel and
   through its plain twin on the card with the same directions, pointwise
   within relative 1e-4.
9. One JSON line of seven kernel records for the eight ``pallas_call``
   sites (``tree_set`` also replaces the one-hot write; the stack
   records' ``launches_by_kernel``: the forward's by kernel, the
   backward's ``whole`` and ``layers``; the stack and tree records'
   ``launches_by_path`` give SAC's and TD3's launches over 40 supersteps,
   all four ``sharded``: the sharded phase's ``mesh_shards=4`` runs (the
   tree records' ``sharded`` entries the member launches at the shards'
   shapes),
   the stack records' also the host replay's (``train_host``), the tree
   records' also the fleet run's, the stack records' also the fused
   fleets' (``fleet``: fig3-width, ``fleet_train``: the training cell's
   spec), and all four ``figs``: the figure phase's; their ``fleet``
   entries the member-axis launches' times, ``fleet_by_shape`` every
   member case's), then the device line, last.
"""
from __future__ import annotations

import json
import math
import os
import re
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
# a wide stack whose first layer's backward products are thin (d0 < 128):
# fig10-ablation's actor as shipped (its 16-unit OFENet features)
THIN_NETS = (("fig10_actor", 128, 35, 128, 2),)


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
    # fig3-width's stacks at U=2048 (mlp and d2rl: the register tile over
    # h^T, layer 0's K = 3 and 4, the pendulum's observation and action)
    shapes += [("fig3_actor", 256, 3, 2048, 2), ("fig3_critic", 256, 4,
                                                 2048, 2)]
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
    shapes = (("ragged", 5, 7, 40, 3),) + TRAIN_NETS + RAGGED_RT + THIN_NETS
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


def phase_whole_bwd(gen):
    """The whole-stack backward on its own (phi_s and phi_sa at 256 and a
    ragged 257 rows, every activation): at each of its row tiles, with
    every gradient, dx alone (the actor loss through phi_sa), the weights
    alone and the top layers' alone (a lowest layer above 0), against
    autograd of the plain version (relu's slope at the kernel forward's
    pre-activations) within 1e-3, bitwise from call to call, one launch a
    call, and against the per-layer kernels (``whole=False``)."""
    import torch
    from repro_torch.kernels.dense_block import stack
    needs = {"all": (True, [True] * 4, [True] * 4),
             "dx": (True, [False] * 4, [False] * 4),
             "weights": (False, [True] * 4, [True] * 4),
             "top": (False, [False, False, True, True],
                     [False, True, True, True])}
    worst, worst_layers, cases = 0.0, 0.0, 0
    for name, d0 in (("phi_s", 3), ("phi_sa", 260)):
        for m in (256, 257):
            for act in ("swish", "relu", "tanh", "identity"):
                x, ws, bs = stack_inputs("densenet", 4, d0, 64, m, gen)
                g = torch.randn((m, d0 + 4 * 64), generator=gen,
                                device="cuda")
                zs = torch.empty((m, 4 * 64), device="cuda")
                out = stack._kernel_forward(x, ws, bs, "densenet", act, zs)
                want = stack.dense_stack_grads_ref(
                    x, ws, bs, g, activation=act, zs=zs)
                flat_want = [want[0], *want[1], *want[2]]
                layers = stack._kernel_backward(
                    (out, zs), ws, g, "densenet", act, True, [True] * 4,
                    [True] * 4, whole=False)
                ok, err = grads_close([layers[0], *layers[1], *layers[2]],
                                      flat_want)
                worst_layers = max(worst_layers, err)
                for rows in stack._WHOLE_BWD_ROW_TILES:
                    for what, (ndx, ndw, ndb) in needs.items():
                        lowest = 0 if ndx else min(
                            i for i in range(4) if ndw[i] or ndb[i])
                        before = stack.bwd_launch_count("whole")
                        runs = [stack._launch_whole_bwd(
                            out, zs, ws, g, stack._ACT_CODE[act], ndx, ndw,
                            ndb, lowest, rows) for _ in range(2)]
                        if stack.bwd_launch_count("whole") - before != 2:
                            raise AssertionError("whole backward: not one "
                                                 "launch a call")
                        got = [runs[0][0], *runs[0][1], *runs[0][2]]
                        again = [runs[1][0], *runs[1][1], *runs[1][2]]
                        asked = [ndx, *ndw, *ndb]
                        if [t is not None for t in got] != asked:
                            raise AssertionError(f"whole backward {name} "
                                                 f"{what}: returned {got}")
                        pairs = [(a, b, w) for a, b, w, k in
                                 zip(got, again, flat_want, asked) if k]
                        ok, err = grads_close([a for a, _, _ in pairs],
                                              [w for _, _, w in pairs])
                        worst = max(worst, err)
                        cases += 1
                        if not ok:
                            raise AssertionError(
                                f"whole backward != plain: {name} M={m} "
                                f"{act} rows={rows} {what}: {err:.3e}")
                        if not all(torch.equal(a, b) for a, b, _ in pairs):
                            raise AssertionError(
                                f"whole backward not bitwise repeatable: "
                                f"{name} M={m} {act} rows={rows} {what}")
    log(f"[parity] whole-stack backward == plain: phi_s and phi_sa at M=256 "
        f"and 257 x 4 activations x row tiles "
        f"{list(stack._WHOLE_BWD_ROW_TILES)} x {{all, dx alone, weights "
        f"alone, top layers alone}} ({cases} cases), max abs err "
        f"{worst:.3e} (the per-layer kernels {worst_layers:.3e}); one "
        f"launch a call, two calls bitwise equal")
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


# fig3-width's stacks at the paper's widest point (mlp, U=2048: the
# actor d0=3 and the critic d0=4) and a d2rl stack of the same width
HIDDEN_NETS = (("fig3_actor", "mlp", 3), ("fig3_critic", "mlp", 4),
               ("d2rl", "d2rl", 4))


def time_hidden(name, conn, d0, gen, m=256, u=2048, L=2):
    """One mlp or d2rl stack forward (swish) at M rows: the register tile
    over h^T (``plan_fwd``'s), the path before it (``dense_tile.cuh``,
    ``mlp_rt=False``), the plain version and the library yardstick
    (``addmm`` + ``silu`` a layer), each cycling its weights through
    copies larger than the 50 MB L2, beside the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.dense_block import stack
    x, ws, bs = stack_inputs(conn, L, d0, u, m, gen)
    wbytes = 4 * sum(w.numel() + b.numel() for w, b in zip(ws, bs))
    copies = [([w.clone() for w in ws], [b.clone() for b in bs])
              for _ in range(max(2, math.ceil(120e6 / wbytes)))]

    def kernel(c):
        return stack.dense_stack(x, c[0], c[1], connectivity=conn)

    def old(c):
        return stack._kernel_forward(x, c[0], c[1], conn, "swish",
                                     mlp_rt=False)

    def plain(c):
        return stack.dense_stack_ref(x, c[0], c[1], connectivity=conn)

    def library(c):
        h = x
        for i, (w, b) in enumerate(zip(*c)):
            inp = torch.cat([h, x], 1) if conn == "d2rl" and i else h
            h = F.silu(torch.addmm(b, inp, w))
        return h
    before = stack.launch_count("rt")
    got = kernel(copies[0])
    if stack.launch_count("rt") - before != L:
        raise AssertionError(f"{name}: not on the register tile")
    _, err = close_enough(got, plain(copies[0]))
    _, err_old = close_enough(old(copies[0]), plain(copies[0]))
    t_o, _ = time_ms(old, copies)
    t_k, h_k = time_ms(kernel, copies)
    t_p, _ = time_ms(plain, copies)
    t_l, _ = time_ms(library, copies)
    t_k2, _ = time_ms(kernel, copies)
    t_o2, _ = time_ms(old, copies)
    flops = 2 * m * sum(w.shape[0] * w.shape[1] for w in ws)
    nbytes = wbytes + 4 * m * (d0 + u)
    bound_ms, bound_by = _bound(nbytes, flops)
    r = dict(ms=min(t_k, t_k2), old_tile_ms=min(t_o, t_o2), plain_ms=t_p,
             library_ms=t_l, bound_ms=bound_ms, bound_by=bound_by,
             max_abs_err=err, host_ms=h_k)
    log(f"[time] {name} ({conn}) stack M={m} d0={d0} U={u} L={L}: register "
        f"tile {r['ms'] * 1e3:8.1f} us (runs {t_k * 1e3:.1f}/"
        f"{t_k2 * 1e3:.1f}), the old path (dense_tile.cuh) "
        f"{r['old_tile_ms'] * 1e3:8.1f} us (runs {t_o * 1e3:.1f}/"
        f"{t_o2 * 1e3:.1f}; new / old x{r['ms'] / r['old_tile_ms']:.3f}), "
        f"plain {t_p * 1e3:8.1f} us, addmm + silu {t_l * 1e3:8.1f} us "
        f"({'faster' if r['ms'] <= t_l else 'SLOWER'} than it), bound "
        f"{bound_ms * 1e3:6.1f} us ({bound_by}: {flops / 1e9:.2f} GFLOP), "
        f"{100 * bound_ms / r['ms']:.0f}% of bound; max abs err {err:.2e} "
        f"(old {err_old:.2e})")
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
    for name, conn, d0 in HIDDEN_NETS:
        rows[(name, 256)] = time_hidden(name, conn, d0, gen)
    return rows


def expected_launches(tr):
    """Kernel launches of one training superstep, read off the code.

    SAC (``sac_update``). Stack forwards: collect's ``sample_action``
    (phi_s + actor) at the actor pool's rows; at the batch's: the aux loss
    (phi_s + phi_sa), the target's ``sample_action`` (phi_s + actor) and
    ``q_values`` (phi_s + phi_sa + q1 + q2), the critic loss's, the actor
    loss's and the priorities' ``q_values`` (4 nets each) and the actor
    loss's ``sample_action``: 24 calls, 13*Lo + 11*L layers, of which
    12*Lo + 10*L at the batch (7 phi_s calls, 5 phi_sa, 2 actor, 8
    critic). Stack backwards: aux (phi_sa, phi_s), critic loss (q1, q2),
    actor loss (q1, q2, phi_sa for dx, the actor for dW): 8.

    TD3 (``td3_update``). Stack forwards: collect's ``policy`` (phi_s +
    actor); at the batch: the aux loss (phi_s + phi_sa), the target
    policy (phi_s + target actor) and ``q_values`` (4 nets), the critic
    loss's ``q_values`` (4), the actor loss's ``policy`` (phi_s + actor)
    and its ``_q1`` (phi_s + phi_sa + q1), the priorities' ``_q1`` (3):
    22 calls, 13*Lo + 9*L layers (7 phi_s, 5 phi_sa, 2 actor and 6 critic
    calls at the batch). The actor's gradient and AdamW step run on every
    superstep (the delay is a select), so both parities launch the same.
    Stack backwards: aux (phi_sa, phi_s), critic loss (q1, q2), actor
    loss (q1 for dx, phi_sa for dx, the actor for dW): 7.

    ``fwd_<kernel>`` counts launches by the kernel ``plan_fwd`` gives each
    call: one a layer, but one a stack on the whole-stack kernel (phi_s
    and phi_sa at the batch); the actor and the critics take the register
    tile at 256 rows (densenet, mlp and d2rl alike at U >= 128), every
    stack the streaming kernel at 32; ``fwd_t`` counts the register
    tile's transposed inits, one per wide stack call. ``bwd_whole``: the
    backwards of the narrow densenet stacks, each ONE launch of the
    whole-stack backward kernel (SAC and TD3: phi_sa twice, phi_s once).
    Tree: one sample, two writes (the add, the priority refresh); none
    with the host replay."""
    from repro_torch.kernels.dense_block import stack
    acfg = tr.acfg
    td3 = tr.spec.algo == "td3"
    want = {f"fwd_{k}": 0 for k in stack.FWD_KERNELS}
    want["fwd_t"] = 0
    layers = 0

    def calls(n, m, blk):
        nonlocal layers
        dense = blk.connectivity == "densenet"
        kind = stack.fwd_kernel_of(stack.plan_fwd(
            m, blk.num_units, blk.in_dim, num_sms(),
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
    critic_calls = 6 if td3 else 8
    for n, m, blk in ((1, tr.n_actors, acfg.actor_block()),
                      (2, tr.batch_size, acfg.actor_block()),
                      (critic_calls, tr.batch_size, acfg.critic_block())):
        calls(n, m, blk)
    if layers != 13 * lo + (critic_calls + 3) * acfg.num_layers:
        raise AssertionError(f"expected forward layers do not add up: "
                             f"{layers}, {want}")
    want["fwd"] = sum(want[f"fwd_{k}"] for k in stack.FWD_KERNELS)
    bwd = (7 if lo else 4) if td3 else (8 if lo else 5)

    def whole(blk):                 # one launch a backward, if narrow
        return int(blk.connectivity == "densenet" and stack.whole_bwd_smem(
            blk.in_dim, blk.num_units, blk.num_layers) is not None)
    # backward calls on the narrow stacks: phi_sa twice (aux, actor
    # loss), phi_s once (aux); the actor once, the critics 4 (SAC) or 3
    bwd_whole = whole(acfg.actor_block()) \
        + (3 if td3 else 4) * whole(acfg.critic_block())
    if acfg.ofenet:
        bwd_whole += 2 * whole(phi_sa) + whole(phi_s)
    # the host replay's tree is NumPy: no tree kernel
    want.update(bwd=bwd, bwd_whole=bwd_whole, sample=0 if tr.host else 1,
                set=0 if tr.host else 2)
    return want


def _counts():
    from repro_torch.kernels.dense_block import stack
    from repro_torch.kernels.replay_tree import ops
    return {"fwd": stack.launch_count(),
            **{f"fwd_{k}": stack.launch_count(k) for k in stack.FWD_KERNELS},
            "fwd_t": stack.transpose_count(),
            "bwd": stack.bwd_launch_count(),
            "bwd_whole": stack.bwd_launch_count("whole"),
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


def train_keys(spec):
    """``TRAIN_KEYS`` that ``spec``'s algorithm reports (TD3 has no
    ``alpha``)."""
    return tuple(k for k in TRAIN_KEYS
                 if spec.algo == "sac" or k != "alpha")


def phase_train_parity(spec, exp, tag="train"):
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
    for k in train_keys(spec):
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
    log(f"[{tag}] one superstep card vs CPU plain path, same state and "
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


def _template_args(key, name):
    """The template arguments of kernel ``name`` in a profiler kernel name
    (``...name<a, b, ...>(...)``) as strings, or None where the name is
    another kernel's (``dw_tile_kernel`` is not ``tile_kernel``). The
    member kernels carry one more flag (MB) after the solo ones."""
    i = key.find(name + "<")
    while i > 0 and (key[i - 1].isalnum() or key[i - 1] == "_"):
        i = key.find(name + "<", i + 1)
    if i < 0:
        return None
    return [a.strip() for a in
            key[i + len(name) + 1:key.find(">", i)].split(",")]


def _solo_name(key):
    """A profiler kernel name with a member kernel's name as its solo
    kernel's (``tile_members<`` as ``tile_kernel<``, ...): the classes
    take both."""
    return re.sub(r"_members([<(])", r"_kernel\1", key)


def bwd_product_class(key):
    """'dW', 'dx', 'act_grad', 'whole' or None for a profiler kernel name:
    the register-tiled kernels by name (dx with the transpose of W it
    reads, act_grad with its db pass), dense_tile.cuh's by their layout
    template arguments (TA, TW): (true, false) for dW, (false, true) for
    dx; the whole-stack backward by name; member kernels as their solo
    kernels."""
    key = _solo_name(key)
    if "whole_bwd_kernel<" in key:
        return "whole"
    if "act_grad_kernel" in key or "db_sum_kernel" in key:
        return "act_grad"
    tile = _template_args(key, "tile_kernel")
    layout = tile[5:7] if tile else None
    if "dw_tile_kernel" in key or layout == ["true", "false"]:
        return "dW"
    tr = _template_args(key, "transpose_kernel")
    if "dx_tile_kernel" in key or (tr and tr[0] == "false") \
            or layout == ["false", "true"]:
        return "dx"
    return None


def fwd_class(key):
    """The forward kernel class of a profiler kernel name, or None:
    'wide' (the register tile over stream^T), 'whole' (the whole-stack
    kernel), 'narrow' (dense_tile.cuh's forward: its layout template
    arguments are (false, false)), 'stream' (the weight-streaming kernel)
    or 'transpose' (the transposed init: densenet's the copying case of
    dense_tile.cuh's transpose, the backward's W^T the other; mlp's and
    d2rl's ``xt_kernel``); member kernels as their solo kernels."""
    key = _solo_name(key)
    tr = _template_args(key, "transpose_kernel")
    if (tr and tr[0] == "true") or _template_args(key, "xt_kernel"):
        return "transpose"
    if "whole_stack_kernel<" in key:
        return "whole"
    if "stream_kernel<" in key:
        return "stream"
    if "fwd_tile_kernel" in key:
        return "wide"
    tile = _template_args(key, "tile_kernel")
    if tile and tile[5:7] == ["false", "false"]:
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
    classes = {c: [0.0, 0.0] for c in ("dW", "dx", "act_grad", "whole")}
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


GRAPH_K = 20        # replays held bitwise against eager supersteps
GRAPH_TIMED = 40    # supersteps a loop, timed on the host clock


def _state_names(ls):
    """``(name, tensor)`` of every state tensor, in ``state_leaves``'
    order (sorted dict keys, as ``tree_leaves``)."""
    from repro_torch.rl.runner import state_leaves

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from walk(tree[k], f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from walk(v, f"{path}/{i}")
        else:
            yield path, tree
    named = [*walk(ls.agent, "agent"),
             *((f"actors/{f}", t) for f, t in zip(ls.actors._fields,
                                                  ls.actors)),
             *(walk(ls.nstep, "nstep") if ls.nstep is not None else ()),
             *walk(ls.replay, "replay"), ("step", ls.step)]
    leaves = state_leaves(ls)
    if len(named) != len(leaves) or any(
            t is not u for (_, t), u in zip(named, leaves)):
        raise AssertionError("state names out of step with state_leaves")
    return named


def state_diff(a, b):
    """``[(name, max abs difference)]`` of the state tensors of ``a`` and
    ``b`` that are not bitwise equal, the generator's state included."""
    import torch
    bad = [(name, float((x.double() - y.double()).abs().max()))
           for (name, x), (_, y) in zip(_state_names(a), _state_names(b))
           if not torch.equal(x, y)]
    if not torch.equal(a.gen.get_state(), b.gen.get_state()):
        bad.append(("gen", float("nan")))
    return bad


def host_of(tr):
    """A copy of what a host-replay run keeps outside its state
    (``replay.buffer_state``), or None for a device-replay run."""
    from repro_torch.rl.replay import buffer_state
    return None if tr.buffer is None else buffer_state(tr.buffer, tr.rng)


def host_diff(a, b):
    """``[(name, max abs difference)]`` of two ``host_of`` copies that are
    not bitwise equal (the buffer's arrays, its tree, ``ptr``, ``count``,
    ``max_priority`` and the NumPy generator's state)."""
    if a is None and b is None:
        return []
    arrays = [(f"host/data/{k}", a["data"][k], b["data"][k])
              for k in a["data"]] + [("host/tree", a["tree"], b["tree"])]
    bad = [(n, float(np.abs(x.astype(np.float64) - y).max()))
           for n, x, y in arrays if not np.array_equal(x, y)]
    return bad + [(k, float("nan")) for k in ("ptr", "count",
                                               "max_priority", "rng_state")
                  if a[k] != b[k]]


def graph_class(key):
    """'copy-back' (the foreach copy into the static state), 'adamw' (the
    other foreach kernels: the optimizer's) or None, for a profiler kernel
    name."""
    if "multi_tensor_apply_kernel" not in key:
        return None
    return "copy-back" if "Copy" in key else "adamw"


def busy_union_ms(prof):
    """The time at least one device operation ran, in ms, from a profile's
    device events (the union of their intervals: kernels on two streams
    that overlap count once), or None without device events."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    total, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            total, lo = total + hi - lo, a
        hi = max(hi, b)
    return (total + hi - lo) / 1e3


def superstep_class(key):
    """The class of a superstep's kernel for the breakdown under replay:
    the forward's, the backward's and the tree's classes, the foreach
    kernels', else 'other' (elementwise, reductions, library products)."""
    for prefix, c in (("fwd ", fwd_class(key)), ("bwd ",
                                                 bwd_product_class(key)),
                      ("tree ", tree_class(key)), ("", graph_class(key))):
        if c is not None:
            return prefix + c
    return "other"


def graph_capture(tr, ls0, want, tag):
    """Capture ``tr``'s superstep from a copy of ``ls0`` (``chunk_fn(1)``:
    the warm-up superstep, then the capture) with the wrapper counters
    read at each, held to ``want``; returns the graph."""
    import torch
    from repro_torch.rl.runner import clone_state, state_leaves
    per_call, step_fn = [], tr.step

    def counted(ls, draws=None):
        before = _counts()
        out = step_fn(ls, draws)
        after = _counts()
        per_call.append({k: after[k] - before[k] for k in after})
        return out
    tr.step = counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        tr.chunk_fn(1, False)(clone_state(ls0))  # warm-up + capture only
        torch.cuda.synchronize()
    finally:
        tr.step = step_fn
    t_cap = time.perf_counter() - t0
    if per_call != [want, want]:
        raise AssertionError(f"launches at warm-up and capture {per_call}, "
                             f"want {want} each")
    graph = tr.graph
    log(f"[{tag}] capture of one superstep ({t_cap:.2f}s with the warm-up "
        f"superstep): launches counted at warm-up and at capture, each "
        f"{want} (expected_launches); copy-back "
        f"{graph.copied_bytes / 1e6:.1f} MB a replay ({len(state_leaves(ls0))}"
        f" state tensors in all)")
    return graph


def graph_bitwise(tr, ls0, tag):
    """``GRAPH_K`` replays against ``GRAPH_K`` eager supersteps from
    ``ls0``, then an eval draw after each: bitwise on every state tensor
    and the generator. Returns the two states."""
    import torch
    from repro_torch.rl.runner import clone_state, state_leaves
    eager = clone_state(ls0)
    for _ in range(GRAPH_K):
        eager, _, _ = tr.step(eager)
    replayed, _ = tr.chunk_fn(GRAPH_K, False)(clone_state(ls0))
    torch.cuda.synchronize()
    bad = state_diff(eager, replayed)
    if bad:
        raise AssertionError(f"{GRAPH_K} replays != {GRAPH_K} eager "
                             f"supersteps in {len(bad)} state tensors, first"
                             f" (name, max abs diff): {bad[:8]}")
    ev_e, ev_g = tr.evaluate(eager), tr.evaluate(replayed)
    bad = state_diff(eager, replayed)
    if not torch.equal(ev_e, ev_g) or bad:
        raise AssertionError(f"eval after {GRAPH_K} replays != after eager:"
                             f" returns {ev_e.tolist()} vs {ev_g.tolist()},"
                             f" state {bad[:8]}")
    n_el = sum(t.numel() for t in state_leaves(eager))
    log(f"[{tag}] bitwise: {GRAPH_K} replays == {GRAPH_K} eager supersteps "
        f"from one state (steps {int(ls0.step)}-{int(ls0.step) + GRAPH_K - 1}"
        f") on all {len(state_leaves(eager))} state tensors "
        f"({n_el} elements: params, AdamW moments and counts, actors, "
        f"replay store, sum-tree, max priority, add steps, step) and the "
        f"generator's state; an eval after each: the same "
        f"{ev_e.numel()} returns (mean {float(ev_e.mean()):.6g}) and "
        f"generator state")
    return eager, replayed


def graph_walls(tr, eager, replayed, tag):
    """Wall per superstep, host clock, eager and graph in turns."""
    import torch
    walls = []
    for loop in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if loop == "eager":
            for _ in range(GRAPH_TIMED):
                eager, _, _ = tr.step(eager)
        else:
            replayed, _ = tr.chunk_fn(GRAPH_TIMED, False)(replayed)
        torch.cuda.synchronize()
        walls.append((loop, 1e3 * (time.perf_counter() - t0) / GRAPH_TIMED))
    log(f"[{tag}] wall per superstep, host clock, {GRAPH_TIMED} supersteps "
        f"a run, in turns: " + ", ".join(f"{k} {ms:.3f} ms"
                                         for k, ms in walls)
        + f" (eager {np.mean([m for k, m in walls if k == 'eager']):.3f},"
        f" graph {np.mean([m for k, m in walls if k == 'graph']):.3f})")


def profile_summary(prof, n):
    """A profile of ``n`` supersteps or replays: ``(device events, summed
    kernel ms, busy ms as the union of the device intervals or None,
    {superstep_class: [ms, kernels]})``, each per superstep."""
    import torch
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    summed = sum(e.self_device_time_total for e in events) / 1e3 / n
    union = busy_union_ms(prof)
    classes = {}
    for e in events:
        c = classes.setdefault(superstep_class(e.key), [0.0, 0.0])
        c[0] += e.self_device_time_total / 1e3 / n
        c[1] += e.count / n
    return events, summed, None if union is None else union / n, classes


def eager_profile(tr, ls, tag, steps=10):
    """``steps`` eager supersteps from ``ls`` under the profiler: wall per
    superstep, device busy (union and summed), idle share, device
    operations and the breakdown by class. Returns the state."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ls, _, _ = tr.step(ls)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    events, summed, busy_ms, classes = profile_summary(prof, steps)
    if not events or busy_ms is None:
        log(f"[{tag}] the profiler saw no device time in the eager loop: "
            f"busy share not measured")
        return ls
    log(f"[{tag}] eager, {steps} supersteps under the profiler: "
        f"{wall_ms:.2f} ms wall per superstep, device busy {busy_ms:.3f} ms"
        f" (union; summed kernel time {summed:.3f}), idle share "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%; "
        f"{sum(e.count for e in events) / steps:.0f} device ops per "
        f"superstep")
    log(f"[{tag}] eager by class, ms/superstep (kernels): " + ", ".join(
        f"{c} {ms:.3f} ({n:.0f})" for c, (ms, n) in
        sorted(classes.items(), key=lambda kv: -kv[1][0])))
    return ls


def graph_device_time(graph, tag, prof_tag, reps=10):
    """A replay's device time with the host out of its way (CUDA events,
    the card held busy first), then the profiler's view of replays.
    Returns ``{"events_ms", "wall_ms", "busy_ms", "idle", "kernels"}``
    (idle share and kernels per replay None where the profiler saw no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    samples = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e6 * 20))
        start.record()
        graph.replay(reps)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        graph.replay(reps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    events, summed, busy_ms, classes = profile_summary(prof, reps)
    ev_ms = float(np.median(samples))
    out = {"events_ms": ev_ms, "wall_ms": wall_ms, "busy_ms": busy_ms,
           "idle": None, "kernels": None}
    if events and busy_ms is not None:
        out["idle"] = 1 - busy_ms / wall_ms
        out["kernels"] = sum(e.count for e in events) / reps
        cb, aw = classes.get("copy-back", (0, 0)), classes.get("adamw",
                                                              (0, 0))
        log(f"[{prof_tag}] {reps} replays under the profiler: "
            f"{wall_ms:.3f} ms wall per superstep, device busy "
            f"{busy_ms:.3f} ms (union of the device intervals; summed "
            f"kernel time {summed:.3f}), idle share "
            f"{100 * (1 - busy_ms / wall_ms):.1f}%; "
            f"{sum(e.count for e in events) / reps:.0f} kernels per replay;"
            f" copy-back {cb[0]:.4f} ms over {cb[1]:.1f} kernels (bound "
            f"{2 * graph.copied_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms: "
            f"{graph.copied_bytes / 1e6:.1f} MB read and written); AdamW's "
            f"foreach kernels {aw[0]:.4f} ms over {aw[1]:.1f}")
        log(f"[{prof_tag}] by class, ms/replay (kernels): " + ", ".join(
            f"{c} {ms:.3f} ({n:.0f})" for c, (ms, n) in
            sorted(classes.items(), key=lambda kv: -kv[1][0])))
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[{prof_tag}]   "
                f"{e.self_device_time_total / reps / 1e3:8.3f}"
                f" ms/replay {e.count / reps:6.1f}x  {e.key[:90]}")
    else:
        log(f"[{prof_tag}] the profiler saw no device time under replay: "
            "busy share, kernels per replay and the copy-back not measured")
    log(f"[{tag}] device time per replay (CUDA events, card held busy, "
        f"{reps} replays, median of 3): {ev_ms:.3f} ms "
        f"({', '.join(f'{x:.3f}' for x in samples)})")
    return out


def graph_checkpoint(spec, tag, whole=None):
    """``run(17); save; Experiment.restore; run(23)`` under the graph,
    through a file in a temporary directory, against ``run(40)`` (eval
    every 10, srank every 5): bitwise on the state, the generator, the
    returns, eval steps and sranks. ``whole`` is an uninterrupted run of
    40 of that spec when one exists already."""
    import gc
    import tempfile
    import torch
    from repro_torch.rl.experiment import Experiment
    cspec = spec.override(loop="scan", eval_every=10, srank_every=5)
    if whole is None:
        whole = Experiment.from_spec(cspec)
        whole.run(40)
    first = Experiment.from_spec(cspec)
    first.run(17)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "run.npz")
        t0 = time.perf_counter()
        first.save(path)
        t_save = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        del first
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = Experiment.restore(path)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    r = resumed.run(23)
    torch.cuda.synchronize()
    w = whole.result()
    bad = state_diff(resumed._ls, whole._ls) + host_diff(
        host_of(resumed.trainer), host_of(whole.trainer))
    if bad or r.returns != w.returns or r.sranks != w.sranks \
            or r.eval_steps != w.eval_steps \
            or w.eval_steps != [10, 20, 30, 40]:
        raise AssertionError(
            f"run(17); save; restore; run(23) != run(40): state {bad[:8]}, "
            f"returns {r.returns} vs {w.returns}, sranks {r.sranks} vs "
            f"{w.sranks}, eval steps {r.eval_steps} vs {w.eval_steps}")
    log(f"[{tag}] checkpoint: {spec.algo} loop='scan' run(17); save; "
        f"Experiment.restore; run(23) == run(40), bitwise on every state "
        f"tensor and the generator"
        + (", the host buffer, tree, cursor and NumPy generator"
           if whole.trainer.host else "")
        + f", returns {r.returns}, eval steps "
        f"{r.eval_steps}, sranks {r.sranks}; save {t_save:.2f}s, restore "
        f"{t_restore:.2f}s, file {nbytes} bytes ({nbytes / 1e6:.1f} MB)")
    del resumed, whole
    gc.collect()
    torch.cuda.empty_cache()


def phase_graph(spec, ckpt_specs=()):
    """``execution.loop="scan"`` on the card: the superstep captured once
    as a CUDA graph (``Trainer.chunk_fn``) against the eager superstep, at
    the training phase's full width; then checkpoints under the graph for
    ``spec`` and each of ``ckpt_specs``."""
    import gc
    import torch
    from repro_torch.core.effective_rank import effective_rank
    from repro_torch.rl.experiment import Experiment
    from repro_torch.rl.runner import clone_state
    scan = spec.override(loop="scan")
    exp = Experiment.from_spec(scan)
    tr = exp.trainer
    want = expected_launches(tr)
    exp._ensure_init()
    ls0 = clone_state(exp._ls)
    graph = graph_capture(tr, ls0, want, "graph")
    eager, replayed = graph_bitwise(tr, ls0, "graph")
    graph_walls(tr, eager, replayed, "graph")
    graph_device_time(graph, "graph", "graph-prof")
    del exp, tr, graph, eager, replayed, ls0
    gc.collect()
    torch.cuda.empty_cache()

    # chunking: 17 + 23 against one call of 40 and the python loop, eval
    # every 10, srank every 5
    cspec = scan.override(eval_every=10, srank_every=5)
    runs = {}
    for name, loop, calls in (("17+23", "scan", (17, 23)),
                              ("40", "scan", (40,)),
                              ("python", "python", (40,))):
        e = Experiment.from_spec(cspec.override(loop=loop))
        t0 = time.perf_counter()
        for n in calls:
            r = e.run(n)
        torch.cuda.synchronize()
        runs[name] = (e, r, time.perf_counter() - t0)
    base_e, base_r, _ = runs["17+23"]
    for name in ("40", "python"):
        e, r, _ = runs[name]
        bad = state_diff(base_e._ls, e._ls)
        if bad or r.returns != base_r.returns or r.sranks != base_r.sranks \
                or r.eval_steps != base_r.eval_steps:
            raise AssertionError(
                f"chunked run 17+23 != {name}: state {bad[:8]}, returns "
                f"{base_r.returns} vs {r.returns}, sranks {base_r.sranks} vs"
                f" {r.sranks}, eval steps {base_r.eval_steps} vs "
                f"{r.eval_steps}")
    if base_r.eval_steps != [10, 20, 30, 40] or len(base_r.sranks) != 8:
        raise AssertionError(f"eval steps {base_r.eval_steps}, sranks "
                             f"{base_r.sranks}")
    log(f"[graph] chunking: Experiment.run loop='scan' as 17 + 23 "
        f"supersteps == one call of 40 == loop='python', bitwise on every "
        f"state tensor and the generator; returns {base_r.returns} at "
        f"{base_r.eval_steps}, sranks {base_r.sranks} equal ("
        + ", ".join(f"{k} {v[2]:.1f}s" for k, v in runs.items()) + ")")

    # the epilogue's srank against the CPU's on the same features: the last
    # chunk (35-40) took it from the graph's static q_features
    tr40 = runs["40"][0].trainer
    feats = tr40.graph.metrics["q_features"].cpu()
    cpu = int(effective_rank(feats))
    sig = np.linalg.svd(feats.double().numpy(), compute_uv=False)
    margin = float(np.min(np.abs(np.cumsum(sig) / sig.sum() - 0.99)))
    if cpu != runs["40"][1].sranks[-1]:
        raise AssertionError(f"epilogue srank {runs['40'][1].sranks[-1]} "
                             f"!= CPU effective_rank {cpu} (nearest "
                             f"cumulative share {margin:.2e} from 0.99)")
    log(f"[graph] srank: the epilogue's {cpu} at step 40 == effective_rank "
        f"on the CPU over the same q_features {tuple(feats.shape)} (nearest"
        f" cumulative share {margin:.2e} from 1 - delta)")
    whole = runs["40"][0]
    del runs, base_e, e, tr40
    gc.collect()
    torch.cuda.empty_cache()
    graph_checkpoint(spec, "graph", whole)
    del whole
    for other in ckpt_specs:
        graph_checkpoint(other, "graph")


def phase_td3(spec):
    """TD3 training on the card at the training phase's full width: one
    superstep against the CPU plain path, the launches of the warm-up and
    the captured superstep against ``expected_launches``, ``GRAPH_K``
    replays (both delay parities) bitwise against eager supersteps, the
    launches of ``GRAPH_TIMED`` eager supersteps counted from 0, both
    loops' wall in turns, a replay's device time and profile. Returns
    those launches; the eager loop's profile too."""
    import gc
    import torch
    from repro_torch.rl.experiment import Experiment
    from repro_torch.rl.runner import clone_state
    exp = Experiment.from_spec(spec.override(loop="scan"))
    tr = exp.trainer
    want = expected_launches(tr)
    t0 = time.perf_counter()
    exp._ensure_init()
    torch.cuda.synchronize()
    log(f"[td3] fig10-ablation large, algo td3, paper budget: "
        f"{tr.n_params} params, {tr.n_actors} actors, batch "
        f"{tr.batch_size}, capacity {tr.dcfg.capacity}; warm-up "
        f"{int(exp._ls.replay['store']['count'])} transitions in "
        f"{time.perf_counter() - t0:.2f}s")
    phase_train_parity(spec, exp, tag="td3")
    ls0 = clone_state(exp._ls)
    graph = graph_capture(tr, ls0, want, "td3")
    eager, replayed = graph_bitwise(tr, ls0, "td3")
    steps = eager.agent["step"]
    if int(steps) != GRAPH_K or int(eager.agent["opt"]["actor"]["count"]) \
            != (GRAPH_K + 1) // 2:
        raise AssertionError(f"after {GRAPH_K} supersteps: step "
                             f"{int(steps)}, actor AdamW count "
                             f"{int(eager.agent['opt']['actor']['count'])}")
    vals = torch.stack([v for k, v in tr.graph.metrics.items()
                        if k in train_keys(spec)])
    if not torch.all(torch.isfinite(vals)):
        raise AssertionError("TD3 training produced a non-finite loss")
    # the launches of GRAPH_TIMED eager supersteps, counted from 0 (the
    # training phase counts SAC's over as many)
    torch.cuda.synchronize()
    _reset_counts()
    for _ in range(GRAPH_TIMED):
        eager, _, _ = tr.step(eager)
    torch.cuda.synchronize()
    launches = _counts()
    if any(launches[k] != want[k] * GRAPH_TIMED for k in want) \
            or not all(launches[k] for k in want if want[k]):
        raise AssertionError(f"TD3 launches over {GRAPH_TIMED} eager "
                             f"supersteps {launches}, want {want} each")
    log(f"[td3] {GRAPH_TIMED} eager supersteps from step "
        f"{int(eager.step) - GRAPH_TIMED}: launches {launches} = "
        f"{GRAPH_TIMED} x expected_launches")
    graph_walls(tr, eager, replayed, "td3")
    eager_profile(tr, eager, "td3")
    graph_device_time(graph, "td3", "td3")
    del exp, tr, graph, eager, replayed, ls0
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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
        narrow = stack.whole_bwd_smem(d0, u, L) is not None
        t_o = t_o2 = None

        def old(_):                 # the per-layer kernels
            return stack._kernel_backward((out, zs), ws, g, "densenet",
                                          "swish", True, need, need,
                                          whole=False)
        if narrow:
            t_o, _ = time_ms(old, [0])
        t_k, h_k = time_ms(kernel, [0])
        t_p, _ = time_ms(plain, [0])
        t_l, _ = time_ms(library, [0])
        t_k2, _ = time_ms(kernel, [0])
        if narrow:
            t_o2, _ = time_ms(old, [0])
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
        if narrow:
            r["old_layers_ms"] = min(t_o, t_o2)
        log(f"[time] backward {name} M={m} d0={d0} U={u} L={L}"
            f"{' (whole-stack)' if narrow else ''}: kernel "
            f"{r['ms'] * 1e3:8.1f} us (runs {t_k * 1e3:.1f}/"
            f"{t_k2 * 1e3:.1f}), plain {t_p * 1e3:8.1f} us, library "
            f"{t_l * 1e3:8.1f} us, bound {bound_ms * 1e3:6.1f} us "
            f"({r['bound_by']}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
            f"GFLOP), {100 * bound_ms / r['ms']:.0f}% of bound, max abs err "
            f"{err:.2e}"
            + ("" if not narrow else f"; the per-layer kernels "
               f"{r['old_layers_ms'] * 1e3:.1f} us (runs {t_o * 1e3:.1f}/"
               f"{t_o2 * 1e3:.1f}), new / old "
               f"x{r['ms'] / r['old_layers_ms']:.3f}"))
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


def _ssd_chunk_inputs(gen, g, h, q, n, p, dtype, pad=0):
    """c, b, x, cum, dt, state, D on the card; pad > 0: x a view of rows
    p + pad wide (no 16-byte copies)."""
    import torch
    import torch.nn.functional as F
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    c, b, x = rnd(g, q, n).to(dtype), rnd(g, q, n).to(dtype), \
        rnd(g, h, q, p + pad)[..., :p].to(dtype)
    cum = torch.cumsum(-F.softplus(rnd(g, h, q)), -1)
    return c, b, x, cum, F.softplus(rnd(g, h, q)), rnd(g, h, p, n), rnd(h)


def _ssd_seq_inputs(gen, b, s, h, p, n):
    import torch
    import torch.nn.functional as F
    rnd = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    return (rnd(b, s, h, p), rnd(b, s, n), rnd(b, s, n),
            F.softplus(rnd(b, s, h)), 0.3 * rnd(h), rnd(h))


def phase_ssd_parity(gen):
    """ssd_chunk_dual against the plain version at chunk 8, a ragged 100,
    256 and 1024, H=3, N=4 with P=8, P=100 and 128, and x views without
    16-byte rows, float32 and bfloat16, one launch a call; the whole
    ssd_chunked_kernel against the plain ssd_chunked + D x at chunk 8 and
    256."""
    import torch
    from repro_torch.kernels.ssd_scan import ops, ref, ssd_scan
    s = SSD_FULL
    # (G, H, Q, N, P, pad): pad > 0, x rows p + pad wide (4- or 8-byte
    # copies)
    chunks = ((4, 2, 8, 4, 16, 0), (3, 2, 100, 24, 40, 0),
              (s["b"] * s["s"] // 256, s["h"], 256, s["n"], s["p"], 0),
              (2, 3, 1024, 64, 64, 0), (3, 3, 100, 4, 8, 0),
              (2, 5, 300, 64, 128, 0), (2, 3, 130, 32, 100, 0),
              (3, 3, 200, 64, 64, 3), (2, 4, 96, 16, 40, 2))
    worst = {}
    for dname, rtol in NEW_RTOL.items():
        dtype = getattr(torch, dname)
        for *shape, pad in chunks:
            args = _ssd_chunk_inputs(gen, *shape, dtype, pad)
            before = ssd_scan.launch_count()
            got = ssd_scan.ssd_chunk_dual(*args)
            if ssd_scan.launch_count() - before != 1:
                raise AssertionError("ssd_chunk_dual did not launch once")
            want = ref.ssd_chunk_dual_ref(*args)
            ok, err = close_enough(got.float(), want.float(), rtol)
            worst[dname] = max(worst.get(dname, 0.0), err)
            if not ok:
                raise AssertionError(f"ssd kernel != plain: {dname} (G, H, Q,"
                                     f" N, P)={tuple(shape)} pad {pad}: "
                                     f"{err:.3e}")
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
    log(f"[parity] ssd_chunk_dual == plain at (G, H, Q, N, P, x pad) "
        f"{chunks}, one launch each; "
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
    B=2 S=2048 (G=16 cells) H=16 Q=256 N=P=64, float32 (bound: the larger
    of its bytes and 3 x its operations at the TF32 rate, the kernel's
    3xTF32) and bfloat16 (its operations at the bf16 rate); no library
    call; C B^T counted once per cell (the heads share it); the fp32 SIMT
    bound logged beside."""
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
    tri = qq * (qq + 1) // 2
    flops = g * 2 * s["n"] * tri + g * s["h"] * (
        2 * s["p"] * tri + 2 * qq * s["p"] * s["n"] + 2 * qq * s["p"])
    name = f"ssd_chunk_dual G={g} H={s['h']} Q={qq} N={s['n']} P={s['p']}"
    for dname, rtol in NEW_RTOL.items():
        dtype = getattr(torch, dname)
        args = _ssd_chunk_inputs(gen, g, s["h"], qq, s["n"], s["p"], dtype)
        _, err = close_enough(ssd_scan.ssd_chunk_dual(*args).float(),
                              sref.ssd_chunk_dual_ref(*args).float(), rtol)
        e = args[0].element_size()              # c, b, x and y's bytes
        nbytes = e * (2 * g * qq * s["n"] + 2 * g * s["h"] * qq * s["p"]) \
            + 4 * (2 * g * s["h"] * qq + g * s["h"] * s["p"] * s["n"]
                   + s["h"])
        split = dname == "float32"
        r = _time_row(
            f"{name} {dname} ({'3xTF32' if split else 'TF32, bf16 exact'})",
            lambda _: ssd_scan.ssd_chunk_dual(*args),
            lambda _: sref.ssd_chunk_dual_ref(*args), None, [0], nbytes,
            3 * flops if split else flops, err,
            peak=TF32_FLOPS_PER_S if split else BF16_FLOPS_PER_S)
        if split:
            rows["ssd_chunk_dual"] = r
            log(f"[time]   ssd fp32: kernel {r['ms'] * 1e3:.1f} us; bound "
                f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}: "
                f"{nbytes / 1e6:.1f} MB at 3.35 TB/s, 3 x "
                f"{flops / 1e9:.2f} GFLOP of TF32 at 495 TFLOP/s "
                f"{3e6 * flops / TF32_FLOPS_PER_S:.1f} us), fp32 SIMT "
                f"{_bound(nbytes, flops)[0] * 1e3:.1f} us (at 67 TFLOP/s)")
        else:
            rows["ssd_chunk_dual"]["bf16"] = r
            log(f"[time]   ssd bf16: kernel {r['ms'] * 1e3:.1f} us; bound "
                f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}: "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at 989 "
                f"TFLOP/s, bf16 tensor)")
    return rows


OBS_STEPS = 40      # supersteps of the observed runs held bitwise
WALL_CHUNKS = 8     # chunks of 5 a timed run (run(5) each)


def _free():
    """Give the card's memory of runs already dropped back."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _obs_spec(spec, log_dir, **kw):
    return spec.override(**{"obs.enabled": True, "obs.sinks": ("jsonl",),
                            "obs.log_dir": log_dir, **kw})


def obs_bitwise(spec, tmp, want):
    """40 supersteps under the graph with obs on (jsonl, every step, a
    trace of the first chunk; chunks of 10, srank at their ends) against
    obs off: bitwise on the state; the jsonl's train rows against the
    eager loop's per-step metrics (memory sink), bitwise; the kernels of
    the path counted from 0 (the warm-up and the capture launch them, the
    replays do not pass the wrappers); the trace's status and its chunk
    span."""
    import torch
    from repro_torch.obs.report import load_rows
    from repro_torch.rl.experiment import Experiment
    cspec = spec.override(loop="scan", srank_every=10)
    off = Experiment.from_spec(cspec)
    off.run(OBS_STEPS)
    run_dir = os.path.join(tmp, "obs")
    on = Experiment.from_spec(_obs_spec(cspec, run_dir, **{
        "obs.log_every": 1, "obs.trace": 1}))
    on._ensure_init()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    on.run(OBS_STEPS)
    torch.cuda.synchronize()
    t_on = time.perf_counter() - t0
    launches = _counts()
    on.close()
    if launches != {k: 2 * v for k, v in want.items()} \
            or not all(launches[k] for k in ("fwd", "bwd", "sample", "set")):
        raise AssertionError(f"observed run's launches {launches}, want 2 x "
                             f"{want} (warm-up and capture)")
    bad = state_diff(off._ls, on._ls)
    if bad or on.sranks != off.sranks:
        raise AssertionError(f"obs on != obs off after {OBS_STEPS} "
                             f"supersteps: state {bad[:8]}, sranks "
                             f"{on.sranks} vs {off.sranks}")
    del off
    _free()
    eager = Experiment.from_spec(cspec.override(
        loop="python", **{"obs.enabled": True, "obs.sinks": ("memory",),
                          "obs.log_every": 1}))
    eager.run(OBS_STEPS)
    eager.close()
    rows = load_rows(run_dir)
    train = [r for r in rows if r["kind"] == "train"]
    want_rows = [r for r in eager.obs.rows if r["kind"] == "train"]
    if train != want_rows or len(train) != OBS_STEPS:
        diff = [(a["step"], k) for a, b in zip(train, want_rows)
                for k in a if a[k] != b.get(k)]
        raise AssertionError(f"jsonl train rows != the eager loop's per-step"
                             f" metrics ({len(train)} vs {len(want_rows)} "
                             f"rows; first differences {diff[:6]})")
    trace = on.obs.trace
    text = open(trace.path).read() if trace.path else ""
    if trace.status != "done" or "repro.chunk_dispatch" not in text:
        raise AssertionError(f"trace status {trace.status!r}, file "
                             f"{trace.path}, chunk span "
                             f"{'repro.chunk_dispatch' in text}")
    keys = sorted(k for k in train[0] if k not in ("kind", "step"))
    log(f"[obs] {OBS_STEPS} supersteps under the graph with obs on (jsonl, "
        f"log_every 1, trace 1; {t_on:.2f}s with the capture and the "
        f"trace) == obs off, bitwise on every state tensor and the "
        f"generator, sranks {on.sranks}; the jsonl's {len(train)} train "
        f"rows == the eager loop's per-step metrics, bitwise ({len(keys)} "
        f"keys: {', '.join(keys)}); launches at warm-up and capture "
        f"{launches} = 2 x expected_launches; trace {trace.status}, "
        f"{os.path.getsize(trace.path)} bytes with repro.chunk_dispatch")
    del on, eager
    _free()


def td3_stream_keys(spec, tmp):
    """The stream's keys of a TD3 run under the graph: the reference's
    (no ``alpha``; the grad-norm and update-ratio taps of all three
    nets)."""
    from repro_torch.rl.experiment import Experiment
    exp = Experiment.from_spec(spec.override(
        algo="td3", loop="scan", **{"obs.enabled": True, "obs.log_every": 1,
                                    "obs.sinks": ("memory",)}))
    exp.run(5)
    exp.close()
    train = [r for r in exp.obs.rows if r["kind"] == "train"]
    keys = {k for k in train[0] if k not in ("kind", "step")}
    want = {"critic_loss", "actor_loss", "aux_loss", "q_mean", "td_error",
            "staleness_mean", "staleness_p50", "staleness_max",
            *(f"{p}_{n}" for p in ("grad_norm", "update_ratio")
              for n in ("actor", "critics", "ofenet"))}
    vals = np.array([[r[k] for k in sorted(keys)] for r in train])
    if keys != want or len(train) != 5 or not np.all(np.isfinite(vals)):
        raise AssertionError(f"TD3 stream keys {sorted(keys)} (want "
                             f"{sorted(want)}), {len(train)} rows, finite "
                             f"{bool(np.all(np.isfinite(vals)))}")
    log(f"[obs] td3 under the graph: 5 train rows, keys == the reference's "
        f"({len(keys)}: no alpha), all finite")
    del exp
    _free()


def obs_guard_walls(spec, tmp):
    """Wall per superstep under the graph in chunks of 5 (``run(5)``, no
    eval or srank inside), host clock, in turns: obs and guard off; obs on
    (jsonl, log_every 5; the grad-norm taps on, the default); obs on with
    the taps off; the guard on (policy skip: a state clone and a
    finiteness pass a chunk)."""
    import torch
    from repro_torch.rl.experiment import Experiment
    cspec = spec.override(loop="scan")
    kinds = {
        "off": cspec,
        "obs": _obs_spec(cspec, os.path.join(tmp, "w1"),
                         **{"obs.log_every": 5}),
        "obs-no-taps": _obs_spec(cspec, os.path.join(tmp, "w2"),
                                 **{"obs.log_every": 5,
                                    "obs.grad_norms": False}),
        "guard": cspec.override(**{"guard.enabled": True,
                                   "guard.policy": "skip"}),
    }
    exps = {}
    for k, s in kinds.items():
        exps[k] = Experiment.from_spec(s)
        exps[k].run(5)                      # warm-up + capture
    torch.cuda.synchronize()
    walls = {k: [] for k in kinds}
    order = list(kinds)
    for k in order + order[::-1]:
        exp = exps[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WALL_CHUNKS):
            exp.run(5)
        torch.cuda.synchronize()
        walls[k].append(1e3 * (time.perf_counter() - t0)
                        / (5 * WALL_CHUNKS))
    for exp in exps.values():
        exp.close()
    base = np.mean(walls["off"])
    log(f"[obs] wall per superstep under the graph, run(5) x "
        f"{WALL_CHUNKS} a timing, in turns: " + "; ".join(
            f"{k} {', '.join(f'{w:.3f}' for w in v)} ms (mean "
            f"{np.mean(v):.3f}, {100 * (np.mean(v) / base - 1):+.1f}%)"
            for k, v in walls.items() if k != "guard"))
    log(f"[guard] wall per superstep under the graph, policy skip, the same"
        f" turns: {', '.join(f'{w:.3f}' for w in walls['guard'])} ms (mean "
        f"{np.mean(walls['guard']):.3f}, "
        f"{100 * (np.mean(walls['guard']) / base - 1):+.1f}% against off "
        f"{base:.3f})")
    n = exps["guard"].step
    if any(e.step != n for e in exps.values()) \
            or state_diff(exps["off"]._ls, exps["guard"]._ls) \
            or state_diff(exps["off"]._ls, exps["obs"]._ls):
        raise AssertionError("timed runs with obs or the guard on left "
                             "another state than the run with both off")
    log(f"[guard] after {n} supersteps each: obs on, the guard on and both "
        f"off end in the same state, bitwise")
    del exps, exp
    _free()


def guard_halt(spec):
    """``arm_nan_step(at_step=10)`` under the graph: the guard halts and
    names step 11, the first superstep whose params are NaN."""
    from repro_torch.guard import GuardViolation, chaos
    from repro_torch.rl.experiment import Experiment
    exp = Experiment.from_spec(spec.override(
        loop="scan", **{"guard.enabled": True, "guard.policy": "halt"}))
    chaos.arm_nan_step(exp.trainer, at_step=10)
    try:
        exp.run(20)
    except GuardViolation as gv:
        steps = sorted({v.step for v in gv.violations})
        reasons = sorted({v.reason for v in gv.violations})
    else:
        raise AssertionError("a NaN at agent step 10 did not halt the run")
    if steps[0] != 11 or "nonfinite_stream" not in reasons \
            or exp.trainer.captures != 1:
        raise AssertionError(f"halt at steps {steps} ({reasons}), "
                             f"{exp.trainer.captures} captures")
    log(f"[guard] arm_nan_step(at_step=10) under the graph: halt, "
        f"violations at steps {steps} ({', '.join(reasons)})")
    del exp
    _free()


def guard_rollback(spec, tmp):
    """A rollback from a ``DurableStore`` holding the full state against
    its reconstruction (``Experiment.restore`` + ``fold_in(gen, 1)`` +
    the rest of the run), bitwise; the store's save and sha256 seconds.
    Returns the run's store and spec (the watcher's checkpoints)."""
    import torch
    from repro_torch.guard import DurableStore, chaos, fold_in
    from repro_torch.rl.experiment import Experiment
    gspec = spec.override(loop="scan", eval_every=10, **{
        "guard.enabled": True, "guard.policy": "rollback"})
    store = DurableStore(os.path.join(tmp, "ckpts"), keep=2)
    exp = Experiment.from_spec(gspec)
    exp.attach_guard(store)
    exp.run(10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = store.save(lambda p: exp.save(p), exp.step)
    t_save = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in path.iterdir())
    t0 = time.perf_counter()
    store.verify(path)
    t_verify = time.perf_counter() - t0
    chaos.poison_params(exp)
    t0 = time.perf_counter()
    exp.run(10)                      # detect at 11, roll back to 10, rerun
    torch.cuda.synchronize()
    t_rb = time.perf_counter() - t0
    if exp._monitor.recoveries != 1 or exp.step != 20:
        raise AssertionError(f"rollback: {exp._monitor.recoveries} "
                             f"recoveries, step {exp.step}")
    ref = Experiment.restore(DurableStore.payload(path))
    fold_in(ref._ls.gen, 1)
    ref.run(10)
    torch.cuda.synchronize()
    bad = state_diff(exp._ls, ref._ls)
    if bad or exp.returns != ref.returns:
        raise AssertionError(f"rollback != restore + fold_in + rerun: state "
                             f"{bad[:8]}, returns {exp.returns} vs "
                             f"{ref.returns}")
    log(f"[guard] rollback from a DurableStore of the full state (step 10, "
        f"{nbytes / 1e6:.1f} MB): == Experiment.restore + fold_in(gen, 1) + "
        f"run(10), bitwise on every state tensor and the generator, "
        f"returns {exp.returns}; DurableStore.save {t_save:.2f}s (npz + "
        f"sha256 manifest + rename), verify {t_verify:.2f}s, the rolled "
        f"back run(10) {t_rb:.2f}s")
    del ref
    _free()
    return exp, store


def guard_supervisor(tmp, over=("replay.backend=device",), tag="guard"):
    """``python -m repro_torch.guard.supervise smoke`` on the card with
    ``kill-in-save@6`` (saves every 3: the worker dies committing step 6
    and resumes from step 3) against an uninterrupted in-process card run
    of the same spec: the same ``params_sha256``. ``over`` are the
    worker's ``--override`` pairs (none: the preset's own host replay)."""
    from repro_torch.guard import supervise
    from repro_torch.rl import presets
    from repro_torch.rl.experiment import Experiment
    run_dir = os.path.join(tmp, f"sup-{tag}")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.guard.supervise", "smoke",
           "--dir", run_dir, "--steps", "12", "--save-every", "3",
           "--retries", "2", "--backoff", "0.1", "--chaos", "kill-in-save@6"]
    for o in over:
        cmd += ["--override", o]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"supervise exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    with open(os.path.join(run_dir, "result.json")) as f:
        res = json.load(f)
    with open(os.path.join(run_dir, "incident.json")) as f:
        inc = json.load(f)
    ref = Experiment.from_spec(presets.get("smoke").override(**{
        o.split("=")[0]: o.split("=")[1] for o in over}))
    ref.run(12)
    digest = supervise._digest(ref._ls.agent["params"])
    att = inc["attempts"]
    if res["params_sha256"] != digest or res["step"] != 12 \
            or att[0].get("signal") != "SIGKILL" or len(att) != 2 \
            or res["resumed_from"] != 3 \
            or res["returns"] != [float(r) for r in ref.returns]:
        raise AssertionError(f"supervised run {res} (attempts {att}) != "
                             f"uninterrupted card run {digest}, returns "
                             f"{ref.returns}")
    log(f"[{tag}] supervise smoke on the card "
        f"({' '.join(over) or 'no override: the host replay'}), "
        f"kill-in-save@6: attempt 0 "
        f"{att[0]['signal']} after {att[0]['wall_s']:.2f}s, attempt 1 "
        f"resumed from step {res['resumed_from']} and finished in "
        f"{att[1]['wall_s']:.2f}s (the resume: a new worker process, its "
        f"card context, the restore and 9 supersteps); {wall:.1f}s in all;"
        f" params_sha256 {res['params_sha256'][:16]}... == the "
        f"uninterrupted card run's, returns {res['returns']} equal")
    del ref
    _free()


def serve_watch(exp, store):
    """``PolicyServer.watch`` on the rollback run's store: 4 clients served
    while the run commits a new checkpoint (step 20, the full state); the
    watcher verifies it and swaps it in between ticks. Every response
    equals the plain path under the generation stamped on it (1e-4)."""
    from repro_torch.launch.serve_policy import PolicyServer, ServeConfig
    from repro_torch.rl.policy import Policy, load_params
    path = store.checkpoints()[-1]
    spec, params = load_params(store.payload(path))
    pol = Policy.from_spec(spec, params)
    server = PolicyServer(pol, ServeConfig(max_batch=32, poll_s=0.05))
    server.start().watch(store, spec, seen_step=store.step_of(path))
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((4, 64, pol.obs_dim)).astype(np.float32)
    out = [[] for _ in range(4)]
    stop = threading.Event()

    def client(c):
        i = 0
        while not stop.is_set() or i < 64:
            t = server.submit_async(obs[c][i % 64])
            out[c].append((i % 64, t.result(timeout=120.0), t.generation))
            i += 1

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    new_params = {k: v for k, v in exp._ls.agent["params"].items()}
    t0 = time.perf_counter()
    store.save(lambda p: exp.save(p), exp.step)
    t_commit = time.perf_counter() - t0
    deadline = time.perf_counter() + 120.0
    while server.generation != 1:
        if time.perf_counter() > deadline:
            raise AssertionError("the watcher did not adopt the checkpoint")
        time.sleep(0.01)
    t_adopt = time.perf_counter() - t0
    time.sleep(0.2)
    stop.set()
    for t in threads:
        t.join(timeout=300.0)
        if t.is_alive():
            raise AssertionError("client thread hung")
    server.close()
    cpu = {g: pol.with_params(p).to("cpu") for g, p in
           ((0, params), (1, new_params))}
    want = {(g, c): cpu[g].act_deterministic(obs[c]).numpy()
            for g in cpu for c in range(4)}
    gens, err = set(), 0.0
    for c in range(4):
        seen = [g for _, _, g in out[c]]
        if seen != sorted(seen):
            raise AssertionError(f"client {c}: generations went back")
        for i, a, g in out[c]:
            gens.add(g)
            err = max(err, float(np.abs(a - want[(g, c)][i]).max()))
    if gens != {0, 1} or err > 1e-4 or server.stats["swaps"] != 1 \
            or server.stats["bad_checkpoints"]:
        raise AssertionError(f"watch: generations {gens}, max abs err "
                             f"{err:.3e} vs the plain path under each "
                             f"response's generation, {server.stats['swaps']}"
                             f" swaps, {server.stats['bad_checkpoints']} bad")
    n = sum(len(o) for o in out)
    log(f"[serve-watch] {n} requests from 4 clients while the run committed"
        f" step {exp.step} ({t_commit:.2f}s: npz + sha256 + rename); the "
        f"watcher verified and adopted it {t_adopt:.2f}s after the commit "
        f"began; every response within {err:.1e} of the plain path under "
        f"its stamped generation (0 and 1), none mixed; "
        f"{server.stats['ticks']} ticks, 1 swap")
    del exp, pol, server
    _free()


def phase_obs_guard(spec):
    """The slice's path: obs and the guard around the graph's training, at
    the training phase's full width (SAC; TD3 once for the stream's keys),
    then the supervisor at the smoke preset and the checkpoint watcher."""
    import tempfile
    from repro_torch.rl.experiment import Experiment
    want = expected_launches(Experiment.from_spec(spec).trainer)
    with tempfile.TemporaryDirectory() as tmp:
        obs_bitwise(spec, tmp, want)
        td3_stream_keys(spec, tmp)
        obs_guard_walls(spec, tmp)
        guard_halt(spec)
        serve_watch(*guard_rollback(spec, tmp))
        guard_supervisor(tmp)


FLEET_E = 5          # the paper's seeds a width (benchmarks/fig3_width.py)
FLEET_SMOKE_E = 8
FLEET_STEPS = 40


def fleet_state_diff(a, b):
    """``state_diff`` of two fleet states: every tensor and every member's
    generator."""
    import torch
    bad = [(name, float((x.double() - y.double()).abs().max()))
           for (name, x), (_, y) in zip(_state_names(a), _state_names(b))
           if not torch.equal(x, y)]
    bad += [(f"gen[{m}]", float("nan")) for m, (g, h) in
            enumerate(zip(a.gen, b.gen))
            if not torch.equal(g.get_state(), h.get_state())]
    return bad


def member_diff(a, b, members):
    """``fleet_state_diff`` restricted to the slices of ``members``."""
    import torch
    bad = []
    for (name, x), (_, y) in zip(_state_names(a), _state_names(b)):
        for m in members:
            if not torch.equal(x[m], y[m]):
                bad.append((f"{name}[{m}]", float(
                    (x[m].double() - y[m].double()).abs().max())))
    bad += [(f"gen[{m}]", float("nan")) for m in members
            if not torch.equal(a.gen[m].get_state(), b.gen[m].get_state())]
    return bad


def phase_fleet_tree(gen, e=FLEET_E, capacity=100_000, b=256, ns=(32, 256),
                     tag="fleet-tree"):
    """The sum-tree kernels with a member axis: E full trees of capacity
    100,000 (2^18 nodes each), B=256 targets a member (edge targets 0 and
    total), writes of n=32 and 256 a member with repeats (a sharded
    replay's: E shards, their capacity, batch and writes). One batched
    launch against E solo launches and against the plain versions over the
    member axis, bitwise; a batched write with indices outside the leaves
    in one member skips and counts exactly those. Then times, hot and
    cold: the batched launch against E solo launches, and at E=1 the
    member entry against the solo one, each beside the bytes bound (the
    solo bound times E). Returns ``{"sample": .., "set<n>": ..}`` records
    for the kernel line's ``fleet`` entries."""
    import torch
    from repro_torch.kernels.replay_tree import ops, ref
    from repro_torch.launch.bwd_sweep import l2_flusher, time_per_call_us
    trees = torch.stack([tree_case(gen, capacity) for _ in range(e)])
    depth = trees.shape[1].bit_length() - 1
    t = torch.rand((e, b), generator=gen, device="cuda") * trees[:, 1:2]
    t[:, 0], t[:, 1] = 0.0, trees[:, 1]
    before = ops.launch_count("sample")
    leaf, pri = ops.sumtree_sample_members(trees, t, capacity=capacity)
    if ops.launch_count("sample") - before != 1:
        raise AssertionError("tree_sample_members did not launch once")
    solo = [ops.sumtree_sample(trees[m], t[m], capacity=capacity)
            for m in range(e)]
    want = ref.tree_sample_members_ref(trees, t, capacity=capacity)
    if not (torch.equal(leaf, torch.stack([s[0] for s in solo]))
            and torch.equal(pri, torch.stack([s[1] for s in solo]))
            and torch.equal(leaf, want)
            and torch.equal(pri, ref.tree_get_members_ref(trees, want))):
        raise AssertionError("tree_sample_members != E solo launches / "
                             "plain")
    writes = {}
    for n in ns:
        idx = torch.randint(0, capacity, (e, n), generator=gen,
                            device="cuda")
        idx[:, n // 2:] = idx[:, :n - n // 2]          # every index twice
        val = torch.rand((e, n), generator=gen, device="cuda") * 2
        got = trees.clone()
        before = ops.launch_count("set")
        ops.sumtree_set_members(got, idx, val)
        if ops.launch_count("set") - before != 1:
            raise AssertionError("tree_set_members did not launch once")
        solo_t = trees.clone()
        for m in range(e):
            ops.sumtree_set(solo_t[m], idx[m], val[m])
        want_t = ref.tree_set_members_ref(trees.clone(), idx, val)
        if not (torch.equal(got, solo_t) and torch.equal(got, want_t)):
            raise AssertionError(f"tree_set_members n={n} != E solo "
                                 f"launches / plain")
        writes[n] = (idx.to(torch.int32).contiguous(), val)
    half = trees.shape[1] // 2
    idx = torch.randint(0, capacity, (e, 64), generator=gen, device="cuda")
    idx[3, ::16] = torch.tensor([-1, half, 1 << 30, -half], device="cuda")
    valid = (idx >= 0) & (idx < half)
    val = torch.rand(idx.shape, generator=gen, device="cuda")
    before = ops.skipped_writes("cuda")
    got = ops.sumtree_set_members(trees.clone(), idx, val)
    skipped = ops.skipped_writes("cuda") - before
    want_t = trees.clone()
    for m in range(e):
        ref.tree_set_ref(want_t[m], idx[m][valid[m]], val[m][valid[m]])
    if skipped != int((~valid).sum()) or not torch.equal(got, want_t):
        raise AssertionError(f"tree_set_members with {int((~valid).sum())} "
                             f"indices outside the leaves: {skipped} "
                             f"skipped")
    log(f"[{tag}] E={e} trees of 2^{depth} nodes: tree_sample_members "
        f"(B={b} a member, edge targets 0 and total) and tree_set_members "
        f"(n={' and '.join(map(str, ns))} a member, each index twice: "
        f"keep-last) are one "
        f"launch each, bitwise {e} solo launches and the plain versions "
        f"over the member axis; {skipped} indices outside the leaves in "
        f"member 3 skipped and counted")

    flush = l2_flusher("cuda")
    one_t = trees[:1].contiguous()

    def timed(fn):
        hot, host = time_ms(fn, [0])
        return dict(ms=hot, host_ms=host,
                    hot_call_ms=time_per_call_us(lambda: fn(0)) / 1e3,
                    cold_ms=time_per_call_us(lambda: fn(0), flush) / 1e3)
    sample_bytes = 4 * b * (depth - 1) + 4 * b + 8 * b
    out = {}
    r = {"batched": timed(lambda _: ops.sumtree_sample_members(
             trees, t, capacity=capacity)),
         "solo_x_e": timed(lambda _: [ops.sumtree_sample(
             trees[m], t[m], capacity=capacity) for m in range(e)]),
         "e1_members": timed(lambda _: ops.sumtree_sample_members(
             one_t, t[:1], capacity=capacity)),
         "e1_solo": timed(lambda _: ops.sumtree_sample(
             one_t[0], t[0], capacity=capacity))}
    out["sample"] = dict(r, E=e, B=b, bound_ms=1e3 * e * sample_bytes
                         / HBM_BYTES_PER_S, bound_by="bytes")
    for n, (idx, val) in writes.items():
        work, one = trees.clone(), trees[:1].clone()
        touched = sum(_tree_nodes(trees[m], idx[m]) for m in range(e))
        r = {"batched": timed(lambda _: ops.sumtree_set_members(
                 work, idx, val)),
             "solo_x_e": timed(lambda _: [ops.sumtree_set(
                 work[m], idx[m], val[m]) for m in range(e)]),
             "e1_members": timed(lambda _: ops.sumtree_set_members(
                 one, idx[:1], val[:1])),
             "e1_solo": timed(lambda _: ops.sumtree_set(
                 one[0], idx[0], val[0]))}
        out[f"set{n}"] = dict(r, E=e, n=n, bound_ms=1e3 * (
            8 * n * e + 4 * touched) / HBM_BYTES_PER_S, bound_by="bytes")
    for name, rec in out.items():
        log(f"[{tag}] {name} E={e}: " + "; ".join(
            f"{k} hot {rec[k]['ms'] * 1e3:.2f} us (per call "
            f"{rec[k]['hot_call_ms'] * 1e3:.2f}), cold "
            f"{rec[k]['cold_ms'] * 1e3:.2f} us"
            for k in ("batched", "solo_x_e", "e1_members", "e1_solo"))
            + f"; bytes bound {rec['bound_ms'] * 1e6:.1f} ns (the solo "
              f"bound x {e})")
    return out


def fleet_spec():
    """The paper's widest Fig. 3 row as a fleet: ``fig3-width`` at the
    paper budget, 2048 units, the device replay on its kernels, the scan
    loop."""
    from repro_torch.rl import presets
    return presets.get("fig3-width").override(
        **PAPER_BUDGET, num_units=2048, replay_backend="device",
        loop="scan")


def param_rel_diff(fleet_params, solo_params, m=0):
    """``(worst, ratio, top)``: over the param leaves, the largest
    ``max|member - solo| / max|solo|``; the largest elementwise ``|member -
    solo| / (atol + rtol |solo|)`` at the reference's member-vs-solo
    tolerance (<= 1 passes); the three worst leaves as ``(name, rel, max
    abs diff, max|solo|)``."""
    from repro_torch.rl.sweep import SOLO_PARITY_ATOL, SOLO_PARITY_RTOL
    worst, ratio, rows = 0.0, 0.0, []
    for (name, f), s in zip(_named(fleet_params), _leaves(solo_params)):
        d = (f[m].double() - s.double()).abs()
        mx = float(s.abs().max())
        rel = float(d.max()) / max(mx, 1e-30)
        worst = max(worst, rel)
        rows.append((name, rel, float(d.max()), mx))
        ratio = max(ratio, float((d / (SOLO_PARITY_ATOL + SOLO_PARITY_RTOL
                                       * s.double().abs())).max()))
    top = [f"{n} {r:.2e} ({a:.2e} of {x:.2e})" for n, r, a, x in
           sorted(rows, key=lambda r: -r[1])[:3]]
    return worst, ratio, top


def _named(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{path}/{i}")
    else:
        yield path, tree


def walls_in_turns(graphs, tag, reps=GRAPH_TIMED):
    """Host wall per replay of each named graph, in turns (a b b a)."""
    import torch
    order = list(graphs) + list(graphs)[::-1]
    walls = []
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphs[name].replay(reps)
        torch.cuda.synchronize()
        walls.append((name, 1e3 * (time.perf_counter() - t0) / reps))
    log(f"[{tag}] wall per replay, host clock, {reps} replays a run, in "
        f"turns: " + ", ".join(f"{k} {ms:.3f} ms" for k, ms in walls))
    return {k: float(np.mean([ms for n, ms in walls if n == k]))
            for k in graphs}


def fleet_training(gen):
    """The ``fig3-width`` U=2048 fleet of ``FLEET_E`` seeds under one CUDA
    graph against a solo ``Experiment`` of seed 0, its replays against
    eager vmapped supersteps, resume at a split, the done mask, and the
    walls beside the solo run's. Returns the wrapper launches counted over
    the fleet run (init, 40 supersteps, the eval at the end), its wall per
    replay, the fleet (its graph kept for ``phase_fleet_fused``'s walls in
    turns) and a copy of its state after the init and warm-up."""
    import tempfile
    import torch
    from repro_torch.rl.experiment import Experiment
    from repro_torch.rl.runner import clone_state, member_state, \
        state_leaves
    from repro_torch.rl.sweep import Fleet
    spec = fleet_spec()
    specs = [spec.override(seed=s) for s in range(FLEET_E)]
    _reset_counts()
    launches = {k: 0 for k in _counts()}

    def fleet_call(fn, *args, **kw):
        """``fn`` with the wrappers' launches added to the fleet path's."""
        b = _counts()
        out = fn(*args, **kw)
        for k, v in _counts().items():
            launches[k] += v - b[k]
        return out
    t0 = time.perf_counter()
    fl = Fleet(specs)
    tr = fl.trainer
    fleet_call(fl._ensure_init)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    fls0 = clone_state(fl._fls)
    nbytes = sum(t.numel() * t.element_size() for t in state_leaves(fls0))
    t0 = time.perf_counter()
    exp = Experiment.from_spec(specs[0])
    exp._ensure_init()
    torch.cuda.synchronize()
    t_solo = time.perf_counter() - t0
    init_bad = state_diff(member_state(fls0, 0), exp._ls)
    log(f"[fleet] fig3-width U=2048 x {FLEET_E} seeds: init + the vmapped "
        f"warm-up ({spec.execution.warmup_steps} collect steps a member) "
        f"{t_init:.1f}s, the solo init + warm-up {t_solo:.1f}s; the fleet's "
        f"state {nbytes / 1e9:.3f} GB ({len(state_leaves(fls0))} tensors); "
        f"member 0 after init vs the solo run: "
        + (f"bitwise" if not init_bad else f"{len(init_bad)} tensors "
           f"differ, first {init_bad[:4]}"))

    per_call, fstep = [], tr.fleet_step

    def counted(fls, draws=None):
        b = _counts()
        out = fstep(fls, draws)
        a = _counts()
        per_call.append({k: a[k] - b[k] for k in ("sample", "set", "fwd",
                                                  "bwd")})
        return out
    tr.fleet_step = counted
    t0 = time.perf_counter()
    try:
        fleet_call(fl.run, 1)
        torch.cuda.synchronize()
    finally:
        del tr.fleet_step
    t_cap = time.perf_counter() - t0
    want = {"sample": 1, "set": 2, "fwd": 0, "bwd": 0}
    if per_call != [want, want] or fl.graph is None:
        raise AssertionError(f"fleet launches at warm-up and capture "
                             f"{per_call}, want {want} each")
    exp.run(1)
    rel1, ratio1, top1 = param_rel_diff(fl._fls.agent["params"],
                                        exp._ls.agent["params"])
    rest = [(n, d) for n, d in state_diff(member_state(fl._fls, 0),
                                          exp._ls)
            if not n.startswith("agent/")]
    log(f"[fleet] member 0 vs solo after one superstep: largest |diff| / "
        f"max|leaf| {rel1:.3e}, worst leaves {top1}; largest |diff| / "
        f"(atol + rtol |solo|) {ratio1:.3f} at SOLO_PARITY (<= 1); other "
        f"state tensors that differ (max abs) {rest[:6]}")
    if ratio1 > 1.0:
        raise AssertionError(f"member 0 after one superstep outside "
                             f"SOLO_PARITY (ratio {ratio1:.3f})")
    log(f"[fleet] capture of the vmapped superstep {t_cap:.2f}s (with its "
        f"eager warm-up superstep); wrapper launches at warm-up and at "
        f"capture {want} each (one member-axis sample, two member-axis "
        f"writes; jnp blocks); copy-back {fl.graph.copied_bytes / 1e6:.1f}"
        f" MB a replay")
    fleet_call(fl.run, 19)
    s20 = clone_state(fl._fls)
    fleet_call(fl.run, FLEET_STEPS - 20, eval_at_end=True)
    exp.run(FLEET_STEPS - 1, eval_at_end=True)
    torch.cuda.synchronize()
    if launches["sample"] < 1 or launches["set"] < 1:
        raise AssertionError(f"the fleet run launched no tree kernel: "
                             f"{launches}")
    w40 = clone_state(fl._fls)
    rel40, ratio, top40 = param_rel_diff(fl._fls.agent["params"],
                                         exp._ls.agent["params"])
    if ratio > 1.0 or fl.eval_steps[0] != [FLEET_STEPS]:
        raise AssertionError(f"member 0 after {FLEET_STEPS} supersteps "
                             f"outside SOLO_PARITY (ratio {ratio:.3f}), "
                             f"eval steps {fl.eval_steps[0]}")
    log(f"[fleet] after {FLEET_STEPS} supersteps under the graph and the "
        f"eval at the end: member 0 vs solo largest |diff| / max|leaf| "
        f"{rel40:.3e} (worst {top40}), largest |diff| / (atol + rtol "
        f"|solo|) {ratio:.3f} at SOLO_PARITY (<= 1); eval returns fleet {fl.returns[0]} vs solo "
        f"{exp.returns}; all members' returns "
        f"{[r[-1] for r in fl.returns]}; wrapper launches over the fleet "
        f"run, counted from 0 (the init's add, the warm-up and capture "
        f"supersteps; replays pass no wrapper) sample {launches['sample']},"
        f" set {launches['set']}")

    eager = clone_state(s20)
    for _ in range(GRAPH_K):
        eager, _, _ = tr.fleet_step(eager)
    fl.graph.load(clone_state(s20))
    fl.graph.replay(GRAPH_K)
    torch.cuda.synchronize()
    bad = fleet_state_diff(eager, fl.graph.state)
    if bad:
        raise AssertionError(f"{GRAPH_K} fleet replays != {GRAPH_K} eager "
                             f"vmapped supersteps: {bad[:8]}")
    log(f"[fleet] bitwise: {GRAPH_K} replays == {GRAPH_K} eager vmapped "
        f"supersteps from one fleet state (steps 20-39), on all "
        f"{len(state_leaves(eager))} state tensors and the {FLEET_E} "
        f"generators")
    del eager
    _free()

    with tempfile.TemporaryDirectory() as d:
        fa = Fleet(specs)
        fa._fls = clone_state(fls0)
        fa.run(17)
        path = os.path.join(d, "fleet.npz")
        t0 = time.perf_counter()
        fa.save(path)
        t_save = time.perf_counter() - t0
        del fa
        _free()
        t0 = time.perf_counter()
        fb = Fleet.restore(path)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        fsize = os.path.getsize(path)
    fb.run(FLEET_STEPS - 17, eval_at_end=True)
    torch.cuda.synchronize()
    bad = fleet_state_diff(fb._fls, w40)
    if bad or fb.returns != fl.returns:
        raise AssertionError(f"fleet run(17); save; restore; run(23) != "
                             f"run(40): {bad[:8]}, returns {fb.returns} vs "
                             f"{fl.returns}")
    log(f"[fleet] resume: run(17); save; Fleet.restore; run(23) == "
        f"run(40), bitwise on every state tensor, the {FLEET_E} generators "
        f"and the returns; save {t_save:.2f}s, restore {t_restore:.2f}s, "
        f"file {fsize / 1e6:.1f} MB")
    del fb
    _free()

    fm = Fleet(specs)
    fm._fls = clone_state(fls0)
    fm.run(10)
    s10 = clone_state(fm._fls)
    fm.set_done([2])
    fm.run(10)
    torch.cuda.synchronize()
    others = [m for m in range(FLEET_E) if m != 2]
    bad = member_diff(fm._fls, s10, [2]) + member_diff(fm._fls, s20,
                                                       others)
    fm.set_done([2], False)
    fm.run(10)
    torch.cuda.synchronize()
    s30_2 = member_diff(fm._fls, s20, [2])
    if bad:
        raise AssertionError(f"done mask: {bad[:8]}")
    log(f"[fleet] done mask: member 2 frozen for steps 10-20 kept its "
        f"step-10 state and generator bitwise, members {others} equal the "
        f"unmasked run at step 20 bitwise; unfrozen, member 2 after 10 "
        f"more supersteps vs the unmasked run at step 20: "
        + ("bitwise" if not s30_2 else f"{s30_2[:4]}"))
    if s30_2:
        raise AssertionError(f"member 2 did not resume bit for bit: "
                             f"{s30_2[:8]}")
    del fm, s10, s20, w40
    _free()

    exp_g = exp.trainer.graph
    walls = walls_in_turns({"fleet": fl.graph, "solo": exp_g}, "fleet")
    log(f"[fleet] per member-superstep: fleet {walls['fleet'] / FLEET_E:.3f}"
        f" ms, solo {walls['solo']:.3f} ms (x{walls['solo'] * FLEET_E / walls['fleet']:.2f})")
    graph_device_time(fl.graph, "fleet", "fleet-prof")
    graph_device_time(exp_g, "fleet-solo", "fleet-solo-prof")
    del exp, exp_g
    _free()
    return launches, walls["fleet"], fl, fls0


def fleet_smoke_walls():
    """``fleet-smoke`` at E=8 (per-kernel latency, not arithmetic, is what
    batching amortises there) against its solo run: capture, walls in
    turns, CUDA-event time and the profiler's view of each."""
    import torch
    from repro_torch.rl import presets
    from repro_torch.rl.experiment import Experiment
    from repro_torch.rl.sweep import Fleet
    spec = presets.get("fleet-smoke")
    fl = Fleet([spec.override(seed=s) for s in range(FLEET_SMOKE_E)])
    fl.run(1)
    exp = Experiment.from_spec(spec)
    exp.run(1)
    torch.cuda.synchronize()
    walls = walls_in_turns({"fleet": fl.graph, "solo": exp.trainer.graph},
                           "fleet-smoke")
    log(f"[fleet-smoke] E={FLEET_SMOKE_E}, U=16: per member-superstep "
        f"fleet {walls['fleet'] / FLEET_SMOKE_E:.4f} ms, solo "
        f"{walls['solo']:.4f} ms (x{walls['solo'] * FLEET_SMOKE_E / walls['fleet']:.2f})")
    graph_device_time(fl.graph, "fleet-smoke", "fleet-smoke-prof")
    graph_device_time(exp.trainer.graph, "fleet-smoke-solo",
                      "fleet-smoke-solo-prof")
    del fl, exp
    _free()


def fleet_guard(tmp):
    """A fleet rollback on the card at ``fleet-smoke`` size (3 seeds,
    prioritized replay on the member-axis tree kernels): ``poison_params
    (fleet, member=1)`` after a durable save is detected and rolled back
    from the store, and members 0 and 2 stay bitwise an unpoisoned run."""
    import torch
    from repro_torch.guard import DurableStore, chaos
    from repro_torch.rl import presets
    from repro_torch.rl.sweep import Fleet
    spec = presets.get("fleet-smoke").override(
        prioritized=True, eval_every=8, **{
            "guard.enabled": True, "guard.policy": "rollback"})
    specs = [spec.override(seed=s) for s in range(3)]
    store = DurableStore(os.path.join(tmp, "fleet-ckpts"), keep=2)
    fl, clean = Fleet(specs), Fleet(specs)
    fl.attach_guard(store)
    fl.run(8)
    clean.run(8)
    store.save(lambda p: fl.save(p), fl.step)
    chaos.poison_params(fl, member=1)
    fl.run(8)
    clean.run(8)
    torch.cuda.synchronize()
    bad = member_diff(fl._fls, clean._fls, [0, 2])
    finite = all(bool(torch.isfinite(t[1]).all()) for t in
                 _leaves(fl._fls.agent["params"]))
    if fl._guard.recoveries != 1 or bad or not finite:
        raise AssertionError(f"fleet rollback: {fl._guard.recoveries} "
                             f"recoveries, neighbours {bad[:8]}, member 1 "
                             f"finite {finite}")
    log(f"[fleet-guard] poison_params(fleet, member=1) after a durable save "
        f"at step 8: detected and rolled back (1 recovery; member 1 finite "
        f"again), members 0 and 2 bitwise an unpoisoned run at step 16")
    del fl, clean
    _free()


def phase_fleet(gen):
    """Vmapped fleets on the card (``rl.sweep``): the member-axis tree
    kernels, the fig3-width U=2048 x 5 fleet under one CUDA graph, the
    fleet-smoke walls at E=8 and a fleet rollback. Returns the tree
    records, the fleet run's launches, its wall per replay (ms), and the
    fleet with a copy of its initial state (``fleet_training``'s)."""
    import tempfile
    tree = phase_fleet_tree(gen)
    launches, fleet_ms, fl, fls0 = fleet_training(gen)
    fleet_smoke_walls()
    with tempfile.TemporaryDirectory() as tmp:
        fleet_guard(tmp)
    return tree, launches, fleet_ms, (fl, fls0)


# the member kernels' cases at E = FLEET_E, one a forward kernel of the
# fused fleets' paths (name, connectivity, M, d0, U, L): the whole-stack
# kernel (phi_s, phi_sa), streaming at the actor pool's rows (1 and 32),
# the register tile (the critic), dense_tile.cuh (fig3-width's mlp actor)
FUSED_CASES = (("phi_s", "densenet", 256, 3, 64, 4),
               ("phi_sa", "densenet", 256, 260, 64, 4),
               ("actor M=1", "densenet", 1, 259, 2048, 2),
               ("actor M=32", "densenet", 32, 259, 2048, 2),
               ("critic", "densenet", 256, 516, 2048, 2),
               ("fig3 mlp", "mlp", 256, 3, 2048, 2),
               ("fig3 critic", "mlp", 256, 4, 2048, 2),
               ("d2rl U=2048", "d2rl", 256, 4, 2048, 2))
FUSED_BWD = ("critic", "phi_s", "phi_sa")
FUSED_TRAIN_E = 2        # the training cell's spec as a fleet of 2 seeds
FUSED_TRAIN_STEPS = 20


def members_inputs(conn, e, m, d0, u, L, gen):
    """``stack_inputs`` of E members, stacked on a leading member axis,
    and each member's own contiguous copies for its solo launches."""
    import torch
    solo = [stack_inputs(conn, L, d0, u, m, gen) for _ in range(e)]
    x = torch.stack([s[0] for s in solo])
    ws = [torch.stack([s[1][i] for s in solo]) for i in range(L)]
    bs = [torch.stack([s[2][i] for s in solo]) for i in range(L)]
    return x, ws, bs, solo


def _library_members(x, ws, bs, conn):
    """The jnp fleet's route for the same function: a batched product per
    layer (``baddbmm``) and ``silu``, into a stream built once."""
    import torch
    import torch.nn.functional as F
    if conn != "densenet":
        h = x
        for i, (w, b) in enumerate(zip(ws, bs)):
            inp = torch.cat([h, x], -1) if conn == "d2rl" and i else h
            h = F.silu(torch.baddbmm(b[:, None, :], inp, w))
        return h
    d0, u = x.shape[-1], ws[0].shape[-1]
    stream = torch.empty((*x.shape[:-1], d0 + len(ws) * u), device="cuda")
    stream[..., :d0].copy_(x)
    for i, (w, b) in enumerate(zip(ws, bs)):
        d = d0 + i * u
        stream[..., d:d + u] = F.silu(torch.baddbmm(b[:, None, :],
                                                    stream[..., :d], w))
    return stream


def fused_member_kernels(gen, e=FLEET_E):
    """Each member-axis forward kernel at E members (``FUSED_CASES``) and
    the backward of ``FUSED_BWD``: one launch per solo launch for all
    members, bitwise E solo launches (output, pre-activations, every
    gradient), within 1e-4 (forward) and 1e-3 (gradients) of the members
    twin; then the member call's time beside E solo calls', the twin's,
    the jnp fleet's batched products (``_library_members``) and the bound
    times E. Returns ``{"fwd": {name: rec}, "bwd": {name: rec}}``."""
    import torch
    from repro_torch.kernels.dense_block import stack
    out = {"fwd": {}, "bwd": {}}
    for name, conn, m, d0, u, L in FUSED_CASES:
        x, ws, bs, solo = members_inputs(conn, e, m, d0, u, L, gen)
        zs = torch.empty((e, m, L * u), device="cuda")
        b = _counts()
        got = stack.dense_stack_members(x, ws, bs, connectivity=conn, zs=zs)
        member = {k: v - b[k] for k, v in _counts().items()}
        b = _counts()
        want = []
        for xe, we, be in solo:
            z1 = torch.empty((m, L * u), device="cuda")
            want.append((stack._kernel_forward(xe, we, be, conn, "swish",
                                               z1), z1))
        per_solo = {k: v - b[k] for k, v in _counts().items()}
        torch.cuda.synchronize()
        kinds = [k for k in stack.FWD_KERNELS if member[f"fwd_{k}"]]
        if member["fwd"] < 1 or any(
                per_solo[k] != e * member[k] for k in ("fwd", "fwd_t")) \
                or not all(torch.equal(got[i], o) and torch.equal(zs[i], z)
                           for i, (o, z) in enumerate(want)):
            raise AssertionError(f"member forward {name}: launches "
                                 f"{member} vs {e} solo {per_solo}, or not "
                                 f"bitwise {e} solo launches")
        twin = stack.dense_stack_members_ref(x, ws, bs, connectivity=conn)
        ok, err = close_enough(got, twin)
        if not ok:
            raise AssertionError(f"member forward {name}: max abs err "
                                 f"{err:.2e} vs the members twin")
        t_m, h_m = time_ms(lambda _: stack.dense_stack_members(
            x, ws, bs, connectivity=conn), [0])
        t_s, _ = time_ms(lambda _: [stack.dense_stack(
            xe, we, be, connectivity=conn) for xe, we, be in solo], [0])
        t_p, _ = time_ms(lambda _: stack.dense_stack_members_ref(
            x, ws, bs, connectivity=conn), [0])
        t_l, _ = time_ms(lambda _: _library_members(x, ws, bs, conn), [0])
        t_o = None                      # mlp/d2rl: dense_tile.cuh's path
        if conn != "densenet" and "rt" in kinds:
            t_o, _ = time_ms(lambda _: stack._kernel_forward(
                x, ws, bs, conn, "swish", mlp_rt=False), [0])
        kw = sum(w[0].numel() + b_[0].numel() for w, b_ in zip(ws, bs))
        feat = stack.feature_dim(conn, L, d0, u)
        bound_ms, bound_by = _bound(
            4 * e * (kw + m * d0 + m * feat),
            2 * e * m * sum(w.shape[1] * w.shape[2] for w in ws))
        out["fwd"][name] = dict(
            E=e, kernels=kinds, launches=member["fwd"],
            stream_t_inits=member["fwd_t"], ms=t_m, host_ms=h_m,
            solo_x_e_ms=t_s, plain_ms=t_p, library_ms=t_l,
            library="baddbmm + silu a layer (the jnp fleet's products)",
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
        if t_o is not None:
            out["fwd"][name]["old_tile_ms"] = t_o
        log(f"[fleet-fused] forward {name} ({conn}, M={m}, d0={d0}, U={u},"
            f" L={L}; {'+'.join(kinds)}) E={e}: {member['fwd']} launches "
            f"(+{member['fwd_t']} stream^T) for all members, {e} solo calls "
            f"{per_solo['fwd']}; bitwise {e} solo launches (output and zs),"
            f" max abs err vs the members twin {err:.2e}; member call "
            f"{t_m * 1e3:.1f} us, {e} solo calls {t_s * 1e3:.1f} us "
            f"(x{t_s / t_m:.2f}), twin {t_p * 1e3:.1f} us, baddbmm + silu "
            f"{t_l * 1e3:.1f} us, bound x {e} {bound_ms * 1e3:.1f} us "
            f"({bound_by}), {100 * bound_ms / t_m:.0f}% of bound"
            + ("" if t_o is None else f"; the old path (dense_tile.cuh) "
               f"{t_o * 1e3:.1f} us, new / old x{t_m / t_o:.3f}"))
        if name not in FUSED_BWD:
            continue
        g = torch.randn(got.shape, generator=gen, device="cuda")
        keep = got if conn == "densenet" else x
        b, bw_ = stack.bwd_launch_count(), stack.bwd_launch_count("whole")
        grads = stack.dense_stack_members_grads(
            x, ws, bs, g, connectivity=conn, saved=(keep, zs))
        n_member = stack.bwd_launch_count() - b
        n_whole = stack.bwd_launch_count("whole") - bw_
        flat = [grads[0], *grads[1], *grads[2]]
        for i, ((xe, we, be), (o, z)) in enumerate(zip(solo, want)):
            dx, dws, dbs = stack._kernel_backward(
                (o if conn == "densenet" else xe, z), we,
                g[i].contiguous(), conn, "swish", True, [True] * L,
                [True] * L)
            torch.cuda.synchronize()
            if not all(torch.equal(a[i], c) for a, c in
                       zip(flat, [dx, *dws, *dbs])):
                raise AssertionError(f"member backward {name}: member {i} "
                                     f"not bitwise its solo launches")
        twin_g = stack.dense_stack_members_grads_ref(
            x, ws, bs, g, connectivity=conn, zs=zs)
        ok, gerr = grads_close(flat, [twin_g[0], *twin_g[1], *twin_g[2]])
        if n_member != 1 or not ok:
            raise AssertionError(f"member backward {name}: {n_member} "
                                 f"calls, max abs err {gerr:.2e} vs the "
                                 f"members twin")
        saved_solo = [((o if conn == "densenet" else xe), z, we, g[i]
                       .contiguous()) for i, ((xe, we, _), (o, z)) in
                      enumerate(zip(solo, want))]
        t_bm, _ = time_ms(lambda _: stack.dense_stack_members_grads(
            x, ws, bs, g, connectivity=conn, saved=(keep, zs)), [0])
        t_bs, _ = time_ms(lambda _: [stack._kernel_backward(
            (k, z), we, gi, conn, "swish", True, [True] * L, [True] * L)
            for k, z, we, gi in saved_solo], [0])
        t_bp, _ = time_ms(lambda _: stack.dense_stack_members_grads_ref(
            x, ws, bs, g, connectivity=conn, zs=zs), [0])
        t_bo = None                 # narrow densenet: the per-layer path
        if n_whole:
            t_bo, _ = time_ms(lambda _: stack._kernel_backward(
                (keep, zs), ws, g, conn, "swish", True, [True] * L,
                [True] * L, whole=False), [0])
        kk = sum(w.shape[1] * w.shape[2] for w in ws)
        bound_ms, bound_by = _bound(
            4 * e * (2 * kk + L * u + m * (2 * feat + L * u + d0)),
            4 * e * m * kk)
        out["bwd"][name] = dict(
            E=e, launches=n_member, whole_launches=n_whole, ms=t_bm,
            solo_x_e_ms=t_bs, plain_ms=t_bp, library_ms=None,
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=gerr)
        if t_bo is not None:
            out["bwd"][name]["old_layers_ms"] = t_bo
        log(f"[fleet-fused] backward {name} E={e}: one call for all "
            f"members ({'the whole-stack kernel' if n_whole else 'the '
            'per-layer kernels'}), bitwise {e} solo backwards (dx, every "
            f"dW and db), max abs err vs the members twin {gerr:.2e}; "
            f"member call {t_bm * 1e3:.1f} us, {e} solo {t_bs * 1e3:.1f} us"
            f" (x{t_bs / t_bm:.2f}), twin {t_bp * 1e3:.1f} us, bound x {e} "
            f"{bound_ms * 1e3:.1f} us ({bound_by})"
            + ("" if t_bo is None else f"; the per-layer kernels "
               f"{t_bo * 1e3:.1f} us, new / old x{t_bm / t_bo:.3f}"))
        del grads, flat, twin_g, saved_solo
    _free()
    return out


def _count_steps(tr, per_call):
    """Wrap ``tr.fleet_step`` so that each call's wrapper launches are
    appended to ``per_call``; ``del tr.fleet_step`` unwraps it."""
    fstep = tr.fleet_step

    def counted(fls, draws=None):
        b = _counts()
        out = fstep(fls, draws)
        per_call.append({k: v - b[k] for k, v in _counts().items()})
        return out
    tr.fleet_step = counted


def _capture_counts(tr, per_call, tag):
    """The fleet's warm-up and captured supersteps launch what one solo
    superstep launches (``expected_launches``): once for all members."""
    want = expected_launches(tr)
    keys = [k for k in want if k in per_call[0]]
    got = [{k: c[k] for k in keys} for c in per_call]
    if got != [{k: want[k] for k in keys}] * 2:
        raise AssertionError(f"[{tag}] launches at the warm-up and capture "
                             f"{got}, want one solo superstep's {want}")
    return {k: want[k] for k in keys}


def fused_fleet_fig3(jnp_fleet, fls0):
    """fig3-width U=2048 x 5 seeds with fused blocks from the jnp fleet's
    initial state (the warm-up's random policy reads no network: the same
    state), 40 supersteps under one graph with its launches counted at
    capture; member 0 against a solo fused run of seed 0 at SOLO_PARITY
    after every superstep (``fleet_parity.hold_members``: a superstep whose
    batches differ, a sample flip, passes only where ``flip_cause`` shows
    that the draw lay within float32 rounding of the boundary between the
    two rows in both trees; the solo run then restarts from member 0's
    state). Then its walls in turns with the jnp fleet's graph, its device
    time and idle share. Returns ``(launches over the run, record)``."""
    import torch
    from repro_torch.launch import fleet_parity
    from repro_torch.rl.experiment import Experiment
    from repro_torch.rl.runner import clone_state, member_state
    from repro_torch.rl.sweep import Fleet
    spec = fleet_spec().override(block_backend="fused")
    specs = [spec.override(seed=s) for s in range(FLEET_E)]
    _reset_counts()
    fl = Fleet(specs)
    fl._fls = clone_state(fls0)
    tr, per_call = fl.trainer, []
    _count_steps(tr, per_call)
    exp = Experiment.from_spec(specs[0])
    exp._ls = clone_state(member_state(fls0, 0))
    first = {}

    def after_first():
        # every fleet launch of the run is counted here: the replays that
        # follow pass no wrapper, and no solo run has started
        torch.cuda.synchronize()
        del tr.fleet_step
        first.update(t_cap=time.perf_counter() - t0, launches=_counts(),
                     at_capture=_capture_counts(tr, per_call,
                                                "fleet-fused"))
    t0 = time.perf_counter()
    try:
        held = fleet_parity.hold_members(fl, {0: exp}, FLEET_STEPS,
                                         after_first)[0]
    finally:
        tr.__dict__.pop("fleet_step", None)
    flips = [(t, rows, round(ratio, 4)) for t, rows, ratio, _ in
             held["flips"]]
    log(f"[fleet-fused] fig3-width U=2048 x {FLEET_E} seeds, fused blocks: "
        f"capture {first['t_cap']:.2f}s (with its eager warm-up superstep); "
        f"launches at the warm-up and at the capture, each one solo "
        f"superstep's (one launch a solo launch for all members): "
        f"{first['at_capture']}; over the run (warm-up, capture, "
        f"{FLEET_STEPS - 1} supersteps; replays pass no wrapper) "
        f"{first['launches']}; member 0 vs the solo fused run of seed 0 "
        f"after each of {FLEET_STEPS} supersteps: largest |diff| / (atol + "
        f"rtol |solo|) {held['worst']:.4f} at SOLO_PARITY (<= 1); sample "
        f"flips (superstep, rows, ratio; the solo run restarted from member "
        f"0) {flips}: {fleet_parity.flips_line(held)}")
    if held["fault"] is not None:
        raise AssertionError(f"fused fleet member 0: {held['fault']}")
    walls = walls_in_turns({"fused": fl.graph, "jnp": jnp_fleet.graph},
                           "fleet-fused")
    dev = graph_device_time(fl.graph, "fleet-fused", "fleet-fused-prof")
    log(f"[fleet-fused] fig3 U=2048 x {FLEET_E}: fused {walls['fused']:.3f} "
        f"ms a replay, {walls['fused'] / FLEET_E:.3f} ms a member-superstep;"
        f" jnp {walls['jnp']:.3f} ms ({walls['jnp'] / FLEET_E:.3f}); fused "
        f"/ jnp x{walls['fused'] / walls['jnp']:.3f}")
    rec = dict(E=FLEET_E, replay_ms=walls["fused"],
               member_superstep_ms=walls["fused"] / FLEET_E,
               jnp_replay_ms=walls["jnp"], events_ms=dev["events_ms"],
               idle=dev["idle"], kernels_per_replay=dev["kernels"],
               solo_parity_ratio=held["worst"], sample_flips=flips,
               launches_at_capture=first["at_capture"])
    del fl, exp
    _free()
    return first["launches"], rec


def fused_fleet_train(train_spec):
    """The training cell's spec (fig10-ablation, U=2048 densenet, OFENet,
    device replay, 32 actors) as a fused fleet of ``FUSED_TRAIN_E`` seeds
    under one graph: its launches counted at capture (the whole-stack,
    streaming and register-tile member kernels, forward and backward),
    ``FUSED_TRAIN_STEPS`` supersteps, member 0 against the solo run of seed
    0 (logged), and the fleet's replay beside the solo's in turns. Returns
    ``(launches over the run, record)``."""
    import torch
    from repro_torch.rl.experiment import Experiment
    from repro_torch.rl.runner import clone_state, member_state
    from repro_torch.rl.sweep import Fleet
    spec = train_spec.override(loop="scan")
    _reset_counts()
    t0 = time.perf_counter()
    fl = Fleet([spec.override(seed=s) for s in range(FUSED_TRAIN_E)])
    fl._ensure_init()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    exp = Experiment.from_spec(spec.override(seed=0))
    exp._ls = clone_state(member_state(fl._fls, 0))
    tr, per_call = fl.trainer, []
    _count_steps(tr, per_call)
    try:
        fl.run(1)
    finally:
        del tr.fleet_step
    at_capture = _capture_counts(tr, per_call, "fleet-fused-train")
    fl.run(FUSED_TRAIN_STEPS - 1)
    torch.cuda.synchronize()
    launches = _counts()
    exp.run(FUSED_TRAIN_STEPS)
    torch.cuda.synchronize()
    rel, ratio, top = param_rel_diff(fl._fls.agent["params"],
                                     exp._ls.agent["params"])
    walls = walls_in_turns({"fleet": fl.graph, "solo": exp.trainer.graph},
                           "fleet-fused-train", reps=20)
    log(f"[fleet-fused-train] fig10-ablation U=2048 (densenet, OFENet, "
        f"device replay, 32 actors) x {FUSED_TRAIN_E} seeds, fused: init + "
        f"vmapped warm-up {t_init:.1f}s; launches at the warm-up and "
        f"capture, each one solo superstep's: {at_capture}; over the run "
        f"{launches}; member 0 vs solo after {FUSED_TRAIN_STEPS} "
        f"supersteps: largest |diff| / max|leaf| {rel:.3e} (worst {top}), "
        f"ratio at SOLO_PARITY {ratio:.3f} (logged); fleet "
        f"{walls['fleet']:.3f} ms a replay against two solo replays "
        f"{2 * walls['solo']:.3f} (x{2 * walls['solo'] / walls['fleet']:.3f}"
        f"), {walls['fleet'] / FUSED_TRAIN_E:.3f} ms a member-superstep")
    rec = dict(E=FUSED_TRAIN_E, replay_ms=walls["fleet"],
               solo_replay_ms=walls["solo"], solo_parity_ratio=ratio,
               launches_at_capture=at_capture)
    del fl, exp
    _free()
    return launches, rec


def phase_fleet_fused(gen, jnp_fleet, fls0, train_spec):
    """Fleets with ``block_backend="fused"``: the member-axis stack kernels
    at E=5 against five solo launches and the members twin, then the
    fused fig3-width U=2048 x 5 fleet in turns with the jnp fleet, then the
    training cell's spec as a fused fleet of 2 seeds. Returns the kernel
    records, the two runs' launches and their records."""
    t0 = time.perf_counter()
    kernels = fused_member_kernels(gen)
    fig3_launches, fig3 = fused_fleet_fig3(jnp_fleet, fls0)
    train_launches, train = fused_fleet_train(train_spec)
    log(f"[fleet-fused] phase wall {time.perf_counter() - t0:.1f}s")
    return dict(kernels=kernels, fig3=fig3, train=train,
                launches={"fleet": fig3_launches,
                          "fleet_train": train_launches})


HOST_SPANS = ("repro.replay.host_add", "repro.replay.host_sample",
              "repro.replay.host_update_prio")


def host_profile(run, n, tag, what):
    """``run()`` (``n`` supersteps) under ``torch.profiler``: wall per
    superstep, device busy (the union of the device intervals) and idle
    share, each host span's ms and the copies between host and device
    (ms and count per superstep, by the profiler's memcpy names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / n
    avg = prof.key_averages()
    spans = {e.key: (e.cpu_time_total / 1e3 / n, e.count / n)
             for e in avg if e.key in HOST_SPANS}
    copies = {e.key: (e.device_time_total / 1e3 / n, e.count / n)
              for e in avg if e.key.startswith("Memcpy")
              and e.device_type == torch.autograd.DeviceType.CUDA}
    busy = busy_union_ms(prof)
    out = {"wall_ms": wall, "spans": spans, "copies": copies,
           "busy_ms": None if busy is None else busy / n}
    if set(spans) != set(HOST_SPANS) or any(
            c != 1 for _, c in spans.values()):
        raise AssertionError(f"[{tag}] host spans per superstep {spans}, "
                             f"want one each of {HOST_SPANS}")
    log(f"[{tag}] {what}, {n} supersteps under the profiler: {wall:.3f} ms"
        f" wall per superstep, "
        + (f"device busy {out['busy_ms']:.3f} ms (union), idle share "
           f"{100 * (1 - out['busy_ms'] / wall):.1f}%"
           if busy is not None else "device busy not measured (the "
           "profiler saw no device time)")
        + "; host spans ms per superstep: " + ", ".join(
            f"{k.rsplit('.', 1)[1]} {ms:.4f}" for k, (ms, _) in
            sorted(spans.items()))
        + "; copies (device ms, count) per superstep: " + ", ".join(
            f"{k} {ms:.4f} ({c:.0f})" for k, (ms, c) in
            sorted(copies.items())))
    return out


def phase_host(spec, device_spec):
    """The slice's path: ``spec`` (fig10-ablation at the paper budget, U=
    2048, fused) with the preset's own host replay, through
    ``Experiment.run`` in both loops. Returns the launches of
    ``GRAPH_TIMED`` python-loop supersteps counted from 0."""
    import tempfile
    import torch
    from repro_torch.rl.experiment import Experiment
    from repro_torch.rl.replay import load_buffer_state
    from repro_torch.rl.runner import clone_state
    if spec.replay.backend != "host" or spec.replay.kernel != "xla":
        raise AssertionError(f"phase_host needs the preset's host replay, "
                             f"got {spec.replay}")
    exp = Experiment.from_spec(spec)
    tr = exp.trainer
    want = expected_launches(tr)
    adds, add = [], tr.host_add

    def timed_add(rows):
        t0 = time.perf_counter()
        add(rows)
        adds.append((len(rows), 1e3 * (time.perf_counter() - t0)))
    tr.host_add = timed_add
    t0 = time.perf_counter()
    exp._ensure_init()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tr.host_add = add
    n_warm = tr.buffer.count
    warm_rows = max(spec.execution.warmup_steps // tr.n_actors, 1) \
        * tr.n_actors
    if n_warm != warm_rows or adds[0][0] != warm_rows or len(adds) != 1:
        raise AssertionError(f"host warm-up: {n_warm} rows, adds {adds} "
                             f"(want one of {warm_rows})")
    log(f"[host] fig10-ablation large, paper budget, the preset's host "
        f"replay ({type(tr.buffer).__name__}, capacity "
        f"{tr.buffer.capacity}, NumPy tree of {tr.buffer.tree.size} nodes):"
        f" {tr.n_params} params, {tr.n_actors} actors, batch "
        f"{tr.batch_size}; warm-up {n_warm} transitions in {t_init:.2f}s, "
        f"of which add_batch of the {adds[0][0]} rows {adds[0][1]:.2f} ms "
        f"(host clock)")

    # the python loop through Experiment.run, launches counted from 0
    per_step, scal, step_fn = [], [], tr.step
    keys = tuple(k for k in train_keys(spec) if not k.startswith("stale"))

    def counted(ls, draws=None):
        before = _counts()
        out = step_fn(ls, draws)
        after = _counts()
        per_step.append({k: after[k] - before[k] for k in after})
        if any(k.startswith("staleness") for k in out[1]):
            raise AssertionError("a host superstep reported staleness")
        scal.append(torch.stack([out[1][k] for k in keys]))
        return out
    tr.step = counted
    torch.cuda.synchronize()
    _reset_counts()
    exp.run(GRAPH_TIMED)
    torch.cuda.synchronize()
    launches = _counts()
    tr.step = step_fn
    bad = [c for c in per_step if c != want]
    if bad or any(launches[k] != want[k] * GRAPH_TIMED for k in want) \
            or not all(launches[k] for k in want if want[k]):
        raise AssertionError(f"host launches per superstep {bad[:2]} (want "
                             f"{want}), totals {launches}")
    if not torch.all(torch.isfinite(torch.stack(scal))):
        raise AssertionError("host training produced a non-finite loss")
    buf = getattr(tr.buffer, "_inner", tr.buffer)
    leaves = buf.tree.tree[buf.tree.size // 2:]
    if buf.count != min(n_warm + GRAPH_TIMED * tr.n_actors, buf.capacity) \
            or abs(buf.tree.total - leaves.sum()) > 1e-9 * leaves.sum() \
            or int(exp._ls.step) != GRAPH_TIMED:
        raise AssertionError(f"host buffer after {GRAPH_TIMED} supersteps: "
                             f"{buf.count} rows, tree {buf.tree.total} vs "
                             f"{leaves.sum()}")
    last = dict(zip(keys, torch.stack(scal)[-1].tolist()))
    log(f"[host] loop='python' Experiment.run({GRAPH_TIMED}) with the "
        f"counts set to 0 first: launches {launches} = {GRAPH_TIMED} x "
        f"{want} (no tree kernel: the tree is NumPy); last losses "
        + ", ".join(f"{k} {v:.4g}" for k, v in last.items())
        + f"; buffer {buf.count} rows, tree total {buf.tree.total:.6g} = "
        f"sum of leaves; no staleness keys")

    # the two graphs against eager supersteps, bitwise, host included
    ls0, h0 = clone_state(exp._ls), host_of(tr)
    eager = clone_state(ls0)
    for _ in range(GRAPH_K):
        eager, _, _ = tr.step(eager)
    h_eager = host_of(tr)
    tr.rng = load_buffer_state(tr.buffer, h0)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    replayed, _ = tr.chunk_fn(GRAPH_K, False)(clone_state(ls0))
    torch.cuda.synchronize()
    t_chunk = time.perf_counter() - t0
    cap = _counts()
    graph = tr.graph
    if not graph.host or any(cap[k] != 2 * want[k] for k in want):
        raise AssertionError(f"host graph: launches of the warm-up and the "
                             f"capture {cap}, want 2 x {want}")
    bad = state_diff(eager, replayed) + host_diff(h_eager, host_of(tr))
    if bad:
        raise AssertionError(f"{GRAPH_K} supersteps through the two graphs "
                             f"!= {GRAPH_K} eager supersteps: {bad[:8]}")
    ev_e, ev_g = tr.evaluate(eager), tr.evaluate(replayed)
    if not torch.equal(ev_e, ev_g) or state_diff(eager, replayed):
        raise AssertionError("eval after the two graphs != after eager")
    rows_b = graph.rows.numel() * graph.rows.element_size()
    batch_b = graph.batch_flat.numel() * graph.batch_flat.element_size()
    prio_b = graph.metrics["priorities"].numel() * 4
    log(f"[host] two graphs (A: collect + n-step rows; B: the update) with "
        f"the host buffer between them: chunk_fn({GRAPH_K}) (warm-up, "
        f"capture, {GRAPH_K - 1} replays) {t_chunk:.2f}s, launches of the "
        f"warm-up and the capture {cap} = 2 x expected; bitwise == "
        f"{GRAPH_K} eager supersteps on every state tensor, the torch "
        f"generator, the buffer's arrays, its tree, ptr/count/max_priority "
        f"and the NumPy generator's state; an eval after each equal; "
        f"copies a superstep: rows {rows_b} B to the host, batch {batch_b} "
        f"B to the card, priorities {prio_b} B to the host; copy-back "
        f"{graph.copied_bytes / 1e6:.1f} MB")

    # walls in turns beside the device replay's graph of the same spec
    dexp = Experiment.from_spec(device_spec.override(loop="scan"))
    dtr = dexp.trainer
    dexp._ensure_init()
    dls, _ = dtr.chunk_fn(1, False)(dexp._ls)
    walls = []
    for loop in ("host eager", "host graphs", "device graph",
                 "device graph", "host graphs", "host eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if loop == "host eager":
            for _ in range(GRAPH_TIMED):
                eager, _, _ = tr.step(eager)
        elif loop == "host graphs":
            replayed, _ = tr.chunk_fn(GRAPH_TIMED, False)(replayed)
        else:
            dls, _ = dtr.chunk_fn(GRAPH_TIMED, False)(dls)
        torch.cuda.synchronize()
        walls.append((loop, 1e3 * (time.perf_counter() - t0) / GRAPH_TIMED))
    mean = {k: float(np.mean([m for n, m in walls if n == k]))
            for k, _ in walls}
    log(f"[host] wall per superstep, host clock, {GRAPH_TIMED} supersteps "
        f"a run, in turns: " + ", ".join(f"{k} {ms:.3f} ms"
                                         for k, ms in walls)
        + " (means: " + ", ".join(f"{k} {v:.3f}" for k, v in mean.items())
        + ")")
    del dexp, dtr, dls
    _free()
    def eager_run(n=10):
        nonlocal eager
        for _ in range(n):
            eager, _, _ = tr.step(eager)
    prof_e = host_profile(eager_run, 10, "host-prof",
                          "eager (loop='python')")
    prof_g = host_profile(lambda: graph.replay(GRAPH_K), GRAPH_K,
                          "host-prof", "two graphs (loop='scan')")
    del exp, tr, graph, eager, replayed, ls0
    _free()
    graph_checkpoint(spec, "host")
    with tempfile.TemporaryDirectory() as tmp:
        guard_supervisor(tmp, over=(), tag="host")
    return launches, {"walls": mean, "eager": prof_e, "graphs": prof_g,
                      "copy_bytes": {"rows": rows_b, "batch": batch_b,
                                     "priorities": prio_b}}


def _band_module():
    """``tests/data/return_band.py`` of the checkout (NumPy only): the
    reference's curves and the rule."""
    import importlib.util
    path = os.path.join(ROOT, "tests", "data", "return_band.py")
    spec = importlib.util.spec_from_file_location("return_band", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _band_seed(seed):
    """One seed of the band in a worker process of its own: the band's
    spec trained by the port on the card (``loop="scan"``: the two
    graphs), and the untrained agent's returns (the policy after the
    warm-up, evaluated once per eval point). Returns ``(eval steps,
    returns, untrained returns, seconds)``."""
    import torch
    from repro_torch.rl import presets
    from repro_torch.rl.envs import eval_returns
    from repro_torch.rl.experiment import Experiment
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    band = _band_module().load()
    t0 = time.perf_counter()
    exp = Experiment.from_spec(presets.get(band["preset"]).override(
        seed=seed, **band["override"]))
    exp._ensure_init()
    pol = exp.trainer.policy(exp._ls.agent["params"])
    gen = torch.Generator(device="cuda").manual_seed(10_000 + seed)
    untrained = [float(eval_returns(exp.trainer.env, pol,
                                    exp.spec.eval.episodes, gen).mean())
                 for _ in band["eval_steps"]]
    res = exp.run()
    torch.cuda.synchronize()
    return res.eval_steps, res.returns, untrained, \
        time.perf_counter() - t0


def phase_band():
    """ROADMAP A.11 on the card: the band's preset (``table1-orig``, its
    host replay, the band's budget) trained by the port for the band's 5
    seeds, one worker process a seed, all at once on the card; the curves
    held to the JAX package's by the band's rule, and an untrained agent's
    returns on the card must fail the same rule."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    rb = _band_module()
    band = rb.load()
    t0 = time.perf_counter()
    with ProcessPoolExecutor(len(band["seeds"]), mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        runs = list(pool.map(_band_seed, band["seeds"]))
    wall = time.perf_counter() - t0
    for seed, (steps, _, _, _) in zip(band["seeds"], runs):
        if steps != rb.eval_steps(band):
            raise AssertionError(f"band seed {seed}: eval steps {steps}")
    curves = [r[1] for r in runs]
    got, base = rb.check(curves, band), rb.check([r[2] for r in runs], band)
    ref_base = rb.check(band["untrained"], band)
    log(f"[band] A.11: {band['preset']} {band['override']}, seeds "
        f"{band['seeds']}, the port on the card, a process a seed at once "
        f"({wall:.1f}s; each "
        + ", ".join(f"{r[3]:.1f}" for r in runs)
        + f"s): late mean {got['port_late_mean']:.1f} vs the reference's "
        f"{got['ref_late_mean']:.1f}, z {got['z']:.2f} (passes at <= "
        f"{rb.Z_MAX}); the untrained agent on the card: late mean "
        f"{base['port_late_mean']:.1f}, z {base['z']:.2f}; the reference's"
        f" untrained agent z {ref_base['z']:.2f}; curves "
        + json.dumps([[round(r, 1) for r in c] for c in curves]))
    if not got["ok"] or base["ok"] or ref_base["ok"]:
        raise AssertionError(f"return band: port {got}, untrained {base}, "
                             f"reference untrained {ref_base}")
    return got


# the figure drivers (``repro_torch.figures``, ROADMAP A.10): the row
# names the reference's drivers emit at the quick scale (``benchmarks/``,
# written out here: the reference is not imported), and their fields
FIG_CUT = dict(total_steps=32, warmup_steps=16, eval_every=16,
               eval_episodes=1)
FIG_SOLO_FIELDS = ("name", "us_per_call", "derived", "std", "final_return",
                   "params", "srank", "seeds")
FIG_ROWS = {
    "fig1_depth": ([f"fig1_depth_L{n}" for n in (1, 2, 4)], ("layers",)),
    "fig3_width": ([f"fig3_width_U{n}" for n in (16, 64, 256)], ("units",)),
    "fig4_grid": ([f"fig4_grid_U{u}_L{n}" for u in (32, 128)
                   for n in (1, 4)], ("units", "layers")),
    "fig5_connectivity": ([f"fig5_{c}_{t}" for t in ("S", "L")
                           for c in ("mlp", "resnet", "densenet", "d2rl")],
                          ("connectivity", "size")),
    "fig6_ofenet": ([f"fig6_{o}_{t}" for t in ("S", "L")
                     for o in ("scratch", "ofenet")], ("ofenet", "size")),
    "fig8_distributed": ([f"fig8_{d}_{t}" for t in ("S", "L")
                          for d in ("single", "apex")],
                         ("distributed", "size")),
    "fig10_ablation": ([f"fig10_{v}" for v in (
        "full", "wo_apex", "wo_ofenet", "wo_larger_nn", "wo_densenet",
        "sac_original")], ()),
    "fig13_activation": (["fig13_swish", "fig13_relu"], ("activation",)),
    "table1_final": ([f"table1_{e}_{a}_{k}" for e in (
        "pendulum", "cartpole_swingup", "pointmass") for a in ("sac", "td3")
        for k in ("ours", "orig")], ("env", "algo", "kind")),
    "loss_landscape_bench": (["landscape_deep", "landscape_wide"], None),
}
FIG_FLEETS = ("fig1_depth", "fig3_width", "fig4_grid")
FIG_PRESETS = ("fig1-depth", "fig10-ablation", "fig13-activation",
               "fig3-width", "fig4-grid", "fig5-connectivity", "fig6-ofenet",
               "fig8-distributed", "fleet-smoke", "quickstart",
               "rl-distributed", "smoke", "table1-orig", "table1-ours")
FIG_STEPS = 8       # supersteps of the full-width rows and the C14 checks
LANDSCAPE_RES = 9   # points a side of the full-width J_Q surface


def _fig_check(name, rows):
    """``rows`` of driver ``name`` carry the reference's names and
    fields, with finite returns."""
    names, extra = FIG_ROWS[name]
    if name == "loss_landscape_bench":
        fields = {"name", "us_per_call", "derived", "loss_range", "return"}
    else:
        fields = set(FIG_SOLO_FIELDS) | set(extra)
        if name in FIG_FLEETS:
            fields.add("fleet")
    got = [r["name"] for r in rows]
    bad = [r["name"] for r in rows if set(r) != fields]
    finite = all(math.isfinite(r["return"] if name == "loss_landscape_bench"
                               else r["derived"]) for r in rows)
    if got != names or bad or not finite:
        raise AssertionError(f"{name}: rows {got} (want {names}), fields "
                             f"wrong in {bad}, finite {finite}")


def figs_c14():
    """C14 on the card: every preset builds as shipped, ``rl-distributed``
    trains as shipped through ``figures.rl_distributed``, and a fig3-width
    fleet and a solo ``rl-distributed`` run give one state, tree and
    return under ``replay.kernel="xla"`` and ``"pallas"``."""
    import torch
    from repro_torch.figures import common, fig3_width, presets_smoke, \
        rl_distributed
    from repro_torch.rl import presets
    from repro_torch.rl.experiment import Experiment
    from repro_torch.rl.runner import clone_state
    from repro_torch.rl.sweep import Sweep
    t0 = time.perf_counter()
    rows = presets_smoke.run("quick")
    names = tuple(r["name"][len("preset_build_"):] for r in rows)
    if names != FIG_PRESETS:
        raise AssertionError(f"presets_smoke built {names}")
    log(f"[figs] c14: presets_smoke built all {len(rows)} presets on the "
        f"card as shipped ({time.perf_counter() - t0:.1f}s), rl-distributed"
        f" and fleet-smoke with the device replay at replay.kernel='xla'")
    b = _counts()
    t0 = time.perf_counter()
    res = rl_distributed.main(["--steps", str(2 * FIG_CUT["eval_every"])])
    torch.cuda.synchronize()
    a = _counts()
    n = {k: a[k] - b[k] for k in ("sample", "set")}
    full = res["full"]
    if n["sample"] < 1 or n["set"] < 1 or not all(
            math.isfinite(r.max_return) for r in res.values()) \
            or full.eval_steps != [FIG_CUT["eval_every"],
                                   2 * FIG_CUT["eval_every"]]:
        raise AssertionError(f"rl_distributed: launches {n}, returns "
                             f"{[r.returns for r in res.values()]}")
    log(f"[figs] c14: figures.rl_distributed --steps "
        f"{2 * FIG_CUT['eval_every']} (rl-distributed as shipped: device "
        f"replay, replay.kernel='xla', the scan loop's graph; 5 variants) in "
        f"{time.perf_counter() - t0:.1f}s; tree launches outside the graphs"
        f" {n}; full: returns {full.returns}, {full.param_count:,} params")

    with common.cut_budget(**FIG_CUT):
        base = fig3_width.grid("quick")[0]
    solo_spec = presets.get("rl-distributed")
    runs = {}
    for kernel in ("xla", "pallas"):
        sw = Sweep.from_grid(base.override(replay_kernel=kernel),
                             axis={"num_units": [256]}, seeds=2)
        sw.run(FIG_STEPS, eval_at_end=True)
        exp = Experiment.from_spec(solo_spec.override(replay_kernel=kernel))
        exp.run(FIG_STEPS, eval_at_end=True)
        torch.cuda.synchronize()
        fl = sw.fleets[0]
        runs[kernel] = (clone_state(fl._fls), fl.returns,
                        clone_state(exp._ls), exp.returns)
        del sw, fl, exp
        _free()
    (fx, frx, sx, srx), (fp, frp, sp, srp) = runs["xla"], runs["pallas"]
    bad = fleet_state_diff(fx, fp) + state_diff(sx, sp)
    if bad or frx != frp or srx != srp:
        raise AssertionError(f"replay.kernel xla vs pallas differ: {bad[:8]}"
                             f", returns {frx} / {frp}, {srx} / {srp}")
    log(f"[figs] c14: replay.kernel 'xla' == 'pallas' bitwise after "
        f"{FIG_STEPS} supersteps and an eval: the fig3-width U=256 fleet of 2"
        f" seeds ({len(_state_names(fx))} state tensors, the member-axis "
        f"trees included, 2 generators; returns {frx}) and a solo "
        f"rl-distributed run ({len(_state_names(sx))} tensors, the tree "
        f"included, the generator; returns {srx})")
    del runs
    _free()


def figs_drivers():
    """Every driver's ``run("quick")`` on the card at ``FIG_CUT``, then
    ``figures.width_study``; rows printed and checked, walls logged.
    Returns the landscape rows."""
    import importlib
    import torch
    from repro_torch.figures import common, width_study
    walls, out = {}, None
    with common.cut_budget(**FIG_CUT):
        for name in FIG_ROWS:
            mod = importlib.import_module(f"repro_torch.figures.{name}")
            t0 = time.perf_counter()
            rows = mod.run("quick")
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            _fig_check(name, rows)
            for r in rows:
                log(f"[figs] {r['name']},{r['us_per_call']:.0f},"
                    f"{r['derived']}" + ("" if "std" not in r else
                                          f" (std {r['std']}, final "
                                          f"{r['final_return']}, params "
                                          f"{r['params']}, srank "
                                          f"{r['srank']!r}, seeds "
                                          f"{r['seeds']})"))
            if name == "loss_landscape_bench":
                out = rows
            _free()
    t0 = time.perf_counter()
    res = width_study.main(["--steps", str(FIG_CUT["total_steps"]),
                            "--override",
                            f"execution.warmup_steps="
                            f"{FIG_CUT['warmup_steps']}"])
    torch.cuda.synchronize()
    walls["width_study"] = time.perf_counter() - t0
    if len(res) != 3 or not all(math.isfinite(m.result.max_return)
                                for m in res):
        raise AssertionError(f"width_study: {res}")
    log(f"[figs] driver walls at total_steps={FIG_CUT['total_steps']}, "
        f"warm-up {FIG_CUT['warmup_steps']}, eval every "
        f"{FIG_CUT['eval_every']} (1 episode), host clock: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in walls.items())
        + f"; all {sum(walls.values()):.1f}s")
    return out


def figs_full_width(fleet_ms):
    """The two full-width rows at the paper budget, cut in supersteps:
    fig3-width's U=2048 grid point x 5 seeds as a fleet from
    ``fig3_width.grid("paper")`` (its replay time beside ``phase_fleet``'s
    ``fleet_ms`` of the same spec), and ``fig10_full`` (the host replay)
    through ``bench_run``."""
    import torch
    from repro_torch.figures import common, fig10_ablation, fig3_width
    from repro_torch.rl.sweep import Sweep
    base, units, seeds = fig3_width.grid("paper")
    if units[-1] != 2048 or seeds != FLEET_E:
        raise AssertionError(f"fig3 paper grid {units} x {seeds}")
    t0 = time.perf_counter()
    sweep = Sweep.from_grid(base, axis={"num_units": [2048]}, seeds=seeds)
    fl = sweep.fleets[0]
    sweep.run(1)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    sweep.run(FIG_STEPS - 1, eval_at_end=True)
    torch.cuda.synchronize()
    row = common.fleet_rows(sweep, lambda pt: f"fig3_width_U"
                            f"{pt['num_units']}",
                            lambda pt: {"units": pt["num_units"]})[0]
    if not math.isfinite(row["derived"]) or fl.step != FIG_STEPS:
        raise AssertionError(f"fig3 U=2048 fleet row {row}")
    walls = walls_in_turns({"figs-fleet": fl.graph}, "figs")
    ms = walls["figs-fleet"]
    ratio = ms / fleet_ms
    log(f"[figs] fig3_width_U2048 x {seeds} seeds through "
        f"fig3_width.grid('paper') + Sweep.from_grid (replay.kernel="
        f"'{fl.spec.replay.kernel}'): init, vmapped warm-up and capture "
        f"{t_init:.1f}s; {FIG_STEPS} supersteps + eval: row "
        f"{row['name']},{row['us_per_call']:.0f},{row['derived']}; "
        f"{ms:.3f} ms a replay, {ms / seeds:.3f} ms a member-superstep, "
        f"against phase_fleet's {fleet_ms:.3f} ms in this run "
        f"(x{ratio:.4f})")
    if abs(ratio - 1) > 0.05:
        raise AssertionError(f"the driver's fig3 U=2048 fleet {ms:.3f} ms a "
                             f"replay vs phase_fleet's {fleet_ms:.3f}")
    del sweep, fl
    _free()
    ov = fig10_ablation.variants("paper")["fig10_full"]
    spec = common.make_spec("paper", "fig10-ablation", **ov).override(
        total_steps=FIG_STEPS)
    t0 = time.perf_counter()
    row10 = common.bench_run("fig10_full", spec, seeds=2)
    torch.cuda.synchronize()
    if not math.isfinite(row10["derived"]) or spec.network.num_units != 2048:
        raise AssertionError(f"fig10_full row {row10}")
    log(f"[figs] fig10_full at the paper budget (U=2048, the host replay, "
        f"{spec.replay.backend}/{spec.execution.loop}, 2 seeds, warm-up "
        f"{spec.execution.warmup_steps}) cut to {FIG_STEPS} supersteps: "
        f"{time.perf_counter() - t0:.1f}s, row {row10['name']},"
        f"{row10['us_per_call']:.0f},{row10['derived']} (params "
        f"{row10['params']:,}; us_per_call is the wall over supersteps, "
        f"the warm-up and evals included)")
    _free()
    return {"fig3_ms": ms, "fleet_ms": fleet_ms, "fig3_row": row,
            "fig10_row": row10}


def figs_landscape(exp, landscape_rows):
    """The J_Q surface of the training cell's critics (U=2048, fused
    blocks) on a replay batch of 256, through the stack forward kernel and
    through its plain twin on the card, from one seeded generator's
    directions: held pointwise at relative 1e-4. Returns the forward
    launches of the kernel's surface."""
    import torch
    from repro_torch.core.loss_landscape import sharpness
    from repro_torch.figures import loss_landscape_bench as llb
    from repro_torch.kernels.dense_block import stack
    res = exp.run(1, keep_last=True)
    torch.cuda.synchronize()
    batch, acfg = res.last_batch, exp.trainer.acfg
    if batch["obs"].shape[0] != 256 or acfg.block_backend != "fused":
        raise AssertionError(f"landscape batch {batch['obs'].shape}, blocks "
                             f"{acfg.block_backend}")
    b = _counts()
    t0 = time.perf_counter()
    _, _, kern = llb.surface(res.state, batch, acfg,
                             resolution=LANDSCAPE_RES)
    torch.cuda.synchronize()
    t_kern = time.perf_counter() - t0
    a = _counts()
    fwd = a["fwd"] - b["fwd"]
    real = stack._kernel_forward

    def plain(x, ws, bs, connectivity, activation, *args, **kw):
        return stack.dense_stack_ref(x, ws, bs, connectivity=connectivity,
                                     activation=activation)
    stack._kernel_forward = plain
    try:
        t0 = time.perf_counter()
        _, _, ref = llb.surface(res.state, batch, acfg,
                                resolution=LANDSCAPE_RES)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        stack._kernel_forward = real
    c = _counts()
    pts = LANDSCAPE_RES ** 2
    rel = np.abs(kern - ref) / np.abs(ref)
    if fwd < pts or c["fwd"] != a["fwd"] or not np.all(rel <= 1e-4) \
            or not np.all(np.isfinite(kern)):
        raise AssertionError(f"landscape: {fwd} forward launches, plain "
                             f"{c['fwd'] - a['fwd']}, max rel {rel.max()}")
    log(f"[figs] landscape: J_Q of the fig10-ablation U=2048 critics "
        f"(fused: {fwd} stack forward launches, {fwd / pts:.0f} a point) on "
        f"a replay batch of 256, {LANDSCAPE_RES}x{LANDSCAPE_RES} points at "
        f"span 1.0, directions from a generator seeded "
        f"{llb.DIRECTION_SEED}: kernel {1e3 * t_kern / pts:.3f} ms a point,"
        f" plain twin {1e3 * t_plain / pts:.3f} (host clock, one read a "
        f"point); pointwise |kernel - plain| / |plain| max {rel.max():.2e} "
        f"(<= 1e-4); loss {kern.min():.4g}..{kern.max():.4g}, sharpness "
        f"{sharpness(kern):.4f} (plain {sharpness(ref):.4f})")
    log(f"[figs] loss_landscape_bench at the quick shapes (cut budget): "
        + ", ".join(f"{r['name']} {r['derived']} (loss range "
                    f"{r['loss_range']:.4g}, return {r['return']:.1f})"
                    for r in landscape_rows)
        + "; no ordering asserted at this budget")
    return fwd


def phase_figs(exp, fleet_ms):
    """The paper's figure drivers on the card (``repro_torch.figures``):
    C14's checks, every driver at a cut quick budget, the two full-width
    rows, and the full-width J_Q surface through the stack forward kernel
    against its plain twin. Returns the wrapper launches of the phase."""
    t0 = time.perf_counter()
    _reset_counts()
    figs_c14()
    landscape_rows = figs_drivers()
    full = figs_full_width(fleet_ms)
    figs_landscape(exp, landscape_rows)
    launches = _counts()
    log(f"[figs] phase wall {time.perf_counter() - t0:.1f}s; wrapper "
        f"launches over the phase, counted from 0: "
        + ", ".join(f"{k} {v}" for k, v in launches.items()))
    return launches, full


SHARDS = 4            # the sharded cell: the training cell at mesh_shards=4


def flat_diff(a, b):
    """``state_diff`` of two states whose tensors may differ by a leading
    axis of 1 (one shard against none): compared flat."""
    import torch
    from repro_torch.rl.runner import state_leaves
    bad = [(i, float((x.double().reshape(-1)
                      - y.double().reshape(-1)).abs().max())
            if x.numel() == y.numel() else float("nan"))
           for i, (x, y) in enumerate(zip(state_leaves(a), state_leaves(b)))
           if x.numel() != y.numel()
           or not torch.equal(x.reshape(-1), y.reshape(-1))]
    if not torch.equal(a.gen.get_state(), b.gen.get_state()):
        bad.append(("gen", float("nan")))
    return bad


def phase_sharded(gen, train_spec, steps=40):
    """The sharded device replay (``execution.mesh_shards``, ROADMAP A.8)
    at the training cell's spec: the member tree kernels at the shards'
    shapes (E=4, 25,000 rows and B=64 a shard, adds of 8 rows, refreshes
    of 64) bitwise their plain twins and timed beside 4 solo launches; one
    sample and two writes a superstep for all shards, with the unsharded
    stack launches, counted at capture; ``mesh_shards=1`` bitwise
    ``mesh_shards=0`` over ``steps`` supersteps under the graph; at 4
    shards the graph bitwise the eager loop (n_step 1 and 3); the walls in
    turns beside the unsharded graph, CUDA events, the profiler's idle
    share and kernels a replay; ``run(17); save; restore; run(23)`` ==
    ``run(40)``. Returns ``(tree records, launches over the
    mesh_shards=4 runs (init, warm-up, capture, eager and graph
    supersteps, n_step 1 and 3), {mesh_shards: device time record})``."""
    import torch
    from repro_torch.rl.experiment import Experiment
    from repro_torch.rl.runner import clone_state
    t0 = time.perf_counter()
    tree = phase_fleet_tree(gen, e=SHARDS, capacity=25_000, b=64,
                            ns=(8, 64), tag="sharded-tree")
    base = train_spec.override(loop="scan")
    runs = {}
    for n in (0, 1):
        e = Experiment.from_spec(base.override(mesh_shards=n))
        e.run(steps)
        torch.cuda.synchronize()
        runs[n] = e
    bad = flat_diff(runs[0]._ls, runs[1]._ls)
    if bad or runs[0].trainer.captures != 1 \
            or runs[1].trainer.captures != 1:
        raise AssertionError(f"mesh_shards=1 != mesh_shards=0 after {steps}"
                             f" supersteps under the graph: {bad[:8]}")
    log(f"[sharded] mesh_shards=1 == mesh_shards=0 over {steps} supersteps "
        f"under the graph (one capture each), bitwise on every state tensor"
        f" (flat: the shard axis of 1) and the generator")
    graphs = {"n=0": runs[0].trainer.graph}
    del runs[1]
    _reset_counts()          # counted: the mesh_shards=4 runs alone
    for ns in (1, 3):
        exp = Experiment.from_spec(base.override(mesh_shards=SHARDS,
                                                 n_step=ns))
        tr = exp.trainer
        exp._ensure_init()
        ls0 = clone_state(exp._ls)
        rep = ls0.replay
        if rep["tree"].shape[0] != SHARDS or tr.dcfg.capacity != 25_000:
            raise AssertionError(f"sharded state {tuple(rep['tree'].shape)}"
                                 f", capacity {tr.dcfg.capacity}")
        graph = graph_capture(tr, ls0, expected_launches(tr),
                              f"sharded n_step={ns}")
        graph_bitwise(tr, ls0, f"sharded n_step={ns}")
        if ns == 1:
            graphs[f"n={SHARDS}"], keep = graph, exp
        else:
            del exp, tr, graph
    launches = _counts()
    log(f"[sharded] store {tuple(rep['store']['data']['obs'].shape)}, tree "
        f"{tuple(rep['tree'].shape)}, add_step "
        f"{tuple(rep['add_step'].shape)} a state; wrapper launches over "
        f"the mesh_shards={SHARDS} runs (n_step 1 and 3), counted from 0: "
        + ", ".join(f"{k} {v}" for k, v in launches.items()))
    walls = walls_in_turns(graphs, "sharded")
    times = {k: graph_device_time(g, f"sharded {k}", f"sharded-prof {k}")
             for k, g in graphs.items()}
    w4 = walls[f"n={SHARDS}"]
    log(f"[sharded] the graph at mesh_shards={SHARDS}: {w4:.3f} ms a replay"
        f" (host clock) beside {walls['n=0']:.3f} unsharded "
        f"(x{w4 / walls['n=0']:.4f}); CUDA events "
        + ", ".join(f"{k} {v['events_ms']:.3f} ms" for k, v in times.items())
        + "; idle " + ", ".join(
            f"{k} " + ("not measured" if v["idle"] is None
                       else f"{100 * v['idle']:.1f}%")
            for k, v in times.items()))
    del keep, graphs, runs
    _free()
    graph_checkpoint(base.override(mesh_shards=SHARDS), "sharded")
    sharded_obs_guard(base.override(mesh_shards=SHARDS))
    log(f"[sharded] phase wall {time.perf_counter() - t0:.1f}s")
    return tree, launches, {k: dict(v, wall_ms=walls[k])
                            for k, v in times.items()}


def sharded_obs_guard(spec, steps=10):
    """The sharded spec with obs and the guard on (memory sink, every
    step; the guard halting) in both loops, against the scan loop with
    both off: ``steps`` supersteps each, bitwise one state, the stream's
    rows every step, every parameter finite."""
    import torch
    from repro_torch.guard.monitor import all_finite
    from repro_torch.rl.experiment import Experiment
    on = {"obs.enabled": True, "obs.log_every": 1, "guard.enabled": True}
    runs = {}
    for name, over in (("scan", {}), ("scan+obs+guard", on),
                       ("python+obs+guard", dict(on, loop="python"))):
        e = Experiment.from_spec(spec.override(**over))
        e.run(steps)
        torch.cuda.synchronize()
        runs[name] = e
    base = runs["scan"]
    for name, e in runs.items():
        bad = state_diff(base._ls, e._ls)
        rows = [r["step"] for r in e.obs.rows if r["kind"] == "train"]
        if bad or not all_finite(e._ls.agent["params"]) or (
                e.spec.obs.enabled and rows != list(range(1, steps + 1))):
            raise AssertionError(f"sharded {name}: state {bad[:8]}, train "
                                 f"rows {rows}")
    log(f"[sharded] obs and the guard on, both loops, {steps} supersteps "
        f"at mesh_shards={SHARDS}: bitwise the scan loop with both off, "
        f"a stream row every step, every parameter finite")
    del runs, base
    _free()


def phase_check(train_spec):
    """``repro_torch.check dynamic`` on the card: the ``smoke`` preset and
    the sharded cell's spec at a cut budget (12 supersteps, eval and srank
    every 6), each with zero findings and D001 run (the steady-state pass
    under ``torch.cuda.set_sync_debug_mode("error")``); then, as a control,
    ``smoke`` with a ``float()`` of a device tensor after every chunk,
    which D001 must report."""
    from repro_torch.check import dynamic
    from repro_torch.rl import runner
    x = train_spec.execution
    cut = {"network.num_units": train_spec.network.num_units,
           "network.block_backend": train_spec.network.block_backend,
           "ofenet.num_units": train_spec.ofenet.num_units,
           "ofenet.num_layers": train_spec.ofenet.num_layers,
           "replay.capacity": train_spec.replay.capacity,
           "execution.batch_size": x.batch_size,
           "execution.mesh_shards": SHARDS, "execution.warmup_steps": 512,
           "eval.every": 6, "eval.srank_every": 6, "eval.episodes": 1}
    for preset, steps, over in (("smoke", None, {}),
                                ("fig10-ablation", 12, cut)):
        t0 = time.perf_counter()
        findings, status = dynamic.run_sanitizers(preset, steps=steps,
                                                  overrides=over)
        if findings or status["D001"] != "passed":
            raise AssertionError(f"check dynamic {preset}: {status}\n"
                                 + dynamic.report(findings, status))
        log(f"[check] repro_torch.check dynamic --preset {preset}"
            + (f" --steps {steps} " + " ".join(
                f"--override {k}={v}" for k, v in over.items())
               if over else "")
            + f": " + ", ".join(f"{g} {s}" for g, s in status.items())
            + f", zero findings ({time.perf_counter() - t0:.1f}s)")
    inner = runner.Trainer.chunk_fn

    def reading(self, n_steps, do_eval, do_srank=False):
        chunk = inner(self, n_steps, do_eval, do_srank)

        def read(ls):
            ls, out = chunk(ls)
            float(ls.step)               # a host read outside host_read
            return ls, out
        return read
    runner.Trainer.chunk_fn = reading
    try:
        findings, status = dynamic.run_sanitizers("smoke")
    finally:
        runner.Trainer.chunk_fn = inner
    if status["D001"] != "failed" or [f.rule for f in findings] != ["D001"]:
        raise AssertionError(f"check dynamic missed an injected sync: "
                             f"{status}")
    log(f"[check] control: smoke with float(ls.step) after every chunk: "
        f"D001 failed as it must ("
        + findings[0].message.splitlines()[-1][:120] + ")")


def phase_quickstart():
    """``python -m repro_torch.launch.quickstart`` on the card at a cut
    budget with ``--serve`` (the served actions the direct ones: "match")
    and ``--log-dir``, then ``python -m repro_torch.obs.report`` over the
    log directory."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as tmp:
        logs = os.path.join(tmp, "runs")
        cmds = [[sys.executable, "-m", "repro_torch.launch.quickstart",
                 "--steps", "16", "--serve", "--log-dir", logs,
                 "--override", "warmup_steps=512", "--override",
                 "eval_episodes=1"],
                [sys.executable, "-m", "repro_torch.obs.report", logs]]
        outs = []
        for cmd in cmds:
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, env=env, cwd=ROOT,
                                  capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"{' '.join(cmd[2:4])} exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            outs.append((proc.stdout, time.perf_counter() - t0))
        (qs, t_qs), (rep, t_rep) = outs
        served = [l for l in qs.splitlines() if l.startswith("served")]
        if not served or "match direct policy call" not in served[0] \
                or not os.path.exists(os.path.join(logs, "metrics.jsonl")):
            raise AssertionError(f"quickstart on the card:\n{qs[-2000:]}")
    last = [l for l in qs.splitlines() if l.startswith("step")][-1]
    log(f"[quickstart] python -m repro_torch.launch.quickstart --steps 16 "
        f"--serve --log-dir <tmp> (warm-up 512, 1 eval episode) on the "
        f"card: {t_qs:.1f}s; {last.strip()}; {served[0].strip()}")
    log(f"[quickstart] python -m repro_torch.obs.report <tmp>: exit 0 "
        f"({t_rep:.1f}s), {len(rep.splitlines())} lines")


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


def fleet_record(r):
    """A member-axis tree record for the kernel line: the batched launch's
    times beside E solo launches' and, at E=1, the member entry's beside
    the solo one's."""
    out = {"E": r["E"], "bound_ms": r["bound_ms"],
           "bound_by": r["bound_by"]}
    for k in ("batched", "solo_x_e", "e1_members", "e1_solo"):
        for t in ("ms", "hot_call_ms", "cold_ms"):
            out[f"{k}_{t}"] = r[k][t]
    return out


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
    phase_whole_bwd(gen)
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

    train_spec = spec.override(replay_backend="device")
    exp, train_launches = phase_train(train_spec)
    profile_classes = phase_train_profile(exp)
    # early: after the fleets' runs in this process the profiler was seen
    # to record no device kernel (PERF.md section 7)
    phase_fwd_fills(gen)
    td3_spec = train_spec.override(algo="td3")
    td3_launches = phase_td3(td3_spec)
    phase_graph(train_spec, ckpt_specs=(td3_spec,))
    # early too: its replays are profiled (the idle share)
    sharded_tree, sharded_launches, _ = phase_sharded(gen, train_spec)
    phase_obs_guard(train_spec)
    host_launches, _ = phase_host(spec, train_spec)
    phase_band()
    fleet_tree, fleet_launches, fleet_ms, jnp_fleet = phase_fleet(gen)
    fused = phase_fleet_fused(gen, *jnp_fleet, train_spec)
    del jnp_fleet
    _free()
    micro_launches = phase_micro()

    rows = phase_times(pol.params, gen)
    bwd = phase_bwd_times(gen, profile_classes)
    tree = phase_tree_times(gen)
    new = phase_new_times(gen)
    phase_check(train_spec)
    phase_quickstart()
    # last of the phases: after its ~60 runs in this process the profiler
    # has been seen to drop device kernels (PERF.md section 7)
    figs_launches, _ = phase_figs(exp, fleet_ms)
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
                          "train": train_launches["fwd"],
                          "train_td3": td3_launches["fwd"],
                          "train_host": host_launches["fwd"],
                          "fleet": fused["launches"]["fleet"]["fwd"],
                          "fleet_train":
                              fused["launches"]["fleet_train"]["fwd"],
                          "sharded": sharded_launches["fwd"],
                          "figs": figs_launches["fwd"]},
        launches_by_kernel={k: train_launches[f"fwd_{k}"]
                            for k in stack.FWD_KERNELS},
        launches_by_kernel_fleet_fig3={
            k: fused["launches"]["fleet"][f"fwd_{k}"]
            for k in stack.FWD_KERNELS},
        fleet=fused["kernels"]["fwd"]["critic"],
        fleet_by_shape=fused["kernels"]["fwd"],
        fleet_fig3=fused["fig3"], fleet_train=fused["train"],
        stream_t_inits=train_launches["fwd_t"],
        by_shape={f"{name} M={m}": {k: v[k] for k in (*keys, "old_tile_ms")
                                     if k in v}
                  for (name, m), v in rows.items()},
        profile_ms=dict(profile_classes[2]))
    print(json.dumps({"kernels": [
        fwd_rec,
        record("dense_stack_bwd",
               "src/repro_torch/kernels/dense_block/csrc/dense_stack_bwd.cu",
               "src/repro/kernels/dense_block/stack.py:334",
               train_launches["bwd"], bwd["critic"],
               "critic stack d0=516 U=2048 L=2, M=256: dx + dW + db",
               launches_by_path={"train": train_launches["bwd"],
                                 "train_td3": td3_launches["bwd"],
                                 "train_host": host_launches["bwd"],
                                 "fleet": fused["launches"]["fleet"]["bwd"],
                                 "fleet_train":
                                     fused["launches"]["fleet_train"]["bwd"],
                                 "sharded": sharded_launches["bwd"],
                                 "figs": figs_launches["bwd"]},
               launches_by_kernel={
                   "whole": train_launches["bwd_whole"],
                   "layers": train_launches["bwd"]
                   - train_launches["bwd_whole"]},
               launches_by_kernel_td3={
                   "whole": td3_launches["bwd_whole"],
                   "layers": td3_launches["bwd"] - td3_launches["bwd_whole"]},
               by_shape={name: {k: v for k, v in bwd[name].items()
                                if k != "products"}
                         for name in ("phi_s", "phi_sa")},
               fleet=fused["kernels"]["bwd"]["critic"],
               fleet_by_shape=fused["kernels"]["bwd"]),
        record("tree_sample",
               "src/repro_torch/kernels/replay_tree/csrc/replay_tree.cu",
               "src/repro/kernels/replay_tree/replay_tree.py:36",
               train_launches["sample"], tree["sample"],
               "tree 2^18 nodes (capacity 100,000), B=256",
               launches_by_path={"train": train_launches["sample"],
                                 "train_td3": td3_launches["sample"],
                                 "fleet": fleet_launches["sample"],
                                 "sharded": sharded_launches["sample"],
                                 "figs": figs_launches["sample"]},
               **{k: tree["sample"][k] for k in TREE_KEYS},
               fleet=fleet_record(fleet_tree["sample"]),
               sharded=fleet_record(sharded_tree["sample"]),
               profile_ms=profile_classes[3]["sample"][0]),
        record("tree_set",
               "src/repro_torch/kernels/replay_tree/csrc/replay_tree.cu",
               "src/repro/kernels/replay_tree/replay_tree.py:87",
               train_launches["set"], tree["set256"],
               "tree 2^18 nodes, n=256 (the priority refresh)",
               launches_by_path={"train": train_launches["set"],
                                 "train_td3": td3_launches["set"],
                                 "fleet": fleet_launches["set"],
                                 "sharded": sharded_launches["set"],
                                 "figs": figs_launches["set"]},
               fleet=fleet_record(fleet_tree["set256"]),
               fleet_by_n={32: fleet_record(fleet_tree["set32"])},
               sharded=fleet_record(sharded_tree["set64"]),
               sharded_by_n={8: fleet_record(sharded_tree["set8"])},
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
               "G=16 H=16 Q=256 N=P=64 (B=2 S=2048 at chunk 256), float32; "
               "launches from kernels_micro.run(); 3xTF32 on the tensor "
               "cores, bound_ms the larger of bytes and theirs; bf16: the "
               "same shape in bfloat16",
               bf16={k: new["ssd_chunk_dual"]["bf16"][k] for k in (
                   "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                   "max_abs_err")}),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
