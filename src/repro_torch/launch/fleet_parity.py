"""Fused fleet members against their solo runs, superstep by superstep, and
the cause of every superstep whose sampled batches differ.

    python -m repro_torch.launch.fleet_parity [--seeds 5] [--steps 40]
        [--repeats 2] [--paths tile,rt] [--out FILE]

On the card: the fused fleet of ``fig3-width`` at 2048 units (mlp, the
device replay, one graph) of ``--seeds`` seeds, each member against the
solo fused run of its seed from the same state, ``--repeats`` times for
each forward path of the fleet's wide mlp layers past 32 rows (``tile``:
``dense_tile.cuh``, the path before the register tile; ``rt``: the
default, the tensor-core tile at 2048 units). It prints one line a run
and writes every run's record
(each flip with its cause) to ``--out`` as JSON.

A member and its solo run are not bitwise: a batched product or reduction
rounds differently from its solo one. So the priorities their sum-trees
hold differ by rounding, and a stratified draw that falls between a
row's cumulative priority in one tree and in the other samples the
neighbouring row in one run and not in the other: a sample flip. From
then on the two train on different batches, which no tolerance covers.
``hold_members`` therefore holds each member to ``SOLO_PARITY`` after
every superstep and accepts a superstep whose batches differ only where
``flip_cause`` shows that cause: it rebuilds the tree each run sampled
from its state before the superstep, puts the same draws through both,
checks that this reproduces both runs' batches, and measures each
differing row's draw against the boundary between its two rows in either
tree. The solo run then restarts from the member's state.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional

# a sampled row whose observation differs from the other run's by more
# than this is another row of the replay (same rows differ by rounding)
ROW_DIFF = 1e-3
# rebuilt IS weights against the run's own, relative to the largest
WEIGHT_TOL = 1e-6


def fig3_spec():
    """``fig3-width`` at the paper budget, 2048 units, fused blocks, the
    device replay on its kernels, the scan loop (``chip_smoke.py``'s fused
    fig3 fleet)."""
    from repro_torch.rl import presets
    return presets.get("fig3-width").override(
        total_steps=1_000_000, warmup_steps=10_000, eval_every=10_000,
        eval_episodes=10, replay_capacity=100_000, batch_size=256,
        ofenet_units=64, ofenet_layers=4, num_units=2048,
        replay_backend="device", loop="scan", block_backend="fused")


def batch_of(graph, first: bool):
    """The batch of the superstep a ``run(1)`` just ran under ``graph``:
    the warm-up's for the chunk that captured it, else the last replay's."""
    return graph.warm[1] if first else graph.batch


def differing_rows(a, b) -> List[int]:
    """The rows of two sampled ``obs`` batches that are other replay
    rows."""
    return [int(i) for i in
            ((a - b).abs().amax(-1) > ROW_DIFF).nonzero().flatten()]


def param_ratio(fleet_params, solo_params, m: int) -> float:
    """The largest elementwise ``|member - solo| / (atol + rtol |solo|)``
    over the param leaves at the member-vs-solo tolerance (``SOLO_PARITY``;
    <= 1 passes)."""
    from repro_torch.common import tree_leaves
    from repro_torch.rl.sweep import SOLO_PARITY_ATOL, SOLO_PARITY_RTOL
    ratio = 0.0
    for f, s in zip(tree_leaves(fleet_params), tree_leaves(solo_params)):
        d = (f[m].double() - s.double()).abs()
        ratio = max(ratio, float((d / (SOLO_PARITY_ATOL + SOLO_PARITY_RTOL
                                       * s.double().abs())).max()))
    return ratio


def _sample_time(tr, pre):
    """From a copy of the loop state ``pre``: the superstep's draws, its
    collect and add (the solo trainer's, eagerly), and the sample: ``(the
    tree sampled, the uniform draws, the leaves, the IS weights)``."""
    from repro_torch.rl.runner import clone_state
    ls = clone_state(pre)
    draws = tr.draws(ls.gen)
    _, _, rstate = tr._collect_add(tr._train_policy, ls, draws["collect"],
                                   drop=0)
    tree = rstate["tree"].clone()
    _, idx, w = tr._sample(rstate, draws["u"], tr.batch_size)
    return tree, draws["u"], idx, w


def draws_at_boundaries(la, lb, ia, ib, u, b: int) -> List[Dict]:
    """Each row whose sampled leaves ``ia`` and ``ib`` differ between two
    trees of leaf priorities ``la`` and ``lb`` (float64), under the same
    uniform draws ``u`` of ``b`` strata: its stratified draw ``r = (row +
    u) / b``, the boundary between its two leaves in each tree (the sum
    of the leaves before the upper one over the tree's total), ``dist``,
    the larger of r's distances from the two, and ``between``: whether a
    leaf between the two holds priority in either tree."""
    suma, sumb = float(la.sum()), float(lb.sum())
    out = []
    for i in (ia != ib).nonzero().flatten().tolist():
        lo, hi = sorted((int(ia[i]), int(ib[i])))
        r = (i + float(u[i])) / b
        ca = float(la[:hi].sum()) / suma
        cb = float(lb[:hi].sum()) / sumb
        out.append(dict(row=i, leaves=(int(ia[i]), int(ib[i])), r=r,
                        member=ca, solo=cb,
                        dist=max(abs(r - ca), abs(r - cb)),
                        between=bool((la[lo + 1:hi] != 0).any()
                                     or (lb[lo + 1:hi] != 0).any())))
    return out


def flip_cause(tr, pre_member, pre_solo, rows: List[int], w_member,
               w_solo) -> Dict:
    """Why a member's superstep sampled ``rows`` other than its solo
    run's. ``pre_*`` are the two runs' states before the superstep,
    ``w_*`` the IS weights each sampled. Both trees are rebuilt with the
    solo trainer (a sum-tree write depends only on the rows written and
    the running max priority, and the member-axis tree kernels are
    bitwise their solo launches), the same draws put through both. The
    cause is shown (``shown``) where the draws are the same, the rebuilt
    leaves differ in exactly ``rows``, the rebuilt weights are each run's
    own (to ``WEIGHT_TOL``), and for each such row
    (``draws_at_boundaries``) the two sampled leaves are neighbours and
    the row's draw lies within float32 rounding (``tol``: the targets'
    and the descent's, ``2 (depth + 2) 2^-24`` of the total) of the
    boundary between them in BOTH trees."""
    import torch
    ta, u, ia, wa = _sample_time(tr, pre_member)
    tb, ub, ib, wb = _sample_time(tr, pre_solo)
    cap, half = tr.dcfg.capacity, ta.shape[-1] // 2
    tol = 2 * (int(math.log2(ta.shape[-1])) + 2) * 2.0 ** -24
    la, lb = ta[half:half + cap].double(), tb[half:half + cap].double()
    draws = draws_at_boundaries(la, lb, ia, ib, u, tr.batch_size)
    rebuilt = [d["row"] for d in draws]
    werr = max(float((x - y).abs().max() / y.abs().max())
               for x, y in ((wa, w_member), (wb, w_solo)))
    rec = dict(rows=list(rows), rebuilt_rows=rebuilt,
               same_draws=bool(torch.equal(u, ub)), weights_err=werr,
               leaves_rel=float((la - lb).abs().max() / la.abs().max()),
               tol=tol, draws=draws)
    rec["shown"] = (rec["same_draws"] and rebuilt == list(rows)
                    and werr <= WEIGHT_TOL and bool(rebuilt)
                    and all(not d["between"] and d["dist"] <= tol
                            for d in draws))
    return rec


def hold_members(fl, exps: Dict[int, object], steps: int,
                 after_first: Optional[Callable[[], None]] = None) -> Dict:
    """Members ``exps``' keys of the fused fleet ``fl`` against their solo
    runs ``exps[k]`` (each from the member's state), ``steps`` supersteps
    of both, one at a time. After each: the sampled batches compared
    (``differing_rows``); where they agree, the member's params held at
    ``SOLO_PARITY`` (ratio <= 1); where they differ (a sample flip), its
    cause shown by ``flip_cause`` and the solo run restarted from the
    member's state. ``after_first`` runs after the fleet's first
    superstep, before any solo one. Returns ``{member: {"worst": the
    largest ratio, "flips": [(superstep, rows, ratio, cause)], "fault":
    None or what failed}}``; a member stops at its first fault."""
    import torch
    from repro_torch.rl.runner import clone_state, member_state
    out = {k: dict(worst=0.0, flips=[], fault=None) for k in exps}
    for t in range(1, steps + 1):
        live = [k for k in exps if out[k]["fault"] is None]
        pre = {k: (clone_state(member_state(fl._fls, k)),
                   clone_state(exps[k]._ls)) for k in live}
        fl.run(1)
        if t == 1 and after_first is not None:
            after_first()
        for k in live:
            exp, rec = exps[k], out[k]
            exp.run(1)
            torch.cuda.synchronize()
            fb = batch_of(fl.graph, t == 1)
            sb = batch_of(exp.trainer.graph, t == 1)
            rows = differing_rows(fb["obs"][k], sb["obs"])
            ratio = param_ratio(fl._fls.agent["params"],
                                exp._ls.agent["params"], k)
            if rows:
                cause = flip_cause(exp.trainer, *pre[k], rows,
                                   fb["weight"][k], sb["weight"])
                rec["flips"].append((t, rows, ratio, cause))
                if not cause["shown"]:
                    rec["fault"] = (f"superstep {t}: rows {rows} sampled "
                                    f"other than the solo run's, cause not "
                                    f"shown: {cause}")
                    continue
                exp._ls = clone_state(member_state(fl._fls, k))
                continue
            rec["worst"] = max(rec["worst"], ratio)
            if ratio > 1.0:
                rec["fault"] = (f"superstep {t}: outside SOLO_PARITY "
                                f"(ratio {ratio:.4f})")
    return out


def flips_line(rec: Dict) -> str:
    """One member's flips, each with its rows' draws against the
    boundaries."""
    return "; ".join(
        f"superstep {t} rows {rows}: " + ", ".join(
            f"r {d['r']:.9f} vs member {d['member']:.9f} / solo "
            f"{d['solo']:.9f} (dist {d['dist']:.2e} <= {c['tol']:.2e}: "
            f"{d['dist'] <= c['tol']})" for d in c["draws"])
        + f", leaves rel {c['leaves_rel']:.2e}, weights "
          f"{c['weights_err']:.1e}, shown {c['shown']}"
        for t, rows, _, c in rec["flips"]) or "none"


def _set_path(path: str) -> None:
    """The forward path of the wide mlp/d2rl layers past 32 rows: ``rt``
    (the default: ``plan_fwd_stack``'s pick, the tensor-core tile at these
    widths, the register tile where U is not a multiple of 4) or ``tile``
    (``dense_tile.cuh``)."""
    from repro_torch.kernels.dense_block import stack
    orig = getattr(stack._kernel_forward, "func", stack._kernel_forward)
    stack._kernel_forward = functools.partial(orig, mlp_rt=path == "rt")


def run_once(seeds: int, steps: int) -> Dict:
    """One fused fig3 fleet of ``seeds`` seeds, every member against its
    solo run (``hold_members``)."""
    import torch
    from repro_torch.rl.experiment import Experiment
    from repro_torch.rl.runner import clone_state, member_state
    from repro_torch.rl.sweep import Fleet
    spec = fig3_spec()
    specs = [spec.override(seed=s) for s in range(seeds)]
    fl = Fleet(specs)
    fl._ensure_init()
    exps = {}
    for k in range(seeds):
        exps[k] = Experiment.from_spec(specs[k])
        exps[k]._ls = clone_state(member_state(fl._fls, k))
    t0 = time.perf_counter()
    out = hold_members(fl, exps, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del fl, exps
    torch.cuda.empty_cache()
    return dict(members=out, seconds=wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--paths", default="tile,rt")
    ap.add_argument("--out", default="experiments/fleet_parity.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fleet_parity: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    for path in args.paths.split(","):
        _set_path(path)
        for rep in range(args.repeats):
            res = run_once(args.seeds, args.steps)
            runs.append(dict(path=path, repeat=rep, **res))
            for k, rec in res["members"].items():
                print(f"[fleet-parity] {path} repeat {rep} seed {k}: worst "
                      f"ratio {rec['worst']:.4f}, fault {rec['fault']}, "
                      f"flips: {flips_line(rec)}", flush=True)
    _set_path("rt")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1, default=str)
    summary = {f"{r['path']}/{r['repeat']}": {
        k: [t for t, *_ in m["flips"]] for k, m in r["members"].items()}
        for r in runs}
    print(json.dumps({"flip_supersteps": summary,
                      "faults": sum(m["fault"] is not None for r in runs
                                    for m in r["members"].values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
