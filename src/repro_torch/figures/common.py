"""Shared scaffolding of the figure drivers over the preset registry (port
of ``benchmarks/common.py``).

Every driver exposes ``run(scale, *, device=None) -> list[dict]`` with
scale in {"quick", "paper"}: "quick" is the presets' own small budget (1
seed), "paper" the paper's settings (1M steps, 5 seeds). ``run.py`` prints
the rows as ``name,us_per_call,derived`` CSV.

Drivers call ``common.make_spec(scale, "fig5-connectivity",
num_units=2048, ...)``: the named preset, then the scale's budget, then
the row's overrides. ``bench_run`` drives a spec through
``Experiment.run`` seed by seed, ``fleet_rows`` turns a finished
``Sweep`` into rows of the same schema. Both run on the card unless the
caller passes ``device="cpu"``.

``cut_budget(**budget)`` applies ``budget`` after every row's overrides
inside its block, so any driver runs at a smoke-sized budget as it stands
(the card's ``chip_smoke.py`` and the CPU tests do).
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.rl import presets
from repro_torch.rl.experiment import Experiment, ExperimentSpec

# the presets carry the quick budget (and each scenario's actor pool); the
# paper budget lifts the fields quick shrank, on top of the 1M-step
# settings, and leaves scenario knobs such as n_core/n_env alone
PAPER = dict(total_steps=1_000_000, warmup_steps=10_000, eval_every=10_000,
             eval_episodes=10, replay_capacity=100_000, batch_size=256,
             ofenet_units=64, ofenet_layers=4)


def make_spec(scale: str, preset: str, **overrides) -> ExperimentSpec:
    """Preset -> scale budget -> per-row overrides, validated end to end.
    Only "paper" takes the 1M-step settings; any other scale keeps the
    presets' budget."""
    budget = PAPER if scale == "paper" else {}
    return presets.get(preset).override(**{**budget, **overrides})


@contextlib.contextmanager
def cut_budget(**budget) -> Iterator[None]:
    """Within the block, ``make_spec`` applies ``budget`` (any
    ``override`` keys, e.g. ``total_steps``, ``warmup_steps``) after the
    row's own overrides; the drivers read ``common.make_spec`` at call
    time, so they run at that budget unchanged."""
    global make_spec
    full = make_spec

    def cut(scale: str, preset: str, **overrides) -> ExperimentSpec:
        return full(scale, preset, **overrides).override(**budget)
    make_spec = cut
    try:
        yield
    finally:
        make_spec = full


def bench_run(name: str, spec: ExperimentSpec, extra: Optional[Dict] = None,
              seeds: int = 1, *, device: DeviceLike = None) -> Dict:
    """One row: ``spec`` run to its budget for ``seeds`` seeds (seed,
    seed + 1, ...) one after the other, each with an eval at its end."""
    device = resolve_device(device)
    t0 = time.time()
    results = []
    for i in range(seeds):
        exp = Experiment.from_spec(
            spec.override(seed=spec.execution.seed + i), device=device)
        results.append(exp.run(eval_at_end=True))
    wall = time.time() - t0
    maxes = [r.max_return for r in results]
    total = spec.execution.total_steps
    row = {
        "name": name,
        "us_per_call": 1e6 * wall / max(total * seeds, 1),
        "derived": round(float(np.mean(maxes)), 2),   # mean over seeds of max
        "std": round(float(np.std(maxes)), 2),
        "final_return": round(float(np.mean([r.final_return
                                             for r in results])), 2),
        "params": results[0].param_count,
        "srank": results[-1].sranks[-1] if results[-1].sranks else "",
        "seeds": seeds,
    }
    row.update(extra or {})
    return row


def fleet_rows(sweep, name_fn: Callable[[Dict], str],
               extra_fn: Optional[Callable[[Dict], Dict]] = None
               ) -> List[Dict]:
    """A finished ``Sweep`` as ``bench_run``-schema rows: one row a fleet
    (a grid point; ``from_grid`` puts a point's seeds in one fleet), its
    seeds aggregated as ``bench_run`` aggregates its loop, ``us_per_call``
    the fleet's wall over its member-supersteps."""
    rows = []
    for fl in sweep.fleets:
        results = fl.results()
        maxes = [r.max_return for r in results]
        point = fl.points[0]
        row = {
            "name": name_fn(point),
            "us_per_call": 1e6 * fl._wall / max(fl.step * fl.n_members, 1),
            "derived": round(float(np.mean(maxes)), 2),
            "std": round(float(np.std(maxes)), 2),
            "final_return": round(float(np.mean(
                [r.final_return for r in results])), 2),
            "params": results[0].param_count,
            "srank": results[-1].sranks[-1] if results[-1].sranks else "",
            "seeds": fl.n_members,
            "fleet": True,
        }
        if extra_fn:
            row.update(extra_fn(point))
        rows.append(row)
    return rows


def print_rows(rows: List[Dict]) -> None:
    for r in rows:
        print(f"{r['name']},{r['us_per_call']:.0f},{r['derived']}")


def main(run_fn: Callable, argv=None, *, fleet: bool = False) -> None:
    """A driver's command line: ``--scale``, ``--device`` (the card when
    left out) and, for a fleet driver, ``--sequential``."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="quick")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when left out")
    if fleet:
        ap.add_argument("--sequential", action="store_true",
                        help="one Experiment at a time (A/B against the "
                             "fleet)")
    args = ap.parse_args(argv)
    kw = dict(sequential=args.sequential) if fleet else {}
    print_rows(run_fn(args.scale, device=args.device, **kw))
