"""The paper's central claim, §4.1: wider helps, deeper hurts, as one
runnable study (port of ``examples/width_study.py``).

The three shapes run through ``Sweep.from_grid``: an irregular grid makes
one fleet a shape (each has its own parameter shapes), with ``--seeds``
batched inside each.

    python -m repro_torch.figures.width_study [--steps 400] [--seeds 1]
        [--override execution.loop=scan] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List

from repro_torch.rl import presets
from repro_torch.rl.experiment import parse_overrides
from repro_torch.rl.sweep import MemberResult, Sweep

GRID = [("deep (6x32)", dict(num_layers=6, num_units=32)),
        ("base (2x32)", dict(num_layers=2, num_units=32)),
        ("wide (2x256)", dict(num_layers=2, num_units=256))]


def main(argv=None) -> List[MemberResult]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when left out")
    args = ap.parse_args(argv)
    base = presets.get("fig4-grid").override(
        n_env=1, total_steps=args.steps, warmup_steps=300,
        eval_every=max(args.steps // 2, 1),
        replay_backend="device", loop="scan",
        **parse_overrides(args.override))
    sweep = Sweep.from_grid(base, axis=[shp for _, shp in GRID],
                            seeds=args.seeds, device=args.device)
    results = sweep.run(eval_at_end=True)
    print(f"{'config':<14}{'seed':>6}{'max return':>12}{'params':>10}")
    for (name, _), mr in zip(
            (row for row in GRID for _ in range(args.seeds)), results):
        print(f"{name:<14}{mr.seed:>6}{mr.result.max_return:>12.1f}"
              f"{mr.result.param_count:>10,}")
    return results


if __name__ == "__main__":
    main()
