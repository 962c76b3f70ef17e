"""Fig. 3: wider MLPs DO improve SAC (a width sweep at depth 2; port of
``benchmarks/fig3_width.py``).

Paper: layers=2, units in {128, 256, 512, 1024, 2048}, 5 seeds. Quick:
pendulum, {16, 64, 256}, 1 seed.

One fleet a width through ``Sweep.from_grid``, its seeds batched inside;
``--sequential`` runs the same specs one at a time (rows ``_seq``).

    python -m repro_torch.figures.fig3_width [--scale quick] [--sequential]
        [--device cpu]
"""
from __future__ import annotations

from repro_torch.figures import common
from repro_torch.figures.fig1_depth import FLEET_OVERRIDES
from repro_torch.rl.sweep import Sweep


def grid(scale: str):
    """``(base spec, widths, seeds)`` of the sweep at ``scale``."""
    units = [16, 64, 256] if scale == "quick" else [128, 256, 512, 1024,
                                                    2048]
    seeds = 5 if scale == "paper" else 1
    return common.make_spec(scale, "fig3-width", **FLEET_OVERRIDES), units, \
        seeds


def run(scale: str = "quick", sequential: bool = False, *, device=None):
    base, units, seeds = grid(scale)
    if sequential:
        return [common.bench_run(f"fig3_width_U{nu}_seq",
                                 base.override(num_units=nu),
                                 {"units": nu, "fleet": False},
                                 seeds=seeds, device=device)
                for nu in units]
    sweep = Sweep.from_grid(base, axis={"num_units": units}, seeds=seeds,
                            device=device)
    print(sweep.describe())
    sweep.run(eval_at_end=True)
    return common.fleet_rows(sweep,
                             lambda pt: f"fig3_width_U{pt['num_units']}",
                             lambda pt: {"units": pt["num_units"]})


if __name__ == "__main__":
    common.main(run, fleet=True)
