"""Fig. 4: the (units x layers) grid of max average return (port of
``benchmarks/fig4_grid.py``).

Paper: a 5x5 grid, 5 seeds. Quick: 2x2, {32, 128} x {1, 4}, pendulum.

Every cell is its own shape, so ``Sweep.from_grid`` makes one fleet a
cell with the seeds batched inside; ``--sequential`` runs the same specs
one at a time (rows ``_seq``).

    python -m repro_torch.figures.fig4_grid [--scale quick] [--sequential]
        [--device cpu]
"""
from __future__ import annotations

from repro_torch.figures import common
from repro_torch.figures.fig1_depth import FLEET_OVERRIDES
from repro_torch.rl.sweep import Sweep


def run(scale: str = "quick", sequential: bool = False, *, device=None):
    units = [32, 128] if scale == "quick" else [128, 256, 512, 1024, 2048]
    layers = [1, 4] if scale == "quick" else [1, 2, 4, 8, 16]
    seeds = 5 if scale == "paper" else 1
    base = common.make_spec(scale, "fig4-grid", **FLEET_OVERRIDES)
    if sequential:
        return [common.bench_run(f"fig4_grid_U{nu}_L{nl}_seq",
                                 base.override(num_units=nu, num_layers=nl),
                                 {"units": nu, "layers": nl, "fleet": False},
                                 seeds=seeds, device=device)
                for nu in units for nl in layers]
    sweep = Sweep.from_grid(
        base, axis={"num_units": units, "num_layers": layers}, seeds=seeds,
        device=device)
    print(sweep.describe())
    sweep.run(eval_at_end=True)
    return common.fleet_rows(
        sweep,
        lambda pt: f"fig4_grid_U{pt['num_units']}_L{pt['num_layers']}",
        lambda pt: {"units": pt["num_units"], "layers": pt["num_layers"]})


if __name__ == "__main__":
    common.main(run, fleet=True)
