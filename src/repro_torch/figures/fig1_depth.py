"""Fig. 1: deeper MLPs do NOT improve SAC (a depth sweep at fixed width;
port of ``benchmarks/fig1_depth.py``). The loss-surface sharpness of
Fig. 1b is ``loss_landscape_bench``.

Paper: units=256, layers in {1, 2, 4, 8, 16}, 1M steps, 5 seeds
(``cartpole_swingup`` here). Quick: pendulum, units=32, layers in {1, 2,
4}, 1 seed.

The sweep runs as fleets (``repro_torch.rl.Sweep``): each depth is its
own shape, so ``from_grid`` makes one fleet a depth with its seeds
batched inside (the device replay and the scan loop, which fleets need).
``--sequential`` runs the same specs one ``Experiment`` at a time for an
A/B (rows suffixed ``_seq``).

    python -m repro_torch.figures.fig1_depth [--scale quick] [--sequential]
        [--device cpu]
"""
from __future__ import annotations

from repro_torch.figures import common
from repro_torch.rl.sweep import Sweep

# what a fleet needs of a spec, in both modes, so that --sequential
# compares schedules and not replay backends
FLEET_OVERRIDES = dict(replay_backend="device", loop="scan")


def run(scale: str = "quick", sequential: bool = False, *, device=None):
    layers = [1, 2, 4] if scale == "quick" else [1, 2, 4, 8, 16]
    units = 32 if scale == "quick" else 256
    env = "pendulum" if scale == "quick" else "cartpole_swingup"
    seeds = 5 if scale == "paper" else 1
    base = common.make_spec(scale, "fig1-depth", env=env, num_units=units,
                            **FLEET_OVERRIDES)
    if sequential:
        return [common.bench_run(f"fig1_depth_L{nl}_seq",
                                 base.override(num_layers=nl),
                                 {"layers": nl, "fleet": False},
                                 seeds=seeds, device=device)
                for nl in layers]
    sweep = Sweep.from_grid(base, axis={"num_layers": layers}, seeds=seeds,
                            device=device)
    print(sweep.describe())
    sweep.run(eval_at_end=True)
    return common.fleet_rows(sweep,
                             lambda pt: f"fig1_depth_L{pt['num_layers']}",
                             lambda pt: {"layers": pt["num_layers"]})


if __name__ == "__main__":
    common.main(run, fleet=True)
