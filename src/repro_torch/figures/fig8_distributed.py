"""Figs. 8/12: Ape-X-like distributed collection against a single actor
(port of ``benchmarks/fig8_distributed.py``).

Paper: SAC x OFENet units with N_core=2 x N_env=32 actors. Quick:
pendulum, S/L nets, 16 actors against 1.

    python -m repro_torch.figures.fig8_distributed [--scale quick]
        [--device cpu]
"""
from __future__ import annotations

from repro_torch.figures import common


def run(scale: str = "quick", *, device=None):
    sizes = {"S": 32, "L": 128} if scale == "quick" else \
        {"S": 256, "M": 1024, "L": 2048}
    rows = []
    for tag, nu in sizes.items():
        for dist in (False, True):
            spec = common.make_spec(scale, "fig8-distributed", num_units=nu,
                                    distributed=dist,
                                    n_env=16 if dist else 1)
            name = f"fig8_{'apex' if dist else 'single'}_{tag}"
            rows.append(common.bench_run(name, spec, {"distributed": dist,
                                                      "size": tag},
                                         device=device))
    return rows


if __name__ == "__main__":
    common.main(run)
