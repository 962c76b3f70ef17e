"""Figs. 6/7: decoupled representation learning (OFENet) against none,
across sizes (port of ``benchmarks/fig6_ofenet.py``).

Paper: S/M/L = 256/1024/2048 units. Quick: pendulum, S/L = 32/128.

    python -m repro_torch.figures.fig6_ofenet [--scale quick] [--device cpu]
"""
from __future__ import annotations

from repro_torch.figures import common


def run(scale: str = "quick", *, device=None):
    sizes = {"S": 32, "L": 128} if scale == "quick" else \
        {"S": 256, "M": 1024, "L": 2048}
    rows = []
    for tag, nu in sizes.items():
        for ofe in (False, True):
            spec = common.make_spec(scale, "fig6-ofenet", num_units=nu,
                                    use_ofenet=ofe)
            name = f"fig6_{'ofenet' if ofe else 'scratch'}_{tag}"
            rows.append(common.bench_run(name, spec,
                                         {"ofenet": ofe, "size": tag},
                                         device=device))
    return rows


if __name__ == "__main__":
    common.main(run)
