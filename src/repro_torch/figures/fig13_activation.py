"""Fig. 13: Swish against ReLU for the DenseNet policy and value networks
(port of ``benchmarks/fig13_activation.py``).

    python -m repro_torch.figures.fig13_activation [--scale quick]
        [--device cpu]
"""
from __future__ import annotations

from repro_torch.figures import common


def run(scale: str = "quick", *, device=None):
    rows = []
    for act in ("swish", "relu"):
        spec = common.make_spec(scale, "fig13-activation", activation=act)
        rows.append(common.bench_run(f"fig13_{act}", spec,
                                     {"activation": act}, device=device))
    return rows


if __name__ == "__main__":
    common.main(run)
