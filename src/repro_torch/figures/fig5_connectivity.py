"""Fig. 5: connectivity (MLP / ResNet / DenseNet / D2RL) on small and
large networks, with the effective rank of the Q features (port of
``benchmarks/fig5_connectivity.py``).

Paper: S=128 / L=2048 units. Quick: pendulum, S=32 / L=128.

    python -m repro_torch.figures.fig5_connectivity [--scale quick]
        [--device cpu]
"""
from __future__ import annotations

from repro_torch.figures import common


def run(scale: str = "quick", *, device=None):
    sizes = {"S": 32, "L": 128} if scale == "quick" else {"S": 128, "L": 2048}
    rows = []
    for tag, nu in sizes.items():
        for conn in ("mlp", "resnet", "densenet", "d2rl"):
            spec = common.make_spec(scale, "fig5-connectivity", num_units=nu,
                                    connectivity=conn)
            rows.append(common.bench_run(
                f"fig5_{conn}_{tag}", spec,
                {"connectivity": conn, "size": tag}, device=device))
    return rows


if __name__ == "__main__":
    common.main(run)
