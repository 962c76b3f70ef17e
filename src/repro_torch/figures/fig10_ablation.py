"""Fig. 10: the ablation: full against without Ape-X, without OFENet,
without the larger network, without DenseNet, and the original SAC (port
of ``benchmarks/fig10_ablation.py``). Two seeds a variant.

Paper: "large" is 2048 units. Quick: pendulum, 128.

    python -m repro_torch.figures.fig10_ablation [--scale quick]
        [--device cpu]
"""
from __future__ import annotations

from repro_torch.figures import common


def variants(scale: str):
    """``{row name: overrides}`` of the six variants at ``scale``."""
    big = 128 if scale == "quick" else 2048
    small = 32 if scale == "quick" else 256
    ablations = {
        "fig10_full": {},
        "fig10_wo_apex": {"distributed": False, "n_env": 1},
        "fig10_wo_ofenet": {"use_ofenet": False},
        "fig10_wo_larger_nn": {"num_units": small},
        "fig10_wo_densenet": {"connectivity": "mlp"},
        "fig10_sac_original": {"num_units": small, "connectivity": "mlp",
                               "use_ofenet": False, "distributed": False,
                               "n_env": 1, "activation": "relu"},
    }
    return {name: {"num_units": big, **ov} for name, ov in ablations.items()}


def run(scale: str = "quick", *, device=None):
    rows = []
    for name, ov in variants(scale).items():
        spec = common.make_spec(scale, "fig10-ablation", **ov)
        rows.append(common.bench_run(name, spec, seeds=2, device=device))
    return rows


if __name__ == "__main__":
    common.main(run)
