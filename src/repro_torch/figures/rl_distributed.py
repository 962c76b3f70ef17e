"""The paper's ablation on one screen (port of
``examples/rl_distributed.py``): full, without Ape-X, without OFENet,
without DenseNet and the original SAC on the same env and budget, as a
Fig. 10-style table.

The variants build from the ``rl-distributed`` preset unchanged (the
device replay and the scan loop: the main path). Any spec field is
reachable with ``--override key=value`` (repeatable; dotted paths or the
flat aliases):

    python -m repro_torch.figures.rl_distributed [--steps 800]
        [--env pendulum] [--override replay.backend=host]
        [--override execution.loop=python] [--override replay.n_step=3]
        [--override network.block_backend=fused] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict

from repro_torch.rl import presets
from repro_torch.rl.experiment import Experiment, parse_overrides

VARIANTS = {
    "full":        dict(),
    "wo_apex":     dict(distributed=False, n_env=1),
    "wo_ofenet":   dict(use_ofenet=False),
    "wo_densenet": dict(connectivity="mlp"),
    "sac":         dict(connectivity="mlp", use_ofenet=False,
                        distributed=False, n_env=1, num_units=32,
                        activation="relu"),
}


def main(argv=None) -> Dict[str, object]:
    """Runs the variants and returns ``{variant: RunResult}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--env", default="pendulum")
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="spec override, e.g. replay.backend=host or "
                         "n_step=3 (repeatable)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when left out")
    args = ap.parse_args(argv)

    base = presets.get("rl-distributed").override(
        env=args.env, total_steps=args.steps,
        eval_every=max(args.steps // 2, 1),
        **parse_overrides(args.override))
    r, x, n = base.replay, base.execution, base.network
    print(f"replay backend: {r.backend} ({r.kernel}), loop={x.loop}, "
          f"n_step={r.n_step}, blocks={n.block_backend}")
    print(f"{'variant':<14}{'max return':>12}{'params':>12}")
    results = {}
    for name, ov in VARIANTS.items():
        res = Experiment.from_spec(base.override(**ov),
                                   device=args.device).run(eval_at_end=True)
        print(f"{name:<14}{res.max_return:>12.1f}{res.param_count:>12,}")
        results[name] = res
    return results


if __name__ == "__main__":
    main()
