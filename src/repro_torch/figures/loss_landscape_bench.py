"""Figs. 1b/3b/14: the loss-surface sharpness of deep against wide
Q-networks (port of ``benchmarks/loss_landscape_bench.py``).

Trains a deep-narrow (6x32) and a shallow-wide (2x256) SAC agent
(``fig4-grid``, the plain-MLP single-actor scenario, ``n_env=1``), then
takes the filter-normalized surface of J_Q on the last sampled batch
(paper A.3: frozen targets from the trained target critics, replayed
transitions, trained weights): 9 x 9 points at span 1.0, the directions
from a generator seeded with 7. The paper's claim: wide is flatter.

    python -m repro_torch.figures.loss_landscape_bench [--scale quick]
        [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.common import tree_leaves
from repro_torch.core.loss_landscape import (loss_surface,
                                             random_direction, sharpness)
from repro_torch.figures import common
from repro_torch.rl.envs import make_env
from repro_torch.rl.experiment import Experiment
from repro_torch.rl.policy import algo_config
from repro_torch.rl.sac import q_values

SHAPES = {"deep": dict(num_units=32, num_layers=6),
          "wide": dict(num_units=256, num_layers=2)}
DIRECTION_SEED = 7


def j_q(state, batch, acfg):
    """J_Q of ``state``'s critics on ``batch`` as a function of the
    critics, with the targets frozen from its target critics (eq. 2-3)."""
    params = state["params"]
    with torch.no_grad():
        q1_t, q2_t, _ = q_values(params["target_critics"], params, acfg,
                                 batch["next_obs"], batch["act"])
        q_hat = batch["rew"] + acfg.gamma * (1 - batch["done"]) * \
            torch.minimum(q1_t, q2_t)

    def loss(critics):
        q1, _, _ = q_values(critics, params, acfg, batch["obs"],
                            batch["act"])
        return 0.5 * torch.mean((q1 - q_hat) ** 2)
    return loss


def surface(state, batch, acfg, *, resolution=9, span=1.0,
            seed=DIRECTION_SEED):
    """The J_Q surface of ``state``'s critics: ``(alphas, betas, surf)``,
    the two directions drawn from a generator seeded with ``seed`` on the
    critics' device."""
    critics = state["params"]["critics"]
    gen = torch.Generator(device=tree_leaves(critics)[0].device)
    gen.manual_seed(seed)
    d1 = random_direction(critics, generator=gen)
    d2 = random_direction(critics, generator=gen)
    return loss_surface(j_q(state, batch, acfg), critics, d1, d2,
                        span=span, resolution=resolution)


def run(scale: str = "quick", *, device=None):
    device = resolve_device(device)
    rows = []
    for tag, shp in SHAPES.items():
        spec = common.make_spec(scale, "fig4-grid", n_env=1, **shp)
        acfg = algo_config(spec, make_env(spec.env))
        res = Experiment.from_spec(spec, device=device).run(
            eval_at_end=True, keep_last=True)
        _, _, surf = surface(res.state, res.last_batch, acfg)
        rows.append({"name": f"landscape_{tag}",
                     "us_per_call": 0.0,
                     "derived": f"sharpness={sharpness(surf):.4f}",
                     "loss_range": float(surf.max() - surf.min()),
                     "return": res.max_return})
    return rows


if __name__ == "__main__":
    common.main(run)
