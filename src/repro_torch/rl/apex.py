"""Ape-X-like actor pool (port of ``repro/rl/apex.py``): ``n`` batched
environments collecting transitions with the latest policy parameters.

Randomness comes in as arguments: ``collect`` takes, for every step, the
policy's noise for all actors (``(steps, n, act_dim)``) and reset draws
for all actors (``(steps, n, len(env.draws))``; every actor draws a reset
at every step, and only those at an episode end use it, as in the
reference). ``collect_draws`` makes both from one generator.
``collect_sharded`` is the reference's mesh-parallel pool on one device.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.common import Params
from repro_torch.rl.envs import EnvSpec, EnvState

NOISE_KINDS = ("normal", "uniform")


def init_actor_states(env: EnvSpec, draws: torch.Tensor) -> EnvState:
    """``n = len(draws)`` fresh episodes."""
    return env.reset(draws)


def collect_draws(env: EnvSpec, steps: int, n: int, noise: str,
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """``{"noise", "reset"}`` for ``collect``: the policy noise (standard
    normal for the SAC/TD3 policies, uniform on [0, 1) for
    ``random_policy``) and the reset draws, step by step."""
    if noise not in NOISE_KINDS:
        raise ValueError(f"noise {noise!r} is not one of {NOISE_KINDS}")
    draw = torch.randn if noise == "normal" else torch.rand
    return {"noise": draw((steps, n, env.act_dim), generator=generator,
                          device=generator.device),
            "reset": env.draw_reset(steps * n, generator).reshape(
                steps, n, len(env.draws))}


def collect(env: EnvSpec, policy_sample: Callable, params: Params,
            states: EnvState, draws: Dict[str, torch.Tensor]
            ) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
    """Run ``steps = len(draws["noise"])`` batched env steps.

    ``policy_sample(params, obs, noise) -> action``. Episodes auto-reset on
    the env's time limit. Returns ``(new_states, transitions flattened to
    (steps * n, ...))``, with ``done`` (terminal, 0 at a timeout, so the
    target bootstraps through it) and ``boundary`` (the episode ends after
    this step, so n-step windows stop here)."""
    trs = []
    st = states
    with torch.no_grad():
        for noise, reset in zip(draws["noise"], draws["reset"]):
            obs = env.obs(st)
            acts = policy_sample(params, obs, noise)
            st2, obs2, rew, done = env.step(st, acts)
            timeout = st2.t >= env.max_episode_steps
            need_reset = done | timeout
            fresh = env.reset(reset)
            st = EnvState(*(torch.where(
                need_reset.reshape((-1,) + (1,) * (a.ndim - 1)), b, a)
                for a, b in zip(st2, fresh)))
            trs.append({"obs": obs, "act": acts, "rew": rew,
                        "next_obs": obs2,
                        "done": torch.where(timeout, 0.0,
                                            done.to(torch.float32)),
                        "boundary": need_reset.to(torch.float32)})
    flat = {k: torch.cat([t[k] for t in trs]) for k in trs[0]}
    return st, flat


def collect_sharded(env: EnvSpec, policy_sample: Callable, mesh,
                    params: Params, states: EnvState,
                    draws: Dict[str, torch.Tensor]
                    ) -> Tuple[EnvState, Dict[str, torch.Tensor]]:
    """The actor pool split into ``mesh``'s shards (``launch.mesh``):
    shard i owns actors ``[i n / s, (i + 1) n / s)``. ``collect`` runs
    once over all actors on the one device; the transitions come back
    as the reference's shards return them: ``(steps * n, ...)``, shard
    by shard, each shard's rows in its ``(step, actor)`` order."""
    from repro_torch.launch.mesh import replay_shards
    from repro_torch.replay.sharded import shard_rows
    steps = draws["noise"].shape[0]
    states, trs = collect(env, policy_sample, params, states, draws)
    rows = shard_rows(trs, steps, replay_shards(mesh))
    return states, {k: v.reshape((-1,) + tuple(v.shape[2:]))
                    for k, v in rows.items()}


def random_policy(act_dim: int) -> Callable:
    """Uniform actions on [-1, 1) from uniform [0, 1) noise."""
    def sample(params, obs, noise):
        return torch.clamp(noise * 2.0 + (-1.0), min=-1.0)
    return sample
