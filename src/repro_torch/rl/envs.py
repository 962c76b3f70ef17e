"""The benchmark environments' shapes (``repro/rl/envs.py:249`` ``ENVS``).

Serving needs each env's observation and action widths only; the
dynamics are ported with the collect slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class EnvDims:
    name: str
    obs_dim: int
    act_dim: int
    max_episode_steps: int

    def __post_init__(self):
        if min(self.obs_dim, self.act_dim, self.max_episode_steps) < 1:
            raise ValueError(f"env {self.name!r}: dims must be >= 1")


ENVS: Dict[str, EnvDims] = {e.name: e for e in (
    EnvDims("pendulum", 3, 1, 200),
    EnvDims("cartpole_swingup", 5, 1, 250),
    EnvDims("reacher2", 10, 2, 100),
    EnvDims("pointmass", 4, 2, 100),
    EnvDims("acrobot", 6, 1, 200),
)}


def make_env(name: str) -> EnvDims:
    if name not in ENVS:
        raise ValueError(f"unknown env {name!r}; have {sorted(ENVS)}")
    return ENVS[name]
