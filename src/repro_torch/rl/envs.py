"""Continuous-control environments as batched tensors (port of
``repro/rl/envs.py``).

The reference's analytic rigid-body tasks (MuJoCo stand-ins), written over
a batch of environments at once: ``EnvState`` holds ``(n, ...)`` tensors and
every function maps a whole batch. Randomness comes in as arguments:
``env.reset(draws)`` takes ``(n, len(env.draws))`` standard draws, where
``env.draws`` names each column's distribution ("u": uniform on [0, 1),
"n": standard normal), and ``env.draw_reset(n, generator)`` makes them. A
test hands ``reset`` the reference's own draws; the uniform columns are
scaled to their ranges exactly as ``jax.random.uniform`` does, in float32.

Env API:
    env.reset(draws)              -> EnvState
    env.step(state, action)       -> (EnvState, obs, reward, done)
    env.obs(state)                -> observation (n, obs_dim)
    env.obs_dim / act_dim / max_episode_steps
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch


class EnvState(NamedTuple):
    q: torch.Tensor         # generalized positions (n, nq)
    qd: torch.Tensor        # generalized velocities (n, nqd)
    t: torch.Tensor         # step counter (n,) int32


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    name: str
    obs_dim: int
    act_dim: int
    max_episode_steps: int
    draws: str              # one letter per reset draw: "u" uniform, "n" normal
    reset: Callable[[torch.Tensor], EnvState]
    step: Callable
    obs: Callable[[EnvState], torch.Tensor]

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError(f"env name={self.name!r} must be a non-empty "
                             f"string")
        for field in ("obs_dim", "act_dim", "max_episode_steps"):
            v = getattr(self, field)
            if not isinstance(v, int) or v <= 0:
                raise ValueError(f"env {self.name}: {field}={v!r} must be "
                                 f"a positive int")
        if not self.draws or set(self.draws) - {"u", "n"}:
            raise ValueError(f"env {self.name}: draws={self.draws!r} must "
                             f"be a string of 'u'/'n'")
        for field in ("reset", "step", "obs"):
            if not callable(getattr(self, field)):
                raise ValueError(f"env {self.name}: {field} must be "
                                 f"callable")

    def draw_reset(self, n: int, generator: torch.Generator
                   ) -> torch.Tensor:
        """``(n, len(draws))`` standard draws for ``reset``, on the
        generator's device."""
        dev = generator.device
        cols = [torch.rand((n,), generator=generator, device=dev)
                if k == "u" else
                torch.randn((n,), generator=generator, device=dev)
                for k in self.draws]
        return torch.stack(cols, dim=-1)


def uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """A [0, 1) draw scaled to [lo, hi) as ``jax.random.uniform`` does:
    ``max(lo, u * (hi - lo) + lo)`` with float32 bounds."""
    lo32 = np.float32(lo)
    span = np.float32(np.float32(hi) - lo32)
    return torch.clamp(u * float(span) + float(lo32), min=float(lo32))


def _state(q: torch.Tensor, qd: torch.Tensor) -> EnvState:
    return EnvState(q=q, qd=qd, t=torch.zeros(q.shape[:1], dtype=torch.int32,
                                              device=q.device))


def _done(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape[:1], dtype=torch.bool, device=x.device)


# ---------------------------------------------------------------------------
# Pendulum swing-up (obs: cos, sin, thdot)
# ---------------------------------------------------------------------------

def make_pendulum() -> EnvSpec:
    g, m, l, dt = 10.0, 1.0, 1.0, 0.05
    max_speed, max_torque = 8.0, 2.0

    def obs(s: EnvState):
        th = s.q[:, 0]
        return torch.stack([torch.cos(th), torch.sin(th),
                            s.qd[:, 0] / max_speed], dim=-1)

    def reset(draws):
        th = uniform(draws[:, 0], -math.pi, math.pi)
        thd = uniform(draws[:, 1], -1.0, 1.0)
        return _state(th[:, None], thd[:, None])

    def step(s: EnvState, a: torch.Tensor):
        u = torch.clamp(a[:, 0], -1, 1) * max_torque
        th, thd = s.q[:, 0], s.qd[:, 0]
        norm_th = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        cost = norm_th ** 2 + 0.1 * thd ** 2 + 0.001 * u ** 2
        thd = torch.clamp(thd + (3 * g / (2 * l) * torch.sin(th)
                                 + 3.0 / (m * l ** 2) * u) * dt,
                          -max_speed, max_speed)
        th = th + thd * dt
        ns = EnvState(q=th[:, None], qd=thd[:, None], t=s.t + 1)
        return ns, obs(ns), -cost, _done(th)

    return EnvSpec("pendulum", 3, 1, 200, "uu", reset, step, obs)


# ---------------------------------------------------------------------------
# Cartpole swing-up (obs: x, xd, cos, sin, thd)
# ---------------------------------------------------------------------------

def make_cartpole_swingup() -> EnvSpec:
    mc, mp, l, g, dt = 1.0, 0.1, 0.5, 9.8, 0.02
    force_mag = 10.0

    def obs(s: EnvState):
        x, th = s.q[:, 0], s.q[:, 1]
        xd, thd = s.qd[:, 0], s.qd[:, 1]
        return torch.stack([x / 2.4, xd, torch.cos(th), torch.sin(th), thd],
                           dim=-1)

    def reset(draws):
        base = torch.tensor([0.0, math.pi], dtype=torch.float32,
                            device=draws.device)
        q0 = base + 0.05 * draws
        return _state(q0, torch.zeros_like(q0))

    def step(s: EnvState, a: torch.Tensor):
        f = torch.clamp(a[:, 0], -1, 1) * force_mag
        x, th = s.q[:, 0], s.q[:, 1]
        xd, thd = s.qd[:, 0], s.qd[:, 1]
        sin, cos = torch.sin(th), torch.cos(th)
        tmp = (f + mp * l * thd ** 2 * sin) / (mc + mp)
        thacc = (g * sin - cos * tmp) / (
            l * (4.0 / 3 - mp * cos ** 2 / (mc + mp)))
        xacc = tmp - mp * l * thacc * cos / (mc + mp)
        xd = xd + xacc * dt
        x = torch.clamp(x + xd * dt, -2.4, 2.4)
        thd = thd + thacc * dt
        th = th + thd * dt
        ns = EnvState(q=torch.stack([x, th], -1),
                      qd=torch.stack([xd, thd], -1), t=s.t + 1)
        upright = torch.cos(th)
        reward = upright - 0.01 * xd ** 2 - 0.001 * f ** 2 \
            - 0.1 * torch.abs(x)
        return ns, obs(ns), reward, _done(x)

    return EnvSpec("cartpole_swingup", 5, 1, 250, "nn", reset, step, obs)


# ---------------------------------------------------------------------------
# Reacher-2: 2-link arm reaching a random target
# obs: cos/sin of 2 joints, 2 joint vels, target xy, fingertip-target delta
# ---------------------------------------------------------------------------

def make_reacher2() -> EnvSpec:
    l1, l2, dt = 0.1, 0.11, 0.02

    def fingertip(q):
        x = l1 * torch.cos(q[:, 0]) + l2 * torch.cos(q[:, 0] + q[:, 1])
        y = l1 * torch.sin(q[:, 0]) + l2 * torch.sin(q[:, 0] + q[:, 1])
        return torch.stack([x, y], -1)

    def obs(s: EnvState):
        tgt = s.q[:, 2:4]
        ft = fingertip(s.q[:, :2])
        return torch.cat([torch.cos(s.q[:, :2]), torch.sin(s.q[:, :2]),
                          s.qd[:, :2], tgt, ft - tgt], dim=-1)

    def reset(draws):
        joints = uniform(draws[:, 0:2], -math.pi, math.pi)
        r = uniform(draws[:, 2], 0.05, 0.2)
        ang = uniform(draws[:, 3], -math.pi, math.pi)
        tgt = torch.stack([r * torch.cos(ang), r * torch.sin(ang)], -1)
        q = torch.cat([joints, tgt], -1)
        return _state(q, torch.zeros_like(q))

    def step(s: EnvState, a: torch.Tensor):
        u = torch.clamp(a, -1, 1) * 0.5
        qd = s.qd[:, :2] * 0.95 + u * dt * 40.0
        q = s.q[:, :2] + qd * dt
        ns = EnvState(q=torch.cat([q, s.q[:, 2:4]], -1),
                      qd=torch.cat([qd, torch.zeros_like(qd)], -1),
                      t=s.t + 1)
        dist = torch.linalg.vector_norm(fingertip(q) - s.q[:, 2:4], dim=-1)
        reward = -dist - 0.01 * torch.sum(torch.square(u), -1)
        return ns, obs(ns), reward, _done(q)

    return EnvSpec("reacher2", 10, 2, 100, "uuuu", reset, step, obs)


# ---------------------------------------------------------------------------
# PointMass-2D with drag: reach the origin from random start
# ---------------------------------------------------------------------------

def make_pointmass() -> EnvSpec:
    dt = 0.05

    def obs(s: EnvState):
        return torch.cat([s.q, s.qd], -1)

    def reset(draws):
        q = uniform(draws, -1.0, 1.0)
        return _state(q, torch.zeros_like(q))

    def step(s: EnvState, a: torch.Tensor):
        u = torch.clamp(a, -1, 1)
        qd = s.qd * 0.9 + u * dt * 4.0
        q = s.q + qd * dt
        ns = EnvState(q=q, qd=qd, t=s.t + 1)
        reward = -torch.linalg.vector_norm(q, dim=-1) \
            - 0.05 * torch.sum(torch.square(u), -1)
        return ns, obs(ns), reward, _done(q)

    return EnvSpec("pointmass", 4, 2, 100, "uu", reset, step, obs)


# ---------------------------------------------------------------------------
# Acrobot (continuous torque on second joint), swing-up reward
# ---------------------------------------------------------------------------

def make_acrobot() -> EnvSpec:
    m1 = m2 = 1.0
    l1 = 1.0
    lc1 = lc2 = 0.5
    i1 = i2 = 1.0
    g, dt = 9.8, 0.05

    def obs(s: EnvState):
        return torch.stack([torch.cos(s.q[:, 0]), torch.sin(s.q[:, 0]),
                            torch.cos(s.q[:, 1]), torch.sin(s.q[:, 1]),
                            s.qd[:, 0] / 5.0, s.qd[:, 1] / 10.0], -1)

    def reset(draws):
        q = 0.1 * draws
        return _state(q, torch.zeros_like(q))

    def step(s: EnvState, a: torch.Tensor):
        tau = torch.clamp(a[:, 0], -1, 1) * 2.0
        th1, th2 = s.q[:, 0], s.q[:, 1]
        d1, d2 = s.qd[:, 0], s.qd[:, 1]
        d2_ = m2 * (lc2 ** 2 + l1 * lc2 * torch.cos(th2)) + i2
        dmat = m1 * lc1 ** 2 + m2 * (l1 ** 2 + lc2 ** 2
                                     + 2 * l1 * lc2 * torch.cos(th2)) \
            + i1 + i2
        phi2 = m2 * lc2 * g * torch.cos(th1 + th2 - math.pi / 2)
        phi1 = (-m2 * l1 * lc2 * d2 ** 2 * torch.sin(th2)
                - 2 * m2 * l1 * lc2 * d2 * d1 * torch.sin(th2)
                + (m1 * lc1 + m2 * l1) * g * torch.cos(th1 - math.pi / 2)
                + phi2)
        dd2 = (tau + d2_ / dmat * phi1 - m2 * l1 * lc2 * d1 ** 2
               * torch.sin(th2) - phi2) / (m2 * lc2 ** 2 + i2
                                           - d2_ ** 2 / dmat)
        dd1 = -(d2_ * dd2 + phi1) / dmat
        d1 = torch.clamp(d1 + dd1 * dt, -5, 5)
        d2 = torch.clamp(d2 + dd2 * dt, -10, 10)
        th1 = th1 + d1 * dt
        th2 = th2 + d2 * dt
        ns = EnvState(q=torch.stack([th1, th2], -1),
                      qd=torch.stack([d1, d2], -1), t=s.t + 1)
        height = -torch.cos(th1) - torch.cos(th1 + th2)
        return ns, obs(ns), height - 0.01 * tau ** 2, _done(th1)

    return EnvSpec("acrobot", 6, 1, 200, "nn", reset, step, obs)


ENVS: Dict[str, Callable[[], EnvSpec]] = {
    "pendulum": make_pendulum,
    "cartpole_swingup": make_cartpole_swingup,
    "reacher2": make_reacher2,
    "pointmass": make_pointmass,
    "acrobot": make_acrobot,
}


def make_env(name: str) -> EnvSpec:
    if name not in ENVS:
        raise ValueError(f"unknown env {name!r}; have {sorted(ENVS)}")
    return ENVS[name]()


def rollout_return(env: EnvSpec, policy, draws: torch.Tensor,
                   steps: int = 0) -> torch.Tensor:
    """Deterministic-policy episode returns of a batch of episodes, one per
    row of ``draws`` (their reset draws). ``policy`` is a ``Policy`` (its
    ``act_deterministic`` is used) or a bare ``obs batch -> action batch``
    callable."""
    steps = steps or env.max_episode_steps
    s = env.reset(draws)
    act = getattr(policy, "act_deterministic", policy)
    total = torch.zeros(draws.shape[:1], dtype=torch.float32,
                        device=draws.device)
    for _ in range(steps):
        s, _, r, _ = env.step(s, act(env.obs(s)))
        total = total + r
    return total


def eval_returns(env: EnvSpec, policy, episodes: int,
                 generator: Optional[torch.Generator] = None, *,
                 draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-episode deterministic-policy returns, all ``episodes`` rollouts
    stepped as one batch. Reset draws come from ``generator`` unless given
    (``(episodes, len(env.draws))``)."""
    if draws is None:
        draws = env.draw_reset(episodes, generator)
    return rollout_return(env, policy, draws)
