"""Training runner: SAC, OFENet, the device replay and the Ape-X actor pool
glued into one superstep (port of ``repro/rl/runner.py``).

``Trainer`` builds the pieces of one run from an ``ExperimentSpec``; the
superstep is the reference's ``_device_step``:

    collect (1 env step per actor) -> n-step ring -> replay add ->
    stratified sample -> sac_update -> priority refresh

The port runs eagerly, so ``execution.loop`` "python" and "scan" run the
same superstep loop (capturing a chunk of supersteps as a CUDA graph is
later work, ROADMAP A.3). All of a run's randomness comes from one
``torch.Generator`` on the run's device, seeded from ``execution.seed``
and carried in ``TrainLoopState.gen``; ``step`` takes the superstep's
draws as an argument when given (a test feeds the reference's), else draws
them from that generator.

Not ported yet, and refused at construction with the ROADMAP item that
brings it: TD3 training, the host replay, mesh sharding, effective-rank
instrumentation, obs telemetry and the guards. On the card the sum-tree
runs its CUDA kernels, so ``replay.kernel`` must be "pallas" there (the
reference's "xla" names its plain scatter twin, which the port runs only
for tensors on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.common import tree_size
from repro_torch.replay import (DeviceReplayConfig, nstep_emit_flat,
                                nstep_init, replay_add, replay_init,
                                replay_sample, replay_update)
from repro_torch.rl import apex, sac as sac_mod
from repro_torch.rl.envs import eval_returns, make_env
from repro_torch.rl.policy import Policy, algo_config

_TRANSITION_FIELDS = ("obs", "act", "rew", "next_obs", "done")


class UnportedError(NotImplementedError):
    """A spec asks for a part of the reference the port does not have
    yet; the message names the ROADMAP item that brings it."""


def check_ported(spec) -> None:
    """Raise ``UnportedError`` for every spec choice this slice cannot run
    as asked (nothing quietly runs something else)."""
    x, r = spec.execution, spec.replay
    missing = []
    if spec.algo != "sac":
        missing.append(f"algo={spec.algo!r} training (td3_update: ROADMAP "
                       f"A.1)")
    if r.backend != "device":
        missing.append("replay.backend='host' (the host NumPy replay: "
                       "ROADMAP A.6); use replay.backend='device'")
    if x.mesh_shards > 0:
        missing.append("execution.mesh_shards>0 (sharded replay on "
                       "torch.distributed: ROADMAP A.8)")
    if spec.eval.srank_every > 0:
        missing.append("eval.srank_every>0 (core/effective_rank: ROADMAP "
                       "A.9)")
    if spec.obs.enabled:
        missing.append("obs.enabled (the obs slice: ROADMAP A.5)")
    if spec.guard.enabled:
        missing.append("guard.enabled (the guard slice: ROADMAP A.4)")
    if missing:
        raise UnportedError("the port cannot train this spec yet: "
                            + "; ".join(missing))


@dataclasses.dataclass
class RunResult:
    returns: List[float]
    eval_steps: List[int]
    sranks: List[int]
    metrics: Dict[str, float]
    param_count: int
    wall_time_s: float
    state: object = None             # only when run(keep_last=True)
    last_batch: object = None
    last_priorities: object = None   # final sampled-batch TD priorities

    @property
    def final_return(self) -> float:
        return float(np.mean(self.returns[-2:])) if self.returns \
            else float("nan")

    @property
    def max_return(self) -> float:
        return float(np.max(self.returns)) if self.returns else float("nan")


class TrainLoopState(NamedTuple):
    """Everything the loop threads between gradient steps."""
    agent: Any       # algorithm state: params / opt / step
    actors: Any      # EnvState of the actor pool
    nstep: Any       # per-actor n-step ring (None when n_step == 1)
    replay: Any      # ReplayState
    gen: torch.Generator   # the run's one generator, on its device
    step: torch.Tensor     # completed learner steps (i32), stamps adds


def median(x: torch.Tensor) -> torch.Tensor:
    """The mean of the two middle values for an even length, as
    ``jnp.median`` (``torch.median`` returns the lower one)."""
    s, n = torch.sort(x.flatten()).values, x.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


class Trainer:
    """The pieces of one training run on one device."""

    def __init__(self, spec, device: DeviceLike = None):
        check_ported(spec)
        self.spec = spec
        self.device = resolve_device(device)
        x, r = spec.execution, spec.replay
        if self.device.type == "cuda" and r.kernel != "pallas":
            raise UnportedError(
                "replay.kernel='xla' on the card: the port's sum-tree on a "
                "CUDA device is the kernel of csrc/replay_tree.cu; set "
                "replay.kernel='pallas'")
        self.n_step = r.n_step
        self.batch_size = x.batch_size
        self.warmup_steps = x.warmup_steps
        self.eval_episodes = spec.eval.episodes
        self.n_actors = x.n_actors
        self.env = env = make_env(spec.env)
        self.acfg = algo_config(spec, env)
        self.gamma = self.acfg.gamma
        self.policy0 = Policy.from_spec(spec, env=env, device=self.device)
        self._train_policy = self.policy0.act_fn
        self._rand_policy = apex.random_policy(env.act_dim)
        self.dcfg = DeviceReplayConfig(
            capacity=r.capacity, obs_dim=env.obs_dim, act_dim=env.act_dim,
            uniform=not r.prioritized, n_step=r.n_step)
        self.n_params = 0

    def policy(self, params=None) -> Policy:
        """The run's inference handle, bound to ``params`` when given."""
        return self.policy0 if params is None \
            else self.policy0.with_params(params)

    # ------------------------------------------------------------ pieces
    def _collect_emit(self, policy, params, actors, nstate, draws, *,
                      drop: int):
        """Collect, then roll through the n-step ring (identity for
        n_step == 1); returns store-schema transition rows."""
        steps = draws["noise"].shape[0]
        actors, trs = apex.collect(self.env, policy, params, actors, draws)
        if self.n_step == 1:
            return actors, nstate, {k: trs[k] for k in _TRANSITION_FIELDS}
        nstate, flat = nstep_emit_flat(self.n_step, self.gamma, nstate, trs,
                                       steps, drop)
        return actors, nstate, flat

    def draws(self, gen: torch.Generator) -> Dict[str, Any]:
        """One superstep's draws: the collect step's policy noise and
        resets, the sample's stratified uniforms, the update's two
        Gaussian draws."""
        b, a = self.batch_size, self.env.act_dim
        return {"collect": apex.collect_draws(self.env, 1, self.n_actors,
                                              "normal", gen),
                "u": torch.rand((b,), generator=gen, device=gen.device),
                "eps1": torch.randn((b, a), generator=gen,
                                    device=gen.device),
                "eps2": torch.randn((b, a), generator=gen,
                                    device=gen.device)}

    # ------------------------------------------------------ the superstep
    def step(self, ls: TrainLoopState,
             draws: Optional[Dict[str, Any]] = None):
        """One collect -> add -> sample -> update -> refresh superstep;
        returns ``(next state, metrics, batch)``. The replay state is
        updated in place."""
        if draws is None:
            draws = self.draws(ls.gen)
        actors, nstate, flat = self._collect_emit(
            self._train_policy, ls.agent["params"], ls.actors, ls.nstep,
            draws["collect"], drop=0)
        rstate = replay_add(self.dcfg, ls.replay, flat, step=ls.step)
        batch, idx, weights = replay_sample(self.dcfg, rstate, draws["u"],
                                            self.batch_size)
        staleness = (ls.step - batch.pop("add_step")).to(torch.float32)
        batch["weight"] = weights
        agent, metrics = sac_mod.sac_update(ls.agent, self.acfg, batch,
                                            draws["eps1"], draws["eps2"])
        rstate = replay_update(self.dcfg, rstate, idx, metrics["priorities"])
        metrics = dict(metrics, staleness_mean=staleness.mean(),
                       staleness_p50=median(staleness),
                       staleness_max=staleness.max())
        ls = TrainLoopState(agent, actors, nstate, rstate, ls.gen,
                            ls.step + 1)
        return ls, metrics, batch

    def evaluate(self, ls: TrainLoopState) -> torch.Tensor:
        """Deterministic-policy returns of ``eval.episodes`` episodes."""
        return eval_returns(self.env, self.policy(ls.agent["params"]),
                            self.eval_episodes, ls.gen)

    # ------------------------------------------------------ initial state
    def _fresh_state(self) -> TrainLoopState:
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(
            self.spec.execution.seed)
        agent = sac_mod.sac_init(self.acfg, gen, dev)
        self.n_params = tree_size(agent["params"])
        actors = apex.init_actor_states(
            self.env, self.env.draw_reset(self.n_actors, gen))
        nstate = None
        if self.n_step > 1:
            nstate = nstep_init(self.n_step, self.n_actors, self.env.obs_dim,
                                self.env.act_dim, dev)
        return TrainLoopState(agent, actors, nstate,
                              replay_init(self.dcfg, dev), gen,
                              torch.zeros((), dtype=torch.int32, device=dev))

    def init(self) -> TrainLoopState:
        """Agent/actor/replay init + the random-policy warm-up (paper
        A.4): ``max(warmup_steps // n_actors, 1, n_step)`` collect steps,
        added to the replay as one batch."""
        ls = self._fresh_state()
        warm = max(self.warmup_steps // self.n_actors, 1, self.n_step)
        draws = apex.collect_draws(self.env, warm, self.n_actors, "uniform",
                                   ls.gen)
        actors, nstate, flat = self._collect_emit(
            self._rand_policy, ls.agent["params"], ls.actors, ls.nstep,
            draws, drop=self.n_step - 1)
        rstate = replay_add(self.dcfg, ls.replay, flat, step=ls.step)
        return ls._replace(actors=actors, nstep=nstate, replay=rstate)
