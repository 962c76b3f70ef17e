"""The experiment spec tree and the ``Experiment`` handle (port of
``repro/rl/experiment.py``).

A spec crosses between the packages as ``to_dict()`` JSON — the form both
write into checkpoint metadata — so every section, field, default and
validation rule here is the reference's, including a copy of
``repro.guard.monitor.GuardSpec``.

``Experiment.from_spec(spec).run(steps)`` trains on the card (or on the
CPU with ``device="cpu"``) through ``runner.Trainer``: evaluation fires at
absolute multiples of ``eval.every``, as in the reference. ``save`` and
``restore`` with the bitwise-resume contract are not ported yet (ROADMAP
A.2) and raise.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.common import ACTIVATIONS
from repro_torch.core.blocks import BLOCK_BACKENDS, CONNECTIVITIES
from repro_torch.core.ofenet import OFENetConfig
from repro_torch.rl.envs import ENVS

ALGOS = ("sac", "td3")
REPLAY_BACKENDS = ("host", "device")
REPLAY_KERNELS = ("xla", "pallas")
LOOPS = ("python", "scan")
SINKS = ("jsonl", "csv", "memory")
GUARD_POLICIES = ("halt", "skip", "rollback")

_SPEC_VERSION = 1


class SpecError(ValueError):
    """Invalid spec field or unsupported combination, caught at construction."""


class SpecWarning(UserWarning):
    """Valid-but-degraded combination, or forward-compat key skipping."""


def _choice(spec: str, field: str, value, choices) -> None:
    if value not in choices:
        raise SpecError(f"{spec}.{field}={value!r} is not one of "
                        f"{tuple(choices)}")


def _positive(spec: str, field: str, value, minimum: int = 1) -> None:
    if not isinstance(value, int) or isinstance(value, bool) \
            or value < minimum:
        raise SpecError(f"{spec}.{field}={value!r} must be an int >= "
                        f"{minimum}")


def _boolean(spec: str, field: str, value) -> None:
    if not isinstance(value, bool):
        raise SpecError(f"{spec}.{field}={value!r} must be a bool")


def _number(spec: str, field: str, value) -> None:
    if not isinstance(value, (int, float)) or isinstance(value, bool) \
            or value < 0:
        raise SpecError(f"{spec}.{field}={value!r} must be a number >= 0")


def _sub_from_dict(cls, name: str, d: dict):
    if not isinstance(d, dict):
        raise SpecError(f"spec section {name!r} must be a dict, got "
                        f"{type(d).__name__}")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - known)
    if unknown:
        warnings.warn(f"ExperimentSpec.from_dict: ignoring unknown "
                      f"{name} keys {unknown} (forward compat)", SpecWarning,
                      stacklevel=3)
    return cls(**{k: v for k, v in d.items() if k in known})


# --------------------------------------------------------------- sub-specs

@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """Policy/value trunk: the paper's width/depth/connectivity axes."""
    num_units: int = 256
    num_layers: int = 2
    connectivity: str = "densenet"
    activation: str = "swish"
    block_backend: str = "jnp"         # jnp | fused (streaming stack kernel)

    def __post_init__(self):
        _positive("network", "num_units", self.num_units)
        _positive("network", "num_layers", self.num_layers, minimum=0)
        _choice("network", "connectivity", self.connectivity, CONNECTIVITIES)
        _choice("network", "activation", self.activation, sorted(ACTIVATIONS))
        _choice("network", "block_backend", self.block_backend,
                BLOCK_BACKENDS)


@dataclasses.dataclass(frozen=True)
class OFENetSpec:
    """Decoupled representation learning (paper §3.1)."""
    enabled: bool = True
    num_units: int = 64
    num_layers: int = 4
    connectivity: str = "densenet"
    activation: str = "swish"
    batch_norm: bool = False

    def __post_init__(self):
        _boolean("ofenet", "enabled", self.enabled)
        _boolean("ofenet", "batch_norm", self.batch_norm)
        _positive("ofenet", "num_units", self.num_units)
        _positive("ofenet", "num_layers", self.num_layers, minimum=0)
        _choice("ofenet", "connectivity", self.connectivity, CONNECTIVITIES)
        _choice("ofenet", "activation", self.activation, sorted(ACTIVATIONS))


@dataclasses.dataclass(frozen=True)
class ReplaySpec:
    """Replay storage + sampling."""
    backend: str = "host"
    kernel: str = "xla"
    capacity: int = 100_000
    prioritized: bool = True
    n_step: int = 1

    def __post_init__(self):
        _choice("replay", "backend", self.backend, REPLAY_BACKENDS)
        _choice("replay", "kernel", self.kernel, REPLAY_KERNELS)
        _boolean("replay", "prioritized", self.prioritized)
        _positive("replay", "capacity", self.capacity)
        _positive("replay", "n_step", self.n_step)


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """How the training loop runs: driver, sharding, batch, actor pool."""
    loop: str = "python"
    mesh_shards: int = 0
    batch_size: int = 256
    total_steps: int = 2000
    warmup_steps: int = 500
    distributed: bool = True
    n_core: int = 2
    n_env: int = 32
    seed: int = 0

    def __post_init__(self):
        _choice("execution", "loop", self.loop, LOOPS)
        _boolean("execution", "distributed", self.distributed)
        _positive("execution", "mesh_shards", self.mesh_shards, minimum=0)
        _positive("execution", "batch_size", self.batch_size)
        _positive("execution", "total_steps", self.total_steps, minimum=0)
        _positive("execution", "warmup_steps", self.warmup_steps, minimum=0)
        _positive("execution", "n_core", self.n_core)
        _positive("execution", "n_env", self.n_env)
        _positive("execution", "seed", self.seed, minimum=0)

    @property
    def n_actors(self) -> int:
        return self.n_core * self.n_env if self.distributed else 1


@dataclasses.dataclass(frozen=True)
class EvalSpec:
    """Evaluation cadence + effective-rank instrumentation."""
    every: int = 500
    episodes: int = 3
    srank_every: int = 0

    def __post_init__(self):
        _positive("eval", "every", self.every)
        _positive("eval", "episodes", self.episodes)
        _positive("eval", "srank_every", self.srank_every, minimum=0)


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """In-loop telemetry: stream cadence, sinks, traces."""
    enabled: bool = False
    log_every: int = 50
    sinks: Tuple[str, ...] = ("memory",)
    grad_norms: bool = True
    trace: int = 0
    log_dir: str = ""

    def __post_init__(self):
        _boolean("obs", "enabled", self.enabled)
        _boolean("obs", "grad_norms", self.grad_norms)
        _positive("obs", "log_every", self.log_every)
        _positive("obs", "trace", self.trace, minimum=0)
        sinks = self.sinks
        if isinstance(sinks, str):     # CLI: obs.sinks=jsonl or jsonl,csv
            sinks = tuple(s for s in sinks.split(",") if s)
        if not isinstance(sinks, (tuple, list)):
            raise SpecError(f"obs.sinks={self.sinks!r} must be a "
                            f"tuple/list of {SINKS}")
        object.__setattr__(self, "sinks", tuple(sinks))
        for s in self.sinks:
            _choice("obs", "sinks", s, SINKS)
        needs_dir = [s for s in self.sinks if s in ("jsonl", "csv")]
        if self.trace:
            needs_dir.append("trace")
        if needs_dir and not self.log_dir:
            raise SpecError(
                f"obs.log_dir is required by {sorted(set(needs_dir))}: "
                f"file sinks and profiler traces need a directory to "
                f"write into (obs.log_dir='runs/exp0').")


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """In-loop health guards (copy of ``repro.guard.monitor.GuardSpec``)."""
    enabled: bool = False
    policy: str = "halt"
    check_params: bool = True
    spike_factor: float = 0.0
    spike_key: str = "critic_loss"
    spike_window: int = 64
    srank_collapse: float = 0.0
    max_recoveries: int = 3

    def __post_init__(self):
        _boolean("guard", "enabled", self.enabled)
        _choice("guard", "policy", self.policy, GUARD_POLICIES)
        _boolean("guard", "check_params", self.check_params)
        if not self.spike_key or not isinstance(self.spike_key, str):
            raise SpecError(f"guard.spike_key={self.spike_key!r} must be "
                            f"a non-empty metric-stream key")
        _number("guard", "spike_factor", self.spike_factor)
        _number("guard", "srank_collapse", self.srank_collapse)
        if self.srank_collapse >= 1.0:
            raise SpecError(f"guard.srank_collapse={self.srank_collapse!r} "
                            f"must be < 1 (a fraction of the peak)")
        _positive("guard", "spike_window", self.spike_window, minimum=2)
        _positive("guard", "max_recoveries", self.max_recoveries, minimum=0)


# flat legacy field -> dotted spec path, used by override()
_ALIASES: Dict[str, str] = {
    "num_units": "network.num_units",
    "num_layers": "network.num_layers",
    "connectivity": "network.connectivity",
    "activation": "network.activation",
    "block_backend": "network.block_backend",
    "use_ofenet": "ofenet.enabled",
    "ofenet_units": "ofenet.num_units",
    "ofenet_layers": "ofenet.num_layers",
    "replay_backend": "replay.backend",
    "replay_kernel": "replay.kernel",
    "replay_capacity": "replay.capacity",
    "prioritized": "replay.prioritized",
    "n_step": "replay.n_step",
    "loop": "execution.loop",
    "mesh_shards": "execution.mesh_shards",
    "batch_size": "execution.batch_size",
    "total_steps": "execution.total_steps",
    "warmup_steps": "execution.warmup_steps",
    "distributed": "execution.distributed",
    "n_core": "execution.n_core",
    "n_env": "execution.n_env",
    "seed": "execution.seed",
    "eval_every": "eval.every",
    "eval_episodes": "eval.episodes",
    "srank_every": "eval.srank_every",
    "log_every": "obs.log_every",
    "log_dir": "obs.log_dir",
}

_SECTIONS: Tuple[Tuple[str, type], ...] = (
    ("network", NetworkSpec), ("ofenet", OFENetSpec), ("replay", ReplaySpec),
    ("execution", ExecutionSpec), ("eval", EvalSpec), ("obs", ObsSpec),
    ("guard", GuardSpec))


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The full, validated description of one run."""
    env: str = "pendulum"
    algo: str = "sac"
    network: NetworkSpec = dataclasses.field(default_factory=NetworkSpec)
    ofenet: OFENetSpec = dataclasses.field(default_factory=OFENetSpec)
    replay: ReplaySpec = dataclasses.field(default_factory=ReplaySpec)
    execution: ExecutionSpec = dataclasses.field(
        default_factory=ExecutionSpec)
    eval: EvalSpec = dataclasses.field(default_factory=EvalSpec)
    obs: ObsSpec = dataclasses.field(default_factory=ObsSpec)
    guard: GuardSpec = dataclasses.field(default_factory=GuardSpec)

    def __post_init__(self):
        _choice("spec", "env", self.env, sorted(ENVS))
        _choice("spec", "algo", self.algo, ALGOS)
        for name, cls in _SECTIONS:
            if not isinstance(getattr(self, name), cls):
                raise SpecError(f"spec.{name} must be a {cls.__name__}, got "
                                f"{type(getattr(self, name)).__name__}")
        self._validate_combos()

    def _validate_combos(self):
        r, x = self.replay, self.execution
        if r.kernel == "pallas" and r.backend != "device":
            raise SpecError(
                "replay.kernel='pallas' requires replay.backend='device': "
                "the host replay is a NumPy sum-tree with no kernel path. "
                "Set replay.backend='device' or replay.kernel='xla'.")
        if x.mesh_shards > 0:
            if r.backend != "device":
                raise SpecError(
                    "execution.mesh_shards>0 requires "
                    "replay.backend='device': the host NumPy buffer cannot "
                    "be sharded.")
            for fname, val in (("n_actors", x.n_actors),
                               ("batch_size", x.batch_size),
                               ("capacity", r.capacity)):
                if val % x.mesh_shards:
                    raise SpecError(
                        f"execution.mesh_shards={x.mesh_shards} must divide "
                        f"{fname}={val} (actors, batch and replay rows are "
                        f"split evenly across the mesh 'data' axis)")
            if x.loop == "python":
                warnings.warn(
                    "execution.mesh_shards>0 with execution.loop='python' "
                    "forfeits the superstep's dispatch amortization on the "
                    "mesh. Prefer execution.loop='scan'.", SpecWarning,
                    stacklevel=3)
        if (self.guard.enabled and self.guard.srank_collapse > 0
                and not self.eval.srank_every):
            raise SpecError(
                "guard.srank_collapse>0 requires eval.srank_every>0: the "
                "collapse guard watches the effective-rank series.")
        if (self.network.block_backend == "fused" and self.ofenet.enabled
                and self.ofenet.batch_norm):
            raise SpecError(
                "network.block_backend='fused' does not support "
                "ofenet.batch_norm=True: the stack kernel has no fused BN "
                "pass, and falling back would serve a different program "
                "than requested. Set ofenet.batch_norm=False or "
                "network.block_backend='jnp'.")

    # ---------------------------------------------------- serialization
    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"version": _SPEC_VERSION, "env": self.env,
                             "algo": self.algo}
        for name, _ in _SECTIONS:
            d[name] = dataclasses.asdict(getattr(self, name))
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        """Rebuild a spec from ``to_dict`` output (either package's).
        Unknown keys are skipped with a ``SpecWarning``."""
        d = dict(d)
        d.pop("version", None)
        kw: Dict[str, Any] = {}
        for f in ("env", "algo"):
            if f in d:
                kw[f] = d.pop(f)
        for name, sub in _SECTIONS:
            if name in d:
                kw[name] = _sub_from_dict(sub, name, d.pop(name))
        if d:
            warnings.warn(f"ExperimentSpec.from_dict: ignoring unknown "
                          f"keys {sorted(d)} (forward compat)", SpecWarning,
                          stacklevel=2)
        return cls(**kw)

    def override(self, **kwargs) -> "ExperimentSpec":
        """A new validated spec with fields replaced by dotted path
        (``{"replay.backend": "device"}``) or flat alias (``num_units=512``);
        unknown keys raise ``SpecError``."""
        d = self.to_dict()
        for key, value in kwargs.items():
            path = _ALIASES.get(key, key)
            parts = path.split(".")
            node = d
            ok = True
            for p in parts[:-1]:
                if not isinstance(node.get(p), dict):
                    ok = False
                    break
                node = node[p]
            if not ok or parts[-1] not in node or parts[-1] == "version" \
                    or isinstance(node[parts[-1]], dict):
                raise SpecError(
                    f"unknown override key {key!r}; use a dotted spec path "
                    f"(e.g. 'network.num_units'), a legacy alias "
                    f"({sorted(_ALIASES)}), or 'env'/'algo'")
            node[parts[-1]] = value
        return ExperimentSpec.from_dict(d)

    def ofenet_config(self, obs_dim: int, act_dim: int) -> OFENetConfig:
        o = self.ofenet
        return OFENetConfig(
            state_dim=obs_dim, action_dim=act_dim, num_layers=o.num_layers,
            num_units=o.num_units, connectivity=o.connectivity,
            activation=o.activation, batch_norm=o.batch_norm,
            block_backend=self.network.block_backend)


class Experiment:
    """A handle on one training run.

    ``from_spec`` builds the ``Trainer`` without running anything; the
    first ``run``/``policy`` initializes the state (agent init + the
    random-policy warm-up). ``run(steps)`` advances ``steps`` supersteps,
    evaluating at absolute multiples of ``spec.eval.every`` (and at the end
    of the call with ``eval_at_end``)."""

    def __init__(self, spec: ExperimentSpec, *, device=None):
        from repro_torch.rl.runner import Trainer
        self.spec = spec
        self.trainer = Trainer(spec, device)
        self._ls = None
        self.step = 0
        self.returns: List[float] = []
        self.eval_steps: List[int] = []
        self._rows: List[Dict[str, float]] = []
        self._last_metrics: Dict[str, float] = {}
        self._last_batch = None
        self._last_priorities = None
        self._wall = 0.0

    @classmethod
    def from_spec(cls, spec: ExperimentSpec, *, device=None) -> "Experiment":
        return cls(spec, device=device)

    @classmethod
    def restore(cls, path: str, **_kw) -> "Experiment":
        raise NotImplementedError(
            "Experiment.restore is not ported yet (ROADMAP A.2: save/restore "
            "with bitwise resume inside the port)")

    def save(self, path: str) -> None:
        raise NotImplementedError(
            "Experiment.save is not ported yet (ROADMAP A.2: save/restore "
            "with bitwise resume inside the port); rl.policy.save_params "
            "writes the agent's params")

    def _ensure_init(self):
        if self._ls is None:
            self._ls = self.trainer.init()

    def run(self, steps: Optional[int] = None, *,
            progress: Optional[Callable] = None, eval_at_end: bool = False,
            keep_last: bool = False):
        """Advance ``steps`` supersteps (default: the spec budget) and
        return the cumulative ``RunResult``. ``execution.loop`` "python"
        and "scan" run the same eager loop in the port."""
        t0 = time.time()
        every = self.spec.eval.every
        if steps is None:
            steps = self.spec.execution.total_steps
        self._ensure_init()
        trainer, ls = self.trainer, self._ls
        metrics = batch = None
        step, end = self.step, self.step + steps
        while step < end:
            step += 1
            ls, metrics, batch = trainer.step(ls)
            if step % every == 0 or (eval_at_end and step == end):
                rets = trainer.evaluate(ls).cpu().numpy()
                self._record_eval(
                    step, float(rets.mean()),
                    {k: float(v) for k, v in metrics.items()
                     if v.ndim == 0}, progress)
        if keep_last and metrics is not None:
            self._last_batch = batch
            self._last_priorities = metrics["priorities"]
        self._ls, self.step = ls, end
        self._wall += time.time() - t0
        return self.result(include_state=keep_last)

    def _record_eval(self, step, ret, scalars, progress):
        self.returns.append(ret)
        self.eval_steps.append(step)
        self._last_metrics = scalars
        self._rows.append({"step": step, "return": ret, **scalars})
        if progress:
            progress(step, ret, scalars)

    def metrics(self):
        """The eval rows recorded so far (step, return, scalar metrics)."""
        return iter([dict(r) for r in self._rows])

    def policy(self):
        """The run's current inference handle (``rl.policy.Policy``)."""
        from repro_torch.rl.policy import Policy
        return Policy.from_experiment(self)

    def result(self, *, include_state: bool = False):
        from repro_torch.rl.runner import RunResult
        return RunResult(
            returns=list(self.returns), eval_steps=list(self.eval_steps),
            sranks=[], metrics=dict(self._last_metrics),
            param_count=self.trainer.n_params, wall_time_s=self._wall,
            state=(self._ls.agent if include_state and self._ls is not None
                   else None),
            last_batch=self._last_batch,
            last_priorities=(None if self._last_priorities is None
                             else self._last_priorities.cpu().numpy()))
