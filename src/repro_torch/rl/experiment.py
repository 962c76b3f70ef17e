"""The experiment spec tree and the ``Experiment`` handle (port of
``repro/rl/experiment.py``).

A spec crosses between the packages as ``to_dict()`` JSON — the form both
write into checkpoint metadata — so every section, field, default and
validation rule here is the reference's (``GuardSpec`` lives in
``repro_torch.guard.monitor``, as the reference's does).

``Experiment.from_spec(spec).run(steps)`` trains on the card (or on the
CPU with ``device="cpu"``) through ``runner.Trainer``: evaluation and the
effective rank fire at absolute multiples of ``eval.every`` and
``eval.srank_every``, as in the reference, in both loops:
``execution.loop="python"`` steps one superstep at a time,
``execution.loop="scan"`` runs chunks that stop at those multiples
(``Trainer.chunk_fn``: replays of a CUDA graph of the superstep on the
card). Any chunking of a run gives the same state, bit for bit.

``save(path)`` and ``restore(path)`` round-trip the whole training state
through ``checkpoint.ckpt`` (one npz, the spec and the eval history in its
metadata), so ``run(N); save; restore; run(M)`` is bitwise ``run(N + M)``
under either loop. The leaves carry the reference's names, so a
checkpoint of the JAX ``Experiment.save`` restores here too (see
``Experiment.restore`` for its generator; a host-replay run's buffer and
NumPy generator come back bit for bit); a checkpoint of the port does
not restore in the reference, which needs per-actor keys (ROADMAP C11).

With ``obs.enabled`` a run streams what it does (``repro_torch.obs``):
per-step train rows, eval rows and events into the spec's sinks, and a
profiler trace of its first chunks. With ``guard.enabled`` it watches the
same stream and its params (``repro_torch.guard``) and halts, skips the
segment or rolls back to a ``DurableStore`` checkpoint on a violation.
Neither changes what is trained: runs with obs or guard on or off end in
the same state, bit for bit, as long as no violation fires.
"""
from __future__ import annotations

import ast
import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.common import ACTIVATIONS
from repro_torch.core.blocks import BLOCK_BACKENDS, CONNECTIVITIES
from repro_torch.core.effective_rank import effective_rank
from repro_torch.core.ofenet import OFENetConfig
from repro_torch.guard.monitor import (GuardSpec, GuardViolation, Monitor,
                                       fold_in)
from repro_torch.obs.stream import ObsRun
from repro_torch.obs.trace import annotate
from repro_torch.rl.envs import ENVS
from repro_torch.rl.replay import buffer_state, load_buffer_state
from repro_torch.rl.runner import host_read

ALGOS = ("sac", "td3")
REPLAY_BACKENDS = ("host", "device")
REPLAY_KERNELS = ("xla", "pallas")
LOOPS = ("python", "scan")
SINKS = ("jsonl", "csv", "memory")

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
    try:
        return cls(**{k: v for k, v in d.items() if k in known})
    except SpecError:
        raise
    except ValueError as e:
        # GuardSpec lives in repro_torch.guard, which never imports
        # repro_torch.rl: its plain ValueError becomes a SpecError here
        raise SpecError(str(e)) from e


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


def parse_overrides(pairs: List[str]) -> Dict[str, Any]:
    """CLI ``--override key=value`` pairs -> an ``override()`` kwargs dict
    (copy of the reference's).

    Values parse as Python literals when possible (``True``, ``3``,
    ``0.5``), with shell-style ``true``/``false`` accepted as bools, and
    fall back to strings (``device``, ``scan``) — bool-typed spec fields
    reject leftover strings at validation, so a typo'd flag can never run
    the wrong experiment silently."""
    out: Dict[str, Any] = {}
    for s in pairs:
        key, sep, val = s.partition("=")
        if not sep or not key:
            raise SpecError(f"override {s!r} must be key=value "
                            f"(e.g. replay.backend=device)")
        if val.lower() in ("true", "false"):
            out[key] = val.lower() == "true"
            continue
        try:
            out[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            out[key] = val
    return out


_GEN_LEAF = "loop/.gen"


def resume_seed(seed: int, step: int) -> int:
    """The generator seed of a run resumed at ``step`` from a checkpoint
    that holds no generator state (the JAX package's)."""
    return seed + (step << 32)


def _scalars(metrics) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items() if v.ndim == 0}


class Experiment:
    """A handle on one training run.

    ``from_spec`` builds the ``Trainer`` without running anything; the
    first ``run``/``policy`` initializes the state (agent init + the
    random-policy warm-up). ``run(steps)`` advances ``steps`` supersteps,
    evaluating at absolute multiples of ``spec.eval.every`` (and at the end
    of the call with ``eval_at_end``) and taking the effective rank of the
    critic's features at those of ``spec.eval.srank_every``."""

    def __init__(self, spec: ExperimentSpec, *, device=None, mesh=None):
        from repro_torch.rl.runner import Trainer
        self.spec = spec
        self.trainer = Trainer(spec, device, mesh=mesh)
        self._obs = ObsRun(spec.obs)
        self._monitor = Monitor(spec.guard) if spec.guard.enabled else None
        self._guard_store = None       # DurableStore via attach_guard()
        self._ls = None
        self.step = 0
        self.returns: List[float] = []
        self.eval_steps: List[int] = []
        self.sranks: List[int] = []
        self._rows: List[Dict[str, float]] = []
        self._last_metrics: Dict[str, float] = {}
        self._last_batch = None
        self._last_priorities = None
        self._wall = 0.0

    @classmethod
    def from_spec(cls, spec: ExperimentSpec, *, device=None,
                  mesh=None) -> "Experiment":
        """A handle on ``spec``'s run on ``device`` (default: the card);
        ``mesh`` (``launch.mesh.make_actor_mesh``), when given, must
        have ``execution.mesh_shards`` shards on that device: the spec is
        what ``save`` records and ``restore`` rebuilds."""
        return cls(spec, device=device, mesh=mesh)

    @classmethod
    def restore(cls, path: str, *, device=None,
                mesh=None) -> "Experiment":
        """A handle rebuilt from ``save`` output: the spec from the
        checkpoint's metadata, every state leaf loaded onto ``device``
        (default: the card), the run's generator included. Under
        ``loop="scan"`` on the card the first chunk captures its graph
        from the restored state.

        A checkpoint of the JAX ``Experiment.save`` restores with every
        leaf the packages share equal. It holds no torch generator state
        (its ``loop/.key`` and ``loop/.actors/.key`` are JAX keys, which
        no torch stream matches: ROADMAP C4), so the run's generator is
        seeded with ``resume_seed(execution.seed, step)``."""
        meta = ckpt.load_metadata(path)
        if meta is None or "spec" not in meta:
            raise FileNotFoundError(
                f"{path}: no spec-bearing checkpoint metadata — was this "
                f"saved by Experiment.save?")
        exp = cls(ExperimentSpec.from_dict(meta["spec"]), device=device,
                  mesh=mesh)
        exp._load_payload(path, meta)
        exp._obs.log_event("restore", step=exp.step, path=str(path))
        exp._obs.drain()
        return exp

    def _load_payload(self, path: str, meta: dict) -> None:
        """Load a ``save`` checkpoint's state into this handle, replacing
        what it holds (``restore``'s workhorse, and the rollback's). A live
        handle's graph takes the loaded state at its next chunk
        (``StepGraph.load``). A host-replay run's buffer, tree, cursor and
        NumPy generator come back from the ``host/`` leaves and the
        ``buffer`` metadata, bit for bit (a JAX checkpoint's too)."""
        st = meta["experiment"]
        tmpl = self.trainer.init_template()
        gen = tmpl.gen
        has_gen = _GEN_LEAF in ckpt.leaf_names(path)
        tree = ckpt.restore(path, {"loop": tmpl._replace(
            gen=gen.get_state() if has_gen else None)}, self.trainer.device)
        ls = tree["loop"]
        if has_gen:
            gen.set_state(ls.gen.cpu())
        else:
            gen.manual_seed(resume_seed(self.spec.execution.seed,
                                        int(st["step"])))
        self._ls = ls._replace(gen=gen)
        self.step = int(st["step"])
        self.returns = [float(r) for r in st["returns"]]
        self.eval_steps = [int(s) for s in st["eval_steps"]]
        self.sranks = [int(s) for s in st["sranks"]]
        self._rows = [dict(r) for r in st.get("rows", [])]
        self._last_metrics = dict(st.get("last_metrics", {}))
        self._wall = float(st.get("wall_time_s", 0.0))
        self.trainer.n_params = int(st["n_params"])
        # dispatch accounting continues across the resume
        self.trainer.dispatches = int(st.get("dispatches", 0))
        tr = self.trainer
        if tr.buffer is not None:
            self._drain()
            inner = getattr(tr.buffer, "_inner", tr.buffer)
            with np.load(path) as raw:
                host = {"data": {k: raw[f"host/data/{k}"]
                                 for k in inner.data},
                        "tree": raw["host/tree"], **st["buffer"]}
            tr.rng = load_buffer_state(tr.buffer, host)
        self._obs.load_state(st.get("obs"))

    def save(self, path: str) -> None:
        """Write the whole training state and the spec to ``path``.

        One npz through ``ckpt.save`` (committed by ``os.replace``): the
        ``TrainLoopState`` under the reference's leaf names
        (``loop/.agent/...``, ``loop/.actors/.q|.qd|.t``,
        ``loop/.nstep/...``, ``loop/.replay/...``, ``loop/.step``) and the
        generator's state as the uint8 leaf ``loop/.gen``; the metadata
        holds the spec, the eval history and the obs stream's cursor. A
        host-replay run adds the reference's ``host/data/<field>`` and
        ``host/tree`` leaves, and ``buffer`` (``ptr``, ``count``,
        ``max_priority``, the NumPy ``rng_state``) in the metadata. The
        card is drained first, and the obs sinks with it; under
        ``loop="scan"`` the state read is the graph's static state, and
        nothing is captured anew."""
        self._ensure_init()
        self._drain()
        self._obs.drain()
        ls, tr = self._ls, self.trainer
        state = {"step": self.step, "returns": self.returns,
                 "eval_steps": self.eval_steps, "sranks": self.sranks,
                 "rows": self._rows, "last_metrics": self._last_metrics,
                 "wall_time_s": self._wall,
                 "n_params": int(tr.n_params),
                 "dispatches": int(tr.dispatches),
                 "obs": self._obs.state()}
        tree = {"loop": ls._replace(gen=ls.gen.get_state())}
        if tr.buffer is not None:
            host = buffer_state(tr.buffer, tr.rng)
            tree["host"] = {"data": host.pop("data"),
                            "tree": host.pop("tree")}
            state["buffer"] = host
        ckpt.save(path, tree, metadata={"spec": self.spec.to_dict(),
                                        "experiment": state})
        self._obs.log_event("save", step=self.step, path=str(path))
        self._obs.drain()

    def _ensure_init(self):
        if self._ls is None:
            self._ls = self.trainer.init()

    def _drain(self) -> None:
        """Wait for the card's queued work, before reading state."""
        dev = self.trainer.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(self, steps: Optional[int] = None, *,
            progress: Optional[Callable] = None, eval_at_end: bool = False,
            keep_last: bool = False):
        """Advance ``steps`` supersteps (default: the spec budget) and
        return the cumulative ``RunResult``. Eval and srank fire at absolute
        multiples of ``eval.every`` and ``eval.srank_every`` wherever calls
        start and stop (eval also at this call's end with
        ``eval_at_end``); ``keep_last`` keeps the final sampled batch and
        its priorities.

        With ``spec.obs.enabled`` the call also streams: the scan loop
        flushes each chunk's per-step stream and a timing event, the python
        loop logs per step; the sinks are drained before returning. With
        ``spec.guard.enabled`` each chunk (the python loop: each step) is
        checked and a violation handled by ``guard.policy``."""
        t0 = time.time()
        ev, obs, mon = self.spec.eval, self._obs, self._monitor
        every, srank_every = ev.every, ev.srank_every
        if steps is None:
            steps = self.spec.execution.total_steps
        self._ensure_init()
        trainer, ls = self.trainer, self._ls
        step, end = self.step, self.step + steps
        if self.spec.execution.loop == "scan":
            # chunks stop at every eval and every srank point, as the
            # reference's scan loop does
            while step < end:
                stops = [(step // every + 1) * every, end]
                if srank_every:
                    stops.append((step // srank_every + 1) * srank_every)
                stop = min(stops)
                do_eval = stop % every == 0 or (eval_at_end and stop == end)
                do_srank = bool(srank_every) and stop % srank_every == 0
                snap = (self._guard_snapshot(ls, step)
                        if mon is not None else None)
                obs.trace.begin()
                tc = time.time()
                with annotate("repro.chunk_dispatch"):
                    ls, out = trainer.chunk_fn(stop - step, do_eval,
                                               do_srank)(ls)
                stream = out.get("stream")
                if mon is not None:
                    viol = mon.check_stream(step, stream)
                    viol += mon.check_params(stop, ls.agent["params"])
                    if viol:
                        obs.trace.end()
                        ls, step = self._guard_recover(viol, snap)
                        continue
                if stream is not None:
                    obs.flush_chunk(step, stream)
                    obs.chunk_event(step, stop, time.time() - tc)
                obs.trace.end()
                step = stop
                if do_srank:
                    with host_read():
                        srank = int(out["srank"])
                    self.sranks.append(srank)
                    obs.log_event("srank", step=step, srank=srank)
                    if mon is not None:
                        viol = mon.check_srank(step, self.sranks)
                        if viol:
                            ls, step = self._guard_recover(viol, snap)
                            continue
                if keep_last and stop == end:
                    self._last_batch, self._last_priorities = out["last"]
                if do_eval:
                    with host_read():
                        ret = float(out["eval"].cpu().numpy().mean())
                        scal = {k: float(v) for k, v in out["scal"].items()}
                    self._record_eval(step, ret, scal, progress)
        else:
            metrics = batch = None
            snap = (self._guard_snapshot(ls, step)
                    if mon is not None else None)
            while step < end:
                step += 1
                ls, metrics, batch = trainer.step(ls)
                trainer.dispatches += 1
                if mon is not None:
                    # the python loop is the debug path: it pays a host
                    # read per step for exact detection
                    viol = mon.check_scalars(step, _scalars(metrics))
                    viol += mon.check_params(step, ls.agent["params"])
                    if viol:
                        ls, step = self._guard_recover(viol, snap)
                        snap = self._guard_snapshot(ls, step)
                        continue
                if obs.enabled and step % obs.log_every == 0:
                    obs.log_train(step, _scalars(metrics))
                if srank_every and step % srank_every == 0:
                    with annotate("repro.srank"):
                        srank = int(effective_rank(metrics["q_features"]))
                    self.sranks.append(srank)
                    obs.log_event("srank", step=step, srank=srank)
                    if mon is not None:
                        viol = mon.check_srank(step, self.sranks)
                        if viol:
                            ls, step = self._guard_recover(viol, snap)
                            snap = self._guard_snapshot(ls, step)
                            continue
                if step % every == 0 or (eval_at_end and step == end):
                    with annotate("repro.eval"):
                        rets = trainer.evaluate(ls).cpu().numpy()
                    self._record_eval(step, float(rets.mean()),
                                      _scalars(metrics), progress)
                    if mon is not None:
                        # eval points are the segment boundaries the skip
                        # policy rewinds to
                        snap = self._guard_snapshot(ls, step)
            if keep_last and metrics is not None:
                self._last_batch = batch
                self._last_priorities = metrics["priorities"]
        self._ls, self.step = ls, end
        wall = time.time() - t0
        self._wall += wall
        if obs.enabled:
            obs.log_event(
                "run", step=end, steps=steps, wall_s=wall,
                steps_per_sec=steps / wall if wall > 0 else 0.0,
                host_dispatches=trainer.dispatches,
                chunk_compiles=trainer.captures)
            if obs.trace.n_chunks:
                obs.log_event("trace", step=end, status=obs.trace.status,
                              dir=obs.trace.trace_dir)
            obs.drain()
        return self.result(include_state=keep_last)

    def _record_eval(self, step, ret, scalars, progress):
        self.returns.append(ret)
        self.eval_steps.append(step)
        self._last_metrics = scalars
        self._rows.append({"step": step, "return": ret, **scalars})
        self._obs.log_eval(step, ret, scalars)
        if progress:
            progress(step, ret, scalars)

    # ------------------------------------------------------------- guarding
    def attach_guard(self, store) -> None:
        """Attach a ``repro_torch.guard.store.DurableStore``: the
        checkpoint source for guard policy='rollback' (the supervisor
        attaches the store it saves into)."""
        self._guard_store = store

    def _guard_snapshot(self, ls, step: int) -> dict:
        """Pre-segment snapshot for the skip policy: a copy of the state
        (``clone_state``: the graph mutates its static state in place, and
        the replay is updated in place on either device), the history list
        lengths and the obs cursor; with a host replay and
        ``policy="skip"``, a copy of the buffer, its tree and cursor and
        the NumPy generator's state (``replay.buffer_state``), read after
        the card is drained."""
        from repro_torch.rl.runner import clone_state
        snap = {"ls": clone_state(ls), "step": step,
                "obs": self._obs.state(),
                "hist": (len(self.returns), len(self.eval_steps),
                         len(self.sranks), len(self._rows))}
        tr = self.trainer
        if tr.buffer is not None and self._monitor.spec.policy == "skip":
            self._drain()
            snap["buffer"] = buffer_state(tr.buffer, tr.rng)
        return snap

    def _guard_recover(self, violations, snap):
        """Apply ``guard.policy`` to a non-empty violation list; returns the
        (state, step) the loop continues from. Raises ``GuardViolation``
        for halt, a spent recovery budget, or an impossible rollback."""
        mon, obs = self._monitor, self._obs
        for v in violations:
            obs.log_event("guard_violation", **v.as_dict())
        try:
            if mon.spec.policy == "halt":
                raise GuardViolation(
                    f"guard: halt on {violations[0].reason} at step "
                    f"{violations[0].step}", violations, mon.recoveries)
            ordinal = mon.spend_recovery(violations)
            if mon.spec.policy == "skip":
                ls, step = self._guard_skip(snap, ordinal)
            else:
                ls, step = self._guard_rollback(violations, ordinal)
        except GuardViolation:
            obs.drain()
            raise
        obs.log_event("guard_" + mon.spec.policy, step=step,
                      recovery=ordinal, detected=violations[0].step,
                      reason=violations[0].reason)
        obs.drain()
        return ls, step

    def _guard_skip(self, snap, ordinal):
        """Discard the offending segment: rewind to the pre-segment
        snapshot and perturb the generator with the recovery ordinal
        (``guard.monitor.fold_in``), so the re-run explores a new
        trajectory instead of replaying the same divergence. The snapshot
        is handed on as is: the next chunk copies it into the graph's
        static state. A host buffer and its NumPy generator come back as
        they were: only the torch generator is perturbed."""
        r0, e0, s0, w0 = snap["hist"]
        del self.returns[r0:], self.eval_steps[e0:]
        del self.sranks[s0:], self._rows[w0:]
        if "buffer" in snap:
            self._drain()
            self.trainer.rng = load_buffer_state(self.trainer.buffer,
                                                 snap["buffer"])
        self._obs.load_state(snap["obs"])
        ls = snap["ls"]
        fold_in(ls.gen, ordinal)
        self._ls = ls
        return ls, snap["step"]

    def _guard_rollback(self, violations, ordinal):
        """Restore the newest GOOD checkpoint from the attached
        ``DurableStore`` (falling back past corrupt ones) and perturb the
        generator with the recovery ordinal."""
        store, mon = self._guard_store, self._monitor
        if store is None:
            raise GuardViolation(
                "guard.policy='rollback' needs a DurableStore — call "
                "Experiment.attach_guard(store) (the supervisor does this "
                "automatically)", violations, mon.recoveries)
        path = store.restore_latest(
            on_bad=lambda bad: self._obs.log_event(
                "guard_bad_checkpoint", step=self.step,
                path=str(bad.path), reason=bad.reason))
        if path is None:
            raise GuardViolation(
                f"guard rollback: no good checkpoint in {store.dir}",
                violations, mon.recoveries)
        payload = store.payload(path)
        self._load_payload(payload, ckpt.load_metadata(payload))
        fold_in(self._ls.gen, ordinal)
        return self._ls, self.step

    # ------------------------------------------------------- phase stamps
    def trace_phases(self) -> None:
        """Stamp the superstep's phases on the card from the next chunk
        on: a graph captured without stamps is dropped, and the next chunk
        captures it anew with them; the stamps write only their ring, so
        training is bitwise the same. On the CPU (no graph) nothing
        changes. ``obs.trace = N`` stamps from the first chunk."""
        tr = self.trainer
        if not tr.stamp_phases:
            tr.stamp_phases, tr.graph = True, None

    def phases(self, n: int) -> Optional[dict]:
        """Where the card's time went over the last ``n`` supersteps of a
        stamped graph, read once after a synchronize
        (``obs.trace.phase_table``): ``collect``, ``replay``, ``update``,
        ``adamw``, ``copyback`` and ``step_gap``, each device ms a
        superstep, and ``target``, the part of ``update`` that averages
        the target networks; ``lead_ms``, each superstep's device begin
        less the host time ``StepGraph.replay`` launched it (how far the
        host runs ahead); ``clock_uncertainty_ms`` of the card-to-host
        clock mapping. None without a stamped graph (the CPU, or before
        ``trace_phases`` and a chunk)."""
        g = self.trainer.graph
        return None if g is None else g.phases(n)

    # ------------------------------------------------------------ results
    def metrics(self):
        """The eval rows recorded so far (step, return, scalar metrics)."""
        return iter([dict(r) for r in self._rows])

    @property
    def obs(self) -> ObsRun:
        """The observability engine: sinks (``obs.rows`` for the memory
        sink), stream counters, and the profiler trace's status."""
        return self._obs

    def close(self) -> None:
        """Stop a still-active profiler capture and close the obs sinks."""
        self._obs.close()

    def policy(self):
        """The run's current inference handle (``rl.policy.Policy``)."""
        from repro_torch.rl.policy import Policy
        return Policy.from_experiment(self)

    def result(self, *, include_state: bool = False):
        from repro_torch.rl.runner import RunResult
        return RunResult(
            returns=list(self.returns), eval_steps=list(self.eval_steps),
            sranks=list(self.sranks), metrics=dict(self._last_metrics),
            param_count=self.trainer.n_params, wall_time_s=self._wall,
            state=(self._ls.agent if include_state and self._ls is not None
                   else None),
            last_batch=self._last_batch,
            last_priorities=(None if self._last_priorities is None
                             else self._last_priorities.cpu().numpy()))
