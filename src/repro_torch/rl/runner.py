"""Training runner: SAC or TD3, OFENet, the replay and the Ape-X actor
pool glued into one superstep (port of ``repro/rl/runner.py``).

``Trainer`` builds the pieces of one run from an ``ExperimentSpec``; the
superstep is the reference's:

    collect (1 env step per actor) -> n-step ring -> replay add ->
    stratified sample -> sac_update / td3_update -> priority refresh

``replay.backend="device"`` (the reference's ``_device_step``) keeps the
replay on the run's device (``repro_torch.replay``). ``"host"`` (the
reference's ``py_step``, the spec default) keeps it in the NumPy buffer
``Trainer.buffer`` (``rl/replay.py``), sampled from the NumPy generator
``Trainer.rng``: collect and the n-step ring run on the device, the rows
cross to the host in one copy, the sampled batch and its weights come
back in one, and the priorities go out in one. The loop state's
``replay`` is then the reference's int32 token.

``execution.loop="python"`` calls ``Trainer.step`` once a superstep.
``execution.loop="scan"`` runs chunks of supersteps through
``Trainer.chunk_fn``, the port of the reference's: on the card the
superstep is captured once as a CUDA graph (``StepGraph``) and a chunk of
n supersteps is n replays of it, then an eager epilogue (srank, eval); on
the CPU a chunk is n eager supersteps. Both loops give the same state, bit
for bit. All of a run's randomness comes from one ``torch.Generator`` on
the run's device, seeded from ``execution.seed`` and carried in
``TrainLoopState.gen`` (the graph advances it as the eager steps would);
``step`` takes the superstep's draws as an argument when given (a test
feeds the reference's), else draws them from that generator.

With ``obs.enabled`` or ``guard.enabled`` (``Trainer.obs_stream``) every
superstep also records its scalar metrics: under the graph the graph
itself writes them into a row of a device buffer, and the chunk's
epilogue copies the chunk's rows to the host once (``out["stream"]``).
Recording reads what the superstep computed and writes nothing it reads,
so it is bitwise-invisible to training.

A fleet (``rl.sweep.Fleet``) runs E members of one spec, differing only
in their seeds, as ONE member-batched superstep: ``Trainer.fleet_step``
is ``torch.func.vmap`` of ``step`` over a state whose every tensor carries
a leading member axis (``stack_states``), with each member's draws made
outside the vmapped body from its own generator, in the solo order. The
same ``StepGraph`` captures it once on the card, with every member's
generator registered. A host run's ``StepGraph`` is two graphs with the
host buffer between them (a graph cannot call the host): collect and the
n-step ring, then the update.

``execution.mesh_shards=n`` (the reference's mesh branches) runs n
logical replay shards on the run's one device (``launch.mesh``): each
shard owns ``A / n`` actors, its own store, sum-tree and n-step ring of
``capacity / n`` rows, stacked on a leading shard axis
(``replay.sharded``). The collect runs once over all actors; each
shard's add, the stratified sample of ``batch / n`` rows a shard
(weights over the global max) and the refresh are ``torch.func.vmap``
over the shard axis: on the card one member-axis tree launch each for
all shards. The update runs on the shards' batch joined in shard order,
as an unsharded run's. At ``n = 1`` a run is bitwise the unsharded run.

The device replay's sum-tree runs where its tensors live: on the card its
CUDA kernels (``csrc/replay_tree.cu``), on the CPU their plain twins, for
either value of ``replay.kernel``. That field records which route the
reference took (its Pallas kernel or its XLA scatter twin); the port has
one route a device, so nothing reads it here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
from functools import partial
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.common import tree_leaves, tree_map, tree_size
from repro_torch.core.effective_rank import effective_rank
from repro_torch.launch.mesh import (ActorMesh, make_actor_mesh,
                                     replay_shards)
from repro_torch.obs.trace import PhaseStamps, annotate, stamp, stamping
from repro_torch.replay import (DeviceReplayConfig, nstep_emit_flat,
                                nstep_init, replay_add, replay_init,
                                replay_sample, replay_update)
from repro_torch.replay import sharded
from repro_torch.rl import apex, sac as sac_mod, td3 as td3_mod
from repro_torch.rl.envs import eval_returns, make_env
from repro_torch.rl.policy import Policy, algo_config
from repro_torch.rl.replay import PrioritizedReplay, UniformReplay

_TRANSITION_FIELDS = ("obs", "act", "rew", "next_obs", "done")

# per algorithm: init, update(state, cfg, batch, draws), and the names of
# the update's Gaussian draws, each (batch, act_dim), in the order drawn
_ALGOS = {
    "sac": (sac_mod.sac_init,
            lambda st, cfg, b, d: sac_mod.sac_update(st, cfg, b, d["eps1"],
                                                     d["eps2"]),
            ("eps1", "eps2")),
    "td3": (td3_mod.td3_init,
            lambda st, cfg, b, d: td3_mod.td3_update(st, cfg, b,
                                                     d["noise"]),
            ("noise",)),
}


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
    """Everything the loop threads between gradient steps. A fleet's state
    has the same fields, every tensor stacked on a leading member axis,
    and ``gen`` a list of the members' generators."""
    agent: Any       # algorithm state: params / opt / step
    actors: Any      # EnvState of the actor pool
    nstep: Any       # per-actor n-step ring (None when n_step == 1)
    replay: Any      # ReplayState
    gen: Any         # the run's one torch.Generator (a fleet: one a member)
    step: torch.Tensor     # completed learner steps (i32), stamps adds


def state_leaves(ls: TrainLoopState) -> List[torch.Tensor]:
    """Every tensor of a loop state in a fixed order (the generator is not
    a tensor): agent, actors, n-step ring, replay, step."""
    return [*tree_leaves(ls.agent), *ls.actors,
            *(tree_leaves(ls.nstep) if ls.nstep is not None else []),
            *tree_leaves(ls.replay), ls.step]


def state_from_leaves(like: TrainLoopState, leaves: List[torch.Tensor],
                      gen: Any = None) -> TrainLoopState:
    """``like``'s structure over ``leaves`` (``state_leaves`` order), with
    generator ``gen``."""
    it = iter(leaves)
    take = lambda _: next(it)
    return TrainLoopState(
        tree_map(take, like.agent), type(like.actors)(*map(take, like.actors)),
        None if like.nstep is None else tree_map(take, like.nstep),
        tree_map(take, like.replay), gen, take(like.step))


def _copy_gen(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def clone_state(ls: TrainLoopState) -> TrainLoopState:
    """A copy of ``ls`` (solo or fleet) that shares no tensor with it, with
    generators of its own in the same states."""
    gen = ([_copy_gen(g) for g in ls.gen] if isinstance(ls.gen, list)
           else _copy_gen(ls.gen))
    return state_from_leaves(ls, [t.clone() for t in state_leaves(ls)], gen)


def stack_states(states: List[TrainLoopState]) -> TrainLoopState:
    """A fleet state: each tensor of the members' states stacked on a new
    leading member axis, ``gen`` the list of their generators."""
    cols = zip(*(state_leaves(ls) for ls in states))
    return state_from_leaves(states[0], [torch.stack(c) for c in cols],
                             [ls.gen for ls in states])


def member_state(fls: TrainLoopState, m: int) -> TrainLoopState:
    """Member ``m`` of a fleet state: views of its slices and its
    generator."""
    return state_from_leaves(fls, [t[m] for t in state_leaves(fls)],
                             fls.gen[m])


def _stack_trees(trees: List[Any]) -> Any:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _vmap_state(fn: Callable, fls: TrainLoopState, *args):
    """``torch.func.vmap`` of ``fn(member state, *args) -> (state, *rest)``
    over a fleet state and member-stacked ``args``; returns the fleet state
    and the member-stacked rest. An output leaf that is its input updated
    in place (the replay) comes back as the input tensor itself."""
    ins = state_leaves(fls)

    def body(leaves, *a):
        out = fn(state_from_leaves(fls, leaves), *a)
        return (state_leaves(out[0]), *out[1:])
    leaves, *rest = torch.func.vmap(body)(ins, *args)
    leaves = [a if (b.data_ptr() == a.data_ptr() and b.shape == a.shape
                    and b.stride() == a.stride()) else b
              for a, b in zip(ins, leaves)]
    return (state_from_leaves(fls, leaves, fls.gen), *rest)


def _copy_into(dst: List[torch.Tensor], src: List[torch.Tensor]) -> int:
    """``dst[i] <- src[i]`` for every pair that is not one tensor, as one
    ``torch._foreach_copy_`` per dtype; returns the bytes copied. A source
    that shares memory with another destination is cloned first, so no
    copy reads what an earlier one wrote."""
    if len(dst) != len(src):
        raise ValueError(f"state of {len(src)} tensors copied into one of "
                         f"{len(dst)}")
    owned = {d.untyped_storage().data_ptr() for d in dst}
    groups: Dict[torch.dtype, tuple] = {}
    for d, t in zip(dst, src):
        if d is t:
            continue
        if t.untyped_storage().data_ptr() in owned:
            t = t.clone()
        ds, ts = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ts.append(t)
    for ds, ts in groups.values():
        torch._foreach_copy_(ds, ts)
    return sum(d.numel() * d.element_size() for ds, _ in groups.values()
               for d in ds)


def _batch_layout(shapes: Dict[str, tuple], batch: int):
    """``({field: (offset, row shape)}, total)`` of a batch's fields laid
    out in one flat float32 buffer, each starting at a multiple of 16
    floats (64 bytes: the kernels' vector loads stay aligned)."""
    layout, at = {}, 0
    for k, shape in shapes.items():
        layout[k] = (at, tuple(shape))
        at += -(-batch * int(np.prod(shape)) // 16) * 16
    return layout, at


@contextlib.contextmanager
def host_read():
    """A sanctioned host read of the steady-state loop: the chunk
    epilogue's explicit reads (the stream's one copy, srank, eval and
    their scalars, as the reference fetches them there) run with
    ``torch.cuda.set_sync_debug_mode`` lowered to 0, so the dynamic gate
    D001 (``repro_torch.check.dynamic``), which runs the loop in mode
    "error", flags every other sync."""
    mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() \
        else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def _capturing():
    """Python's cyclic garbage collector off for a CUDA graph capture,
    after one collection. A finished run's graph lives in a cycle (its
    trainer holds it, it holds its trainer), so only the collector frees
    it; freed in the middle of another capture (``CUDAGraph.reset``), it
    invalidates that capture."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class StepGraph:
    """``Trainer.step`` captured once as a CUDA graph (a fleet's state:
    ``Trainer.fleet_step``).

    The state it is built from becomes the graph's static state: the graph
    reads it, and copies the superstep's results back into it (one
    ``torch._foreach_copy_`` per dtype), so each ``replay`` advances it by
    one superstep in place. The run's generator (a fleet's: every
    member's) is registered with the graph, so every replay advances it as
    an eager superstep does.

    Building it runs one superstep eagerly on the capture stream (the
    warm-up: it fills the kernels' per-stream caches, which raise on a miss
    during capture) and then captures the next one without running it. The
    warm-up is a real superstep of the run: ``warm`` holds its metrics and
    batch. ``metrics`` and ``batch`` are the graph's static outputs, which
    every replay overwrites; ``copied_bytes`` is what each replay's
    copy-back writes.

    With ``rows`` > 0 (the trainer's ``obs_stream``) the graph also records
    each superstep's scalar metrics (``keys``, sorted) into the static
    float32 buffer ``scalars``, ``(rows, len(keys))`` (a fleet's: ``(rows,
    E, len(keys))``), at the row a device-side counter picks (a solo run's
    ``ls.step % rows``, read before the copy-back advances it; a fleet's
    own superstep counter ``clock``, since a frozen member's step stops):
    one ``torch.stack`` and one ``index_copy_``, after the superstep and
    reading only what it computed. The warm-up writes its row the same
    way. ``read_rows`` is the chunk epilogue's one copy to the host.

    A host-replay run (``trainer.host``) cannot put its buffer inside a
    graph, so it captures two: ``graph`` (segment A: collect and the
    n-step ring into the static ``rows``, copying ``actors`` and
    ``nstep`` back) and ``graph_b`` (segment B: the update from the
    static ``batch``, with the stream row and the copy-back of ``agent``
    and ``step``). The generator is registered with both, A drawing the
    collect noise and B the update's, in the eager order. A replay is A;
    the rows to the host in one copy, ``add`` and ``sample``; the batch to
    the device in one copy through a page-locked buffer; B; the
    priorities to the host in one copy, then the refresh. The host's two
    waits for the card are the spans ``repro_torch.replay.wait_rows`` and
    ``repro_torch.replay.wait_prio``.

    With ``trainer.stamp_phases`` the graph (a host run's two) is captured
    with phase stamps (``obs.trace.stamp``) into ``stamps``, a
    ``PhaseStamps`` ring of two of the longest chunks' rows, whose row
    each superstep's first stamp picks from ``_now()``; ``replay`` then
    records each launch's host time, and ``phases`` reads the ring. Without, no stamp is captured: the graph is
    the same, node for node. The stamps write only their ring, so training
    is bitwise the same either way."""

    def __init__(self, trainer: "Trainer", ls: TrainLoopState,
                 rows: int = 0):
        dev = trainer.device
        fleet = isinstance(ls.gen, list)
        step = trainer.fleet_step if fleet else trainer.step
        self.trainer = trainer
        self.host = trainer.host and not fleet
        self.state = ls
        self._dst = state_leaves(ls)
        self.keys: Tuple[str, ...] = ()
        self.scalars: Optional[torch.Tensor] = None
        self.clock = (torch.zeros((), dtype=torch.int64, device=dev)
                      if fleet else None)
        self.stamps: Optional[PhaseStamps] = None
        if trainer.stamp_phases:
            with host_read():
                self.stamps = PhaseStamps(self._now(),
                                          2 * trainer.chunk_steps)
        self.stream = torch.cuda.Stream(dev)
        main = torch.cuda.current_stream(dev)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            nxt, metrics, batch = step(ls)
            if rows:
                self.keys = scalar_keys(metrics, members=fleet)
                lead = (rows, len(ls.gen)) if fleet else (rows,)
                self.scalars = torch.zeros(lead + (len(self.keys),),
                                           dtype=torch.float32, device=dev)
                self._at = torch.arange(rows, device=dev)
                self._record(metrics)
            _copy_into(self._dst, state_leaves(nxt))
        self.warm = (metrics, batch)
        if self.host:
            self._capture_host(trainer, ls, rows)
            main.wait_stream(self.stream)
            return
        self.graph = torch.cuda.CUDAGraph()
        for gen in (ls.gen if fleet else [ls.gen]):
            self.graph.register_generator_state(gen)
        with _capturing(), torch.cuda.graph(self.graph, stream=self.stream), \
                stamping(self.stamps):
            stamp("collect")
            nxt, self.metrics, self.batch = step(ls)
            stamp("copyback")
            if rows:
                self._record(self.metrics)
            else:
                self._tick()
            self.copied_bytes = _copy_into(self._dst, state_leaves(nxt))
            stamp("gap")
        main.wait_stream(self.stream)

    def _capture_host(self, tr: "Trainer", ls: TrainLoopState,
                      rows: int) -> None:
        """The two segments of a host-replay superstep and the host
        buffers their copies go through."""
        nstep = lambda t: tree_leaves(t) if t is not None else []
        self.batch_flat = torch.zeros(tr.batch_floats, device=tr.device)
        self.batch = tr.batch_views(self.batch_flat)
        self._batch_host = torch.empty(tr.batch_floats, pin_memory=True)
        self.graph, self.graph_b = torch.cuda.CUDAGraph(), \
            torch.cuda.CUDAGraph()
        for g in (self.graph, self.graph_b):
            g.register_generator_state(ls.gen)
        with _capturing(), torch.cuda.graph(self.graph, stream=self.stream), \
                stamping(self.stamps):
            stamp("collect")
            actors, nst, self.rows = tr.rows(ls.agent["params"], ls.actors,
                                             ls.nstep,
                                             tr.collect_draws(ls.gen))
            copied = _copy_into([*ls.actors, *nstep(ls.nstep)],
                                [*actors, *nstep(nst)])
            stamp("gap")
        self._rows_host = torch.empty(self.rows.shape, pin_memory=True)
        with _capturing(), \
                torch.cuda.graph(self.graph_b, stream=self.stream), \
                stamping(self.stamps):
            stamp("update")
            agent, self.metrics = tr.update_fn(ls.agent, tr.acfg, self.batch,
                                               tr.learn_draws(ls.gen))
            stamp("copyback")
            if rows:
                self._record(self.metrics)
            copied += _copy_into([*tree_leaves(ls.agent), ls.step],
                                 [*tree_leaves(agent), ls.step + 1])
            stamp("gap")
        self.copied_bytes = copied
        self._prio_host = torch.empty(self.metrics["priorities"].shape,
                                      pin_memory=True)
        self._idx = None

    def _host_exchange(self) -> None:
        """Between A and B: the rows to the host, add, sample, the batch
        to the device (enqueued on the current stream, before B)."""
        tr = self.trainer
        self._rows_host.copy_(self.rows, non_blocking=True)
        with annotate("repro_torch.replay.wait_rows"):
            # check: disable=R004 -- the host replay's add needs A's rows
            torch.cuda.current_stream().synchronize()
        # check: disable=R004 -- a page-locked host buffer's view, not a read
        tr.host_add(self._rows_host.numpy())
        # check: disable=R004 -- a page-locked host buffer's view, not a read
        self._idx = tr.host_sample(self._batch_host.numpy())
        self.batch_flat.copy_(self._batch_host, non_blocking=True)

    def _host_refresh(self) -> None:
        """After B: the priorities to the host, then the refresh."""
        self._prio_host.copy_(self.metrics["priorities"], non_blocking=True)
        with annotate("repro_torch.replay.wait_prio"):
            # check: disable=R004 -- the host replay's refresh needs B's output
            torch.cuda.current_stream().synchronize()
        # check: disable=R004 -- a page-locked host buffer's view, not a read
        self.trainer.host_refresh(self._idx, self._prio_host.numpy())

    def _now(self) -> torch.Tensor:
        return self.state.step if self.clock is None else self.clock

    def _record(self, metrics) -> None:
        row = (self._now().long() % self.scalars.shape[0]).reshape(1)
        self.scalars.index_copy_(0, row, scalar_row(metrics, self.keys)[None])
        self._tick()

    def _tick(self) -> None:
        """Advance a fleet's superstep counter (``_record`` does; a fleet
        captured with stamps and no stream rows needs it for its rows)."""
        if self.clock is not None and (self.scalars is not None
                                       or self.stamps is not None):
            self.clock.add_(1)

    def read_rows(self, n: int) -> np.ndarray:
        """The rows of the last ``n`` supersteps on the static state, in
        step order (``(n, len(keys))``; a fleet's ``(n, E, len(keys))``),
        as one copy to the host."""
        idx = (self._now().long() - n + self._at[:n]) \
            % self.scalars.shape[0]
        with host_read():
            # check: disable=R004 -- the chunk epilogue's one stream copy
            return self.scalars.index_select(0, idx).cpu().numpy()

    def load(self, ls: TrainLoopState) -> None:
        """Copy the tensors and the generator states of ``ls`` into the
        static state."""
        _copy_into(self._dst, state_leaves(ls))
        pairs = (zip(ls.gen, self.state.gen) if self.clock is not None
                 else [(ls.gen, self.state.gen)])
        for src, dst in pairs:
            if src is not dst:
                dst.set_state(src.get_state())
        if self.stamps is not None:
            self.stamps.reset()

    def replay(self, n: int) -> None:
        """``n`` supersteps on the static state, on the current stream (a
        host run's: with the host buffer's work between its segments)."""
        for _ in range(n):
            if self.stamps is not None:
                self.stamps.launch()
            self.graph.replay()
            if self.host:
                self._host_exchange()
                self.graph_b.replay()
                self._host_refresh()

    def phases(self, n: int) -> Optional[dict]:
        """The phases of the last ``n`` replays from the stamps
        (``obs.trace.phase_table``, on the host's clock), after a
        synchronize; None for a graph captured without stamps."""
        if self.stamps is None:
            return None
        with host_read():
            return self.stamps.read(n)



def scalar_keys(metrics, members: bool = False) -> Tuple[str, ...]:
    """The names of a superstep's scalar metrics (a fleet superstep's:
    ``(E,)`` metrics), sorted: the stream's columns, in the reference's
    order."""
    rank = 1 if members else 0
    return tuple(sorted(k for k, v in metrics.items() if v.ndim == rank))


def scalar_row(metrics, keys) -> torch.Tensor:
    """One superstep's row of the stream: ``metrics[k]`` for ``keys``, as
    one float32 tensor on the metrics' device (a fleet's: ``(E,
    len(keys))``)."""
    return torch.stack([metrics[k].float() for k in keys], dim=-1)


def median(x: torch.Tensor) -> torch.Tensor:
    """The mean of the two middle values for an even length, as
    ``jnp.median`` (``torch.median`` returns the lower one)."""
    s, n = torch.sort(x.flatten()).values, x.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


class Trainer:
    """The pieces of one training run on one device. A spec with
    ``execution.mesh_shards > 0`` shards the device replay on an
    ``ActorMesh`` of that device; ``mesh``, when given, must agree with
    the spec, which is what a checkpoint records."""

    def __init__(self, spec, device: DeviceLike = None,
                 mesh: Optional[ActorMesh] = None):
        self.spec = spec
        self.device = resolve_device(device)
        x, r = spec.execution, spec.replay
        self.host = r.backend == "host"
        if mesh is not None and replay_shards(mesh) != x.mesh_shards:
            raise ValueError(f"the mesh's {replay_shards(mesh)} shards != "
                             f"execution.mesh_shards={x.mesh_shards}: set "
                             f"the shards in the spec")
        if mesh is None and x.mesh_shards > 0:
            mesh = make_actor_mesh(x.mesh_shards, self.device)
        self.mesh = mesh
        shards = 1
        if mesh is not None:
            if self.host:
                raise ValueError("mesh_shards requires replay.backend="
                                 "'device'")
            shards = replay_shards(mesh)
            if (x.n_actors % shards or x.batch_size % shards
                    or r.capacity % shards):
                raise ValueError(
                    f"mesh_shards={shards} must divide n_actors="
                    f"{x.n_actors}, batch_size={x.batch_size} and "
                    f"replay_capacity={r.capacity}")
            if mesh.device != self.device:
                raise ValueError(f"the mesh's shards live on "
                                 f"{mesh.device}, the run on {self.device}")
        self.n_step = r.n_step
        self.batch_size = x.batch_size
        self.warmup_steps = x.warmup_steps
        self.eval_episodes = spec.eval.episodes
        self.srank_every = spec.eval.srank_every
        self.n_actors = x.n_actors
        self.env = env = make_env(spec.env)
        self.acfg = algo_config(spec, env)
        self.init_fn, self.update_fn, self.update_draws = _ALGOS[spec.algo]
        self.gamma = self.acfg.gamma
        self.policy0 = Policy.from_spec(spec, env=env, device=self.device)
        self._train_policy = self.policy0.act_fn
        self._rand_policy = apex.random_policy(env.act_dim)
        self.dcfg = DeviceReplayConfig(   # a shard's, on a mesh
            capacity=r.capacity // shards, obs_dim=env.obs_dim,
            act_dim=env.act_dim,
            uniform=not r.prioritized, n_step=r.n_step)
        # the device replay's ops, bound once: the unsharded ones or, on
        # a mesh, their vmaps over the shard axis
        dcfg, obs_dim, act_dim = self.dcfg, env.obs_dim, env.act_dim
        if mesh is None:
            self._replay_init = partial(replay_init, dcfg)
            self._nstep_init = partial(nstep_init, r.n_step, x.n_actors,
                                       obs_dim, act_dim)
            self._collect_add = self._collect_add_flat
            self._sample = partial(replay_sample, dcfg)
            self._refresh = partial(replay_update, dcfg)
        else:
            self._replay_init = partial(sharded.sharded_replay_init, dcfg,
                                        mesh)
            self._nstep_init = partial(sharded.sharded_nstep_init, mesh,
                                       r.n_step, x.n_actors // shards,
                                       obs_dim, act_dim)
            self._collect_add = self._collect_add_sharded
            self._sample = lambda st, u, b: sharded.sharded_replay_sample(
                dcfg, mesh, st, u.view(shards, -1), b)
            self._refresh = partial(sharded.sharded_replay_update, dcfg,
                                    mesh)
        self.buffer = self.rng = None
        if self.host:
            buf_cls = PrioritizedReplay if r.prioritized else UniformReplay
            self.buffer = buf_cls(r.capacity, env.obs_dim, env.act_dim,
                                  n_step=r.n_step)
            self.rng = np.random.default_rng(x.seed)
            # the buffer's fields, in its order, and their row shapes
            self.row_shapes = {"obs": (env.obs_dim,), "act": (env.act_dim,),
                               "rew": (), "next_obs": (env.obs_dim,),
                               "done": (),
                               **({"disc": ()} if r.n_step > 1 else {})}
            self.batch_layout, self.batch_floats = _batch_layout(
                {**self.row_shapes, "weight": ()}, x.batch_size)
        self.n_params = 0
        self.graph: Optional[StepGraph] = None   # captured at first chunk
        # capture the graph with phase stamps (Experiment.trace_phases;
        # on from the start with the profiler's obs.trace)
        self.stamp_phases = bool(spec.obs.enabled and spec.obs.trace)
        # the guard reads the stream obs writes: record it for either
        self.obs_stream = spec.obs.enabled or spec.guard.enabled
        # the longest chunk Experiment.run and Fleet.run ask for: chunks
        # stop at every eval and every srank point
        self.chunk_steps = min(spec.eval.every,
                               spec.eval.srank_every or spec.eval.every)
        self.stream_rows = self.chunk_steps if self.obs_stream else 0
        self.dispatches = 0     # supersteps dispatched: replays + eager
        self.captures = 0       # StepGraph captures

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

    def _collect_add_flat(self, policy, ls: TrainLoopState, draws, *,
                          drop: int):
        """The device replay's collect, n-step ring and add; returns
        ``(actors, nstate, replay)``."""
        actors, nstate, flat = self._collect_emit(
            policy, ls.agent["params"], ls.actors, ls.nstep, draws,
            drop=drop)
        stamp("replay")
        return actors, nstate, replay_add(self.dcfg, ls.replay, flat,
                                          step=ls.step)

    def _collect_add_sharded(self, policy, ls: TrainLoopState, draws, *,
                             drop: int):
        """``_collect_add_flat`` on the mesh: each shard its own actors'
        rows."""
        out = sharded.collect_and_add_sharded(
            self.env, policy, self.mesh, self.dcfg, ls.agent["params"],
            ls.actors, draws, ls.replay, nstep_state=ls.nstep,
            gamma=self.gamma, step=ls.step, drop=drop)
        if ls.nstep is None:
            return out[0], None, out[1]
        return out

    def draws(self, gen: torch.Generator) -> Dict[str, Any]:
        """One superstep's draws: the collect step's policy noise and
        resets, the sample's stratified uniforms (the device replay only:
        the host replay samples from ``rng``), the update's Gaussian draws
        (SAC: ``eps1``, ``eps2``; TD3: the target smoothing ``noise``)."""
        d = {"collect": self.collect_draws(gen)}
        if not self.host:
            d["u"] = torch.rand((self.batch_size,), generator=gen,
                                device=gen.device)
        return {**d, **self.learn_draws(gen)}

    def collect_draws(self, gen: torch.Generator) -> Dict[str, Any]:
        """The collect step's policy noise and resets."""
        return apex.collect_draws(self.env, 1, self.n_actors, "normal", gen)

    def learn_draws(self, gen: torch.Generator) -> Dict[str, Any]:
        """The update's Gaussian draws, each ``(batch, act_dim)``."""
        b, a = self.batch_size, self.env.act_dim
        return {k: torch.randn((b, a), generator=gen, device=gen.device)
                for k in self.update_draws}

    # ------------------------------------------------------ host replay
    def rows(self, params, actors, nstate, collect, *, policy=None,
             drop: int = 0):
        """Collect and the n-step ring on the run's device; returns
        ``(actors, nstate, rows)``, ``rows`` the transition fields
        (``row_shapes``) side by side in one float32 ``(n, width)``
        tensor: what crosses to the host in one copy."""
        actors, nstate, flat = self._collect_emit(
            policy or self._train_policy, params, actors, nstate, collect,
            drop=drop)
        n = flat["obs"].shape[0]
        return actors, nstate, torch.cat(
            [flat[k].reshape(n, -1) for k in self.row_shapes], 1)

    def host_add(self, rows: np.ndarray) -> None:
        """``buffer.add_batch`` of ``rows`` (``rows``' layout, on the
        host)."""
        cols, at = {}, 0
        for k, shape in self.row_shapes.items():
            w = int(np.prod(shape))
            cols[k] = rows[:, at:at + w] if shape else rows[:, at]
            at += w
        with annotate("repro.replay.host_add"):
            self.buffer.add_batch(cols)

    def host_sample(self, out: np.ndarray) -> np.ndarray:
        """``buffer.sample`` of a batch from ``rng``, written into ``out``
        (a flat float32 host array of ``batch_floats``, each field at its
        ``batch_layout`` offset, the importance weights as ``weight``);
        returns the sampled indices."""
        with annotate("repro.replay.host_sample"):
            batch, idx, weights = self.buffer.sample(self.batch_size,
                                                     self.rng)
        batch["weight"] = weights
        for k, (at, shape) in self.batch_layout.items():
            n = self.batch_size * int(np.prod(shape))
            out[at:at + n] = batch[k].reshape(-1)
        return idx

    def host_refresh(self, idx: np.ndarray, priorities: np.ndarray) -> None:
        """``buffer.update_priorities`` of the sampled rows."""
        with annotate("repro.replay.host_update_prio"):
            self.buffer.update_priorities(idx, priorities)

    def batch_views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The batch fields and ``weight`` as views of ``flat``."""
        return {k: flat[at:at + self.batch_size * int(np.prod(shape))]
                .view(self.batch_size, *shape)
                for k, (at, shape) in self.batch_layout.items()}

    def _host_step(self, ls: TrainLoopState, draws):
        """The host replay's superstep (the reference's ``py_step``):
        the rows to the host, add, sample, the batch to the device, the
        update, the priorities to the host, refresh."""
        actors, nstate, rows = self.rows(ls.agent["params"], ls.actors,
                                         ls.nstep, draws["collect"])
        # check: disable=R004 -- the host replay's eager superstep: rows out
        self.host_add(rows.cpu().numpy())
        flat = np.empty(self.batch_floats, np.float32)
        idx = self.host_sample(flat)
        batch = self.batch_views(torch.from_numpy(flat).to(self.device))
        agent, metrics = self.update_fn(ls.agent, self.acfg, batch, draws)
        # check: disable=R004 -- the host replay's eager superstep: priorities
        self.host_refresh(idx, metrics["priorities"].cpu().numpy())
        ls = TrainLoopState(agent, actors, nstate, ls.replay, ls.gen,
                            ls.step + 1)
        return ls, metrics, batch

    # ------------------------------------------------------ the superstep
    def step(self, ls: TrainLoopState,
             draws: Optional[Dict[str, Any]] = None):
        """One collect -> add -> sample -> update -> refresh superstep;
        returns ``(next state, metrics, batch)``. The device replay's
        state is updated in place; a host run's buffer, tree and ``rng``
        advance on the host, and its metrics have no staleness keys (its
        rows carry no add step, as in the reference)."""
        if draws is None:
            draws = self.draws(ls.gen)
        if self.host:
            return self._host_step(ls, draws)
        actors, nstate, rstate = self._collect_add(
            self._train_policy, ls, draws["collect"], drop=0)
        batch, idx, weights = self._sample(rstate, draws["u"],
                                           self.batch_size)
        staleness = (ls.step - batch.pop("add_step")).to(torch.float32)
        batch["weight"] = weights
        stamp("update")
        agent, metrics = self.update_fn(ls.agent, self.acfg, batch, draws)
        stamp("replay")
        rstate = self._refresh(rstate, idx, metrics["priorities"])
        metrics = dict(metrics, staleness_mean=staleness.mean(),
                       staleness_p50=median(staleness),
                       staleness_max=staleness.max())
        ls = TrainLoopState(agent, actors, nstate, rstate, ls.gen,
                            ls.step + 1)
        return ls, metrics, batch

    def fleet_step(self, fls: TrainLoopState,
                   draws: Optional[Dict[str, Any]] = None):
        """One superstep of every member of a fleet state: ``step`` under
        ``torch.func.vmap``; returns ``(next fleet state, metrics, batch)``,
        each metric and batch field with a leading member axis. ``draws``
        are member-stacked; by default each member's are drawn from its own
        generator, outside the vmapped body, in the solo order. The replay
        state is updated in place."""
        if draws is None:
            draws = _stack_trees([self.draws(g) for g in fls.gen])
        return _vmap_state(lambda ls, d: self.step(ls, d), fls, draws)

    def evaluate(self, ls: TrainLoopState) -> torch.Tensor:
        """Deterministic-policy returns of ``eval.episodes`` episodes."""
        return eval_returns(self.env, self.policy(ls.agent["params"]),
                            self.eval_episodes, ls.gen)

    def chunk_fn(self, n_steps: int, do_eval: bool,
                 do_srank: bool = False) -> Callable:
        """``n_steps`` supersteps, then the chunk's epilogue: the port of
        the reference's ``Trainer.chunk_fn``. The returned function maps a
        state to ``(state, out)``; ``out`` holds the last superstep's
        scalar metrics (``"scal"``) and ``(batch, priorities)``
        (``"last"``), with ``do_srank`` its ``q_features``' effective rank
        (``"srank"``, an int32 tensor on the device) and with ``do_eval``
        the eval returns (``"eval"``). With ``obs_stream`` it also holds
        ``"stream"``: every scalar metric of every superstep of the chunk,
        one ``(n_steps,)`` float32 host array a metric (sorted names, the
        reference's keys), copied to the host once; a chunk longer than
        ``stream_rows`` raises.

        On the card the supersteps are replays of one ``StepGraph``,
        captured at the first chunk (whose first superstep is the graph's
        warm-up) and kept for every chunk length; a state other than the
        graph's static one is copied into it first. The state returned is
        the static state, which the next chunk overwrites in place: clone
        what must outlive it. On the CPU a chunk is ``n_steps`` eager
        supersteps."""
        if n_steps < 1:
            raise ValueError(f"a chunk runs n_steps >= 1, got {n_steps}")
        if self.obs_stream and n_steps > self.stream_rows:
            raise ValueError(
                f"a chunk of {n_steps} supersteps is longer than the "
                f"stream's {self.stream_rows} rows (min of eval.every and "
                f"eval.srank_every)")
        do_srank = do_srank and bool(self.srank_every)

        def chunk(ls: TrainLoopState):
            n = n_steps
            self.dispatches += n
            if self.device.type == "cpu":
                keys, rows = (), []
                for _ in range(n):
                    ls, metrics, batch = self.step(ls)
                    if self.obs_stream:
                        keys = scalar_keys(metrics)
                        rows.append(scalar_row(metrics, keys))
                # check: disable=R004 -- CPU tensors: no card queue to stall
                stream = torch.stack(rows).numpy() if rows else None
            else:
                if self.graph is None:
                    self.graph = StepGraph(self, ls, self.stream_rows)
                    self.captures += 1
                    metrics, batch = self.graph.warm
                    n -= 1
                elif ls is not self.graph.state:
                    self.graph.load(ls)
                if n:
                    self.graph.replay(n)
                    metrics, batch = self.graph.metrics, self.graph.batch
                ls = self.graph.state
                keys = self.graph.keys
                stream = self.graph.read_rows(n_steps) if keys else None
            out = {"scal": {k: v.clone() for k, v in metrics.items()
                            if v.ndim == 0},
                   "last": (tree_map(torch.clone, batch),
                            metrics["priorities"].clone())}
            if stream is not None:
                out["stream"] = {k: stream[:, j] for j, k in
                                 enumerate(keys)}
            if do_srank:
                with annotate("repro.srank"), host_read():
                    out["srank"] = effective_rank(metrics["q_features"])
            if do_eval:
                with annotate("repro.eval"), host_read():
                    out["eval"] = self.evaluate(ls)
            return ls, out

        return chunk

    # ------------------------------------------------------ initial state
    def _fresh_state(self, seed: Optional[int] = None) -> TrainLoopState:
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(
            self.spec.execution.seed if seed is None else int(seed))
        agent = self.init_fn(self.acfg, gen, dev)
        self.n_params = tree_size(agent["params"])
        actors = apex.init_actor_states(
            self.env, self.env.draw_reset(self.n_actors, gen))
        nstate = self._nstep_init(dev) if self.n_step > 1 else None
        # a host run's replay is the reference's int32 order token
        replay = (torch.zeros((), dtype=torch.int32, device=dev)
                  if self.host else self._replay_init(dev))
        return TrainLoopState(agent, actors, nstate, replay, gen,
                              torch.zeros((), dtype=torch.int32, device=dev))

    def init_template(self) -> TrainLoopState:
        """A state with a live one's structure, shapes and dtypes, but no
        warm-up run: the template ``Experiment.restore`` loads into."""
        return self._fresh_state()

    def _warm_draws(self, gen: torch.Generator):
        warm = max(self.warmup_steps // self.n_actors, 1, self.n_step)
        return apex.collect_draws(self.env, warm, self.n_actors, "uniform",
                                  gen)

    def _warm_up(self, ls: TrainLoopState, draws) -> TrainLoopState:
        if self.host:
            actors, nstate, rows = self.rows(
                ls.agent["params"], ls.actors, ls.nstep, draws,
                policy=self._rand_policy, drop=self.n_step - 1)
            # check: disable=R004 -- the warm-up's rows into the host replay
            self.host_add(rows.cpu().numpy())
            return ls._replace(actors=actors, nstep=nstate)
        actors, nstate, rstate = self._collect_add(
            self._rand_policy, ls, draws, drop=self.n_step - 1)
        return ls._replace(actors=actors, nstep=nstate, replay=rstate)

    def init(self) -> TrainLoopState:
        """Agent/actor/replay init + the random-policy warm-up (paper
        A.4): ``max(warmup_steps // n_actors, 1, n_step)`` collect steps,
        added to the replay (a host run's: ``buffer``) as one batch."""
        ls = self._fresh_state()
        return self._warm_up(ls, self._warm_draws(ls.gen))

    def fleet_template(self, seeds) -> TrainLoopState:
        """A fleet state of one member a seed, with no warm-up run (the
        template ``Fleet.restore`` loads into)."""
        return stack_states([self._fresh_state(s) for s in seeds])

    def init_fleet(self, seeds) -> TrainLoopState:
        """``init`` of one member a seed, as a fleet state: each member's
        init and warm-up draws come from its own generator in the solo
        order, and the warm-up runs once, vmapped over the members."""
        fls = self.fleet_template(seeds)
        draws = _stack_trees([self._warm_draws(g) for g in fls.gen])
        return _vmap_state(lambda ls, d: (self._warm_up(ls, d),), fls,
                           draws)[0]
