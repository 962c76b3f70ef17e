"""Sharded device replay: one logical shard per actor slice (port of
``repro/replay/sharded.py``).

Ape-X's per-actor replay shards (Horgan et al. 2018): each actor slice
keeps its own circular store and sum-tree, so transitions never cross
shards on add; sampling is stratified across shards (each draws
``batch_size / n`` rows, proportional within its own tree) and the
importance weights are divided by the global max over all shards (the
reference's ``pmax``), so the learner sees one coherent batch.

The reference runs each shard on its own device of a ``data`` mesh axis
under ``shard_map``. The port runs all n shards on one device
(``launch.mesh.ActorMesh``): every replay tensor carries a leading shard
axis, and each operation is ``torch.func.vmap`` of the unsharded one
(``replay.device``) over that axis. On the card the sum-tree writes and
the sample take the kernels' member axis (``sumtree_set_members``,
``sumtree_sample_members``): one launch for all shards. Shapes and leaf
names are the reference's: ``store/data/<field>`` ``(n, capacity, ...)``,
``ptr``/``count``/``max_priority`` ``(n,)``, ``tree`` ``(n, 2**depth)``,
``add_step`` ``(n, capacity)``; the n-step rings ``(n, n_step, A / n,
...)`` with ``t`` ``(n,)``. ``cfg.capacity`` is the PER-SHARD capacity.

Randomness comes in as arguments, as everywhere in the port:
``sharded_replay_sample`` takes each shard's stratified uniforms (``(n,
batch_size // n)``; the reference folds the shard index into one key),
``collect_and_add_sharded`` the actor pool's draws for all actors.
Operations update the state in place and return it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.common import tree_map
from repro_torch.launch.mesh import ActorMesh, replay_shards
from repro_torch.obs.trace import stamp
from repro_torch.replay.device import (DeviceReplayConfig, ReplayState,
                                       _sample_raw, replay_add, replay_init,
                                       replay_update)
from repro_torch.replay.store import nstep_emit_flat, nstep_init


def _split(x: torch.Tensor, n: int) -> torch.Tensor:
    """``(N, ...)`` -> ``(n, N // n, ...)``: shard i owns rows
    ``[i N / n, (i + 1) N / n)``."""
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def _join(x: torch.Tensor) -> torch.Tensor:
    """``(n, m, ...)`` -> ``(n m, ...)``, in shard order."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _stacked(n: int, state):
    """``n`` copies of a fresh state on a leading shard axis."""
    return tree_map(lambda t: torch.stack([t] * n), state)


def _in_place(fn: Callable, state: ReplayState, *args) -> ReplayState:
    """``torch.func.vmap`` of ``fn(shard state, *shard args)``, which
    updates the shard's state in place, over the shard axis. The vmapped
    writes land in ``state``'s own tensors; ``state`` is returned."""
    def body(st, *a):
        fn(st, *a)
        return st["max_priority"]    # vmap wants an output; not used
    torch.func.vmap(body)(state, *args)
    return state


def shard_rows(trs: Dict[str, torch.Tensor], steps: int,
               n: int) -> Dict[str, torch.Tensor]:
    """A collector's flat ``(steps * A, ...)`` transitions (step-major,
    actor-minor) regrouped per shard: ``(n, steps * A / n, ...)``, each
    shard's rows in its own ``(step, actor)`` order, as the reference's
    shard-local ``collect`` emits them."""
    def regroup(v):
        a = v.shape[0] // steps
        v = v.reshape((steps, n, a // n) + tuple(v.shape[1:]))
        return v.transpose(0, 1).reshape((n, -1) + tuple(v.shape[3:]))
    return {k: regroup(v) for k, v in trs.items()}


def sharded_replay_init(cfg: DeviceReplayConfig, mesh: ActorMesh,
                        device=None) -> ReplayState:
    """Per-shard states (``cfg.capacity`` rows each) stacked on a leading
    shard axis, on ``device`` (default: the mesh's)."""
    dev = mesh.device if device is None else device
    return _stacked(replay_shards(mesh), replay_init(cfg, dev))


def sharded_nstep_init(mesh: ActorMesh, n: int, actors_per_shard: int,
                       obs_dim: int, act_dim: int,
                       device=None) -> Dict[str, torch.Tensor]:
    """Per-shard n-step rings (``replay.store.nstep_init``) stacked like
    ``sharded_replay_init``: each shard rolls up the n-step returns of its
    own actor slice."""
    dev = mesh.device if device is None else device
    return _stacked(replay_shards(mesh),
                    nstep_init(n, actors_per_shard, obs_dim, act_dim, dev))


def sharded_replay_add(cfg: DeviceReplayConfig, mesh: ActorMesh,
                       state: ReplayState, batch: Dict[str, torch.Tensor],
                       priorities: Optional[torch.Tensor] = None,
                       step: Optional[torch.Tensor] = None) -> ReplayState:
    """Each shard appends its contiguous slice of the ``(N, ...)`` actor
    batch (one member-axis tree write for all shards), its rows at the
    shard's ``max_priority``. ``priorities`` is ignored, as by the
    reference's sharded add."""
    n = replay_shards(mesh)
    rows = {k: _split(v, n) for k, v in batch.items()}
    return _in_place(lambda st, b: replay_add(cfg, st, b, step=step),
                     state, rows)


def sharded_replay_sample(cfg: DeviceReplayConfig, mesh: ActorMesh,
                          state: ReplayState, u: torch.Tensor,
                          batch_size: int
                          ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                     torch.Tensor]:
    """Stratified across shards: ``batch_size / n`` draws a shard from its
    row of ``u`` (``(n, batch_size // n)`` uniforms on [0, 1)), one
    member-axis sample launch for all shards; importance weights divided
    by the global max over all shards. The batch fields (``add_step``
    among them), the shard-local leaf ``idx`` and the weights come back
    ``(batch_size, ...)`` in shard order: feed ``idx`` back through
    ``sharded_replay_update`` as it is."""
    n = replay_shards(mesh)
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} is not a multiple of "
                         f"the {n} shards")
    bs = batch_size // n
    if tuple(u.shape) != (n, bs):
        raise ValueError(f"sharded_replay_sample: u {tuple(u.shape)} != "
                         f"({n}, {bs})")
    batch, idx, w = torch.func.vmap(
        lambda st, uu: _sample_raw(cfg, st, uu, bs))(state, u)
    w = w / torch.clamp(torch.max(w), min=1e-12)
    return ({k: _join(v) for k, v in batch.items()}, _join(idx), _join(w))


def sharded_replay_update(cfg: DeviceReplayConfig, mesh: ActorMesh,
                          state: ReplayState, idx: torch.Tensor,
                          priorities: torch.Tensor) -> ReplayState:
    """Refresh each shard's sampled rows from the learner's TD errors
    (``idx`` and ``priorities`` ``(batch_size,)`` in shard order; one
    member-axis tree write for all shards); each shard keeps its own
    ``max_priority``."""
    n = replay_shards(mesh)
    return _in_place(lambda st, i, p: replay_update(cfg, st, i, p),
                     state, _split(idx, n), _split(priorities, n))


def collect_and_add_sharded(env, policy_sample, mesh: ActorMesh,
                            cfg: DeviceReplayConfig, params, states,
                            draws: Dict[str, torch.Tensor],
                            replay_state: ReplayState,
                            nstep_state: Optional[Dict[str, torch.Tensor]]
                            = None, gamma: float = 0.99,
                            step: Optional[torch.Tensor] = None,
                            drop: int = 0):
    """The actor pool's ``steps = len(draws["noise"])`` env steps, then
    each shard's add of its own actors' transitions.

    Shard i owns actors ``[i A / n, (i + 1) A / n)``. The policy runs once
    over all A actors (``apex.collect``), and the rows are regrouped per
    shard in the reference's ``(step, actor)`` order. With
    ``nstep_state`` (from ``sharded_nstep_init``; ``cfg.n_step > 1``) each
    shard rolls its rows through its own n-step ring before the add and
    ``drop`` discards the first ``drop`` emitted step-rows (the warm-up's
    priming). ``step`` stamps the written rows. Returns ``(states,
    replay)``, or ``(states, nstep_state, replay)`` with the ring."""
    from repro_torch.rl import apex    # lazy: rl imports the replay

    n = replay_shards(mesh)
    steps = draws["noise"].shape[0]
    states, trs = apex.collect(env, policy_sample, params, states, draws)
    rows = shard_rows(trs, steps, n)
    add = lambda st, b: replay_add(cfg, st, b, step=step)
    if nstep_state is None:
        stamp("replay")
        return states, _in_place(add, replay_state, rows)
    nbuf, flat = torch.func.vmap(
        lambda buf, tr: nstep_emit_flat(cfg.n_step, gamma, buf, tr, steps,
                                        drop))(nstep_state, rows)
    stamp("replay")
    return states, nbuf, _in_place(add, replay_state, flat)
