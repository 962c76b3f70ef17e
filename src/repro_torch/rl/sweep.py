"""Experiment fleets: a whole paper figure as member-batched supersteps
(port of ``repro/rl/sweep.py``).

The paper's results are sweeps — depth grids (Fig. 1), width grids (Figs.
3 and 4), seed batteries. A ``Fleet`` holds E runs of ONE spec that differ
only in ``execution.seed``: their ``TrainLoopState``s stacked on a leading
MEMBER axis (``runner.stack_states``), advanced together by one
member-batched superstep, ``torch.func.vmap`` of the solo superstep
(``Trainer.fleet_step``). On the card that superstep is captured once as a
CUDA graph (``runner.StepGraph``, every member's generator registered with
it) and a chunk of n supersteps is n replays, then an eager epilogue; on
the CPU a chunk is n eager vmapped supersteps.

    from repro_torch.rl import Sweep

    sweep = Sweep.from_grid("fig3-width",
                            axis={"num_units": [64, 256]}, seeds=5)
    sweep.run()                      # 2 fleets, 10 members
    for m in sweep.results():
        print(m.label, m.result.max_return)

Semantics (the reference's)
---------------------------
* **One program per fleet.** Members may differ only in ``execution.seed``
  (``_fleet_signature``); a heterogeneous ``Fleet`` raises ``SpecError``
  naming the differing paths, and ``Sweep.from_grid`` partitions a grid
  into per-point fleets (``Sweep.partition``).
* **Device replay only**: ``replay.backend='host'`` raises (``from_grid``
  upgrades a host base with a ``SpecWarning``), as do
  ``execution.mesh_shards`` and ``guard.policy='skip'``. On the card the
  sum-tree runs its member-axis kernels for either ``replay.kernel``; the
  port also accepts "pallas", which the reference's fleets reject
  (ROADMAP C12). ``network.block_backend='fused'`` runs the stack
  kernels with a member axis: each forward and backward kernel launches
  once for all E members (``kernels.dense_block.stack.dense_stack_members``
  under the vmap), a member bitwise its solo launches; on the CPU the
  members twin loops the solo plain version.
* **Member k is the solo run with seed k.** Each member owns a
  ``torch.Generator`` seeded as the solo ``Trainer`` seeds it and draws
  its init, resets, warm-up and every superstep's draws from it in the
  solo order, outside the vmapped body. The vmapped body batches the
  members' matmuls, which may round differently, so member and solo agree
  within ``SOLO_PARITY_RTOL`` / ``SOLO_PARITY_ATOL``, not bit for bit.
* **Scheduling as ``Experiment.run``**: eval and srank fire at absolute
  multiples of ``eval.every`` and ``eval.srank_every``.
* **Early-stop mask.** ``set_done`` (or ``run(stop_at_return=...)``)
  freezes members: every member computes through the chunk (the program
  stays uniform), and at its end a done member's slices of the state and
  its generator state are restored from copies taken at its start, so its
  neighbours are bitwise unaffected and unfreezing resumes it bit for bit.
* **Checkpoints through ``checkpoint.ckpt``**: the stacked state under the
  reference's leaf names (``fleet/.agent/...``), the members' generator
  states as the uint8 leaf ``fleet/.gen``, histories and labels in the
  metadata. ``run(N); save; restore; run(M)`` is bitwise ``run(N + M)``.
  A JAX ``Fleet.save`` restores with every shared leaf equal, its members'
  generators seeded by ``experiment.resume_seed``.
* **Per-member obs**: each member has its own ``ObsRun(spec,
  member=label)`` writing under ``<log_dir>/<_slug(label)>/``;
  ``repro_torch.obs.report`` merges a sweep directory.
* **Fleet guard**: one ``Monitor`` a member plus a fleet monitor holding
  the recovery budget; ``rollback`` restores only the violating members
  from the newest good fleet checkpoint of the attached ``DurableStore``,
  perturbing their generators with ``guard.fold_in``.

PBT: ``exploit_explore()`` runs truncation selection on the member axis
between chunks — the bottom members copy the agent state (params, opt,
step) of the top ones and may perturb the copied params with noise from
their own generators; actors, replay and step stay each member's own.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import re
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.common import tree_leaves
from repro_torch.core.effective_rank import effective_rank_members
from repro_torch.guard.monitor import GuardViolation, Monitor, fold_in
from repro_torch.guard.store import DurableStore
from repro_torch.obs.stream import ObsRun
from repro_torch.obs.trace import annotate
from repro_torch.rl.experiment import (ExperimentSpec, SpecError,
                                       SpecWarning, resume_seed)
from repro_torch.rl.runner import (RunResult, StepGraph, Trainer,
                                   TrainLoopState, member_state,
                                   scalar_keys, scalar_row, state_leaves)

# The reference's member-vs-solo tolerance (its sweep.py): a member's
# computation is batched with its neighbours', so float reassociation in
# batched matmuls and reductions shifts it by rounding error.
SOLO_PARITY_RTOL = 5e-4
SOLO_PARITY_ATOL = 1e-4

_CKPT_KEY = "fleet"
_GEN_LEAF = "fleet/.gen"


def _slug(label: str) -> str:
    """Member label -> filesystem-safe obs subdir name."""
    return re.sub(r"[^A-Za-z0-9_.,=-]+", "-", label).strip("-") or "member"


def _fleet_signature(spec: ExperimentSpec) -> dict:
    """The program identity of a spec: everything but the seed."""
    d = spec.to_dict()
    d["execution"]["seed"] = 0
    return d


def _diff_paths(a, b, prefix="") -> List[str]:
    """Dotted paths where two signature dicts disagree (error reporting)."""
    out: List[str] = []
    for k in sorted(set(a) | set(b)):
        pa, pb = a.get(k), b.get(k)
        path = f"{prefix}{k}"
        if isinstance(pa, dict) and isinstance(pb, dict):
            out += _diff_paths(pa, pb, path + ".")
        elif pa != pb:
            out.append(f"{path} ({pa!r} vs {pb!r})")
    return out


def _members_of(fls: TrainLoopState, members: List[int]):
    """Copies of the slices of ``members`` of every tensor of a fleet
    state, and their generator states."""
    return ([t[members].clone() for t in state_leaves(fls)],
            [fls.gen[m].get_state() for m in members])


def _put_members(fls: TrainLoopState, members: List[int], saved) -> None:
    """Write ``_members_of``'s copies back into the slices of ``members``
    of ``fls``, in place: the neighbours' bits are not touched."""
    leaves, gen_states = saved
    for d, s in zip(state_leaves(fls), leaves):
        d[members] = s
    for m, st in zip(members, gen_states):
        fls.gen[m].set_state(st)


# ------------------------------------------------------------------ fleet

class Fleet:
    """E training runs of one spec, advanced in lockstep.

    All member specs must be identical modulo ``execution.seed`` (use
    ``Sweep.from_grid`` to partition a heterogeneous grid into fleets).
    The public surface mirrors ``Experiment``: ``run`` / ``save`` /
    ``restore`` / ``results``, plus ``set_done`` and ``exploit_explore``.
    ``device=None`` runs on the card (and raises without one)."""

    def __init__(self, specs: Sequence[ExperimentSpec],
                 labels: Optional[Sequence[str]] = None,
                 points: Optional[Sequence[dict]] = None, *,
                 device=None):
        specs = list(specs)
        if not specs:
            raise SpecError("Fleet needs at least one member spec")
        base = specs[0]
        if base.replay.backend != "device":
            raise SpecError(
                "fleets require replay.backend='device': the host replay "
                "is driven by callbacks outside the superstep, which "
                "cannot batch under vmap (each member would need its own "
                "host buffer and callback ordering). Override "
                "replay_backend='device' — Sweep.from_grid does this "
                "by default.")
        if base.execution.mesh_shards:
            raise SpecError(
                "fleets do not compose with execution.mesh_shards yet: "
                "the member axis and the mesh 'data' axis would both claim "
                "the leading dimension. Run mesh-sharded specs solo.")
        if base.guard.enabled and base.guard.policy == "skip":
            raise SpecError(
                "fleets support guard.policy 'halt' or 'rollback', not "
                "'skip': the skip policy rewinds the pre-segment snapshot, "
                "which in a fleet would rewind EVERY member (state is one "
                "stacked tree) — per-member rollback through the durable "
                "store keeps healthy neighbors bitwise untouched instead.")
        sig0 = _fleet_signature(base)
        for i, s in enumerate(specs[1:], 1):
            diff = _diff_paths(sig0, _fleet_signature(s))
            if diff:
                raise SpecError(
                    f"fleet member {i} differs from member 0 beyond the "
                    f"seed: {', '.join(diff)}. One fleet is ONE program, "
                    f"so members may only differ in execution.seed; specs "
                    f"that change shapes or compute (width, depth, "
                    f"activation, ...) need their own sub-fleet — "
                    f"Sweep.from_grid partitions a grid this way "
                    f"automatically.")
        self.trainer = Trainer(base, resolve_device(device))
        self.specs = specs
        self.spec = base
        self.n_members = len(specs)
        self.seeds = np.asarray([s.execution.seed for s in specs], np.int64)
        if labels is None:
            labels = [f"seed={s}" for s in self.seeds]
        if len(labels) != len(specs):
            raise SpecError(f"{len(labels)} labels for {len(specs)} members")
        self.labels = [str(l) for l in labels]
        self.points = [dict(p) for p in points] if points is not None \
            else [{} for _ in specs]
        self.graph: Optional[StepGraph] = None   # captured at first chunk
        self._fls: Optional[TrainLoopState] = None
        self.step = 0
        self.done = np.zeros(self.n_members, bool)
        self.returns: List[List[float]] = [[] for _ in specs]
        self.eval_steps: List[List[int]] = [[] for _ in specs]
        self.sranks: List[List[int]] = [[] for _ in specs]
        self._rows: List[List[Dict[str, float]]] = [[] for _ in specs]
        self._last_metrics: List[Dict[str, float]] = [{} for _ in specs]
        self._wall = 0.0
        self._obs = [self._member_obs(label) for label in self.labels]
        # one Monitor a member for detection (spike windows are per
        # member), one fleet Monitor holding the shared recovery budget
        g = base.guard
        self._guard = Monitor(g) if g.enabled else None
        self._guard_members = [Monitor(g) for _ in specs] if g.enabled \
            else []
        self._guard_store = None       # DurableStore via attach_guard()

    def _member_obs(self, label: str) -> ObsRun:
        """One ObsRun a member: file sinks write under a per-member subdir
        of the base log_dir, and every row is tagged with the label."""
        ospec = self.spec.obs
        if ospec.enabled and ospec.log_dir:
            ospec = self.spec.override(**{"obs.log_dir": str(
                Path(ospec.log_dir) / _slug(label))}).obs
        return ObsRun(ospec, member=label)

    # --------------------------------------------------------- fleet state
    def _ensure_init(self):
        if self._fls is None:
            self._fls = self.trainer.init_fleet(self.seeds.tolist())

    # -------------------------------------------------------- the chunk
    def chunk(self, n_steps: int, do_eval: bool,
              do_srank: bool = False) -> dict:
        """``n_steps`` member-batched supersteps of the live state, then
        the epilogue: with ``do_srank`` each member's effective rank
        (``"srank"``, ``(E,)``), with ``do_eval`` each non-done member's
        eval returns (``"eval"``, one tensor a member, None for a done
        one), then the done members' restore. ``out["scal"]`` holds the
        last superstep's ``(E,)`` scalar metrics; with ``obs_stream``
        ``out["stream"]`` holds every superstep's, ``(n_steps, E)`` host
        arrays, copied to the host once.

        On the card the supersteps are replays of one ``StepGraph``,
        captured at the first chunk (whose first superstep is its warm-up);
        on the CPU they are eager vmapped supersteps."""
        tr = self.trainer
        if n_steps < 1:
            raise ValueError(f"a chunk runs n_steps >= 1, got {n_steps}")
        if tr.obs_stream and n_steps > tr.stream_rows:
            raise ValueError(
                f"a chunk of {n_steps} supersteps is longer than the "
                f"stream's {tr.stream_rows} rows (min of eval.every and "
                f"eval.srank_every)")
        self._ensure_init()
        fls, n = self._fls, n_steps
        frozen = [int(m) for m in np.nonzero(self.done)[0]]
        saved = _members_of(fls, frozen) if frozen else None
        tr.dispatches += n
        if tr.device.type == "cpu":
            keys, rows = (), []
            for _ in range(n):
                fls, metrics, batch = tr.fleet_step(fls)
                if tr.obs_stream:
                    keys = scalar_keys(metrics, members=True)
                    rows.append(scalar_row(metrics, keys))
            stream = torch.stack(rows).numpy() if rows else None
        else:
            if self.graph is None:
                self.graph = StepGraph(tr, fls, tr.stream_rows)
                tr.captures += 1
                metrics, batch = self.graph.warm
                n -= 1
            elif fls is not self.graph.state:
                self.graph.load(fls)
            if n:
                self.graph.replay(n)
                metrics, batch = self.graph.metrics, self.graph.batch
            fls = self.graph.state
            keys = self.graph.keys
            stream = self.graph.read_rows(n_steps) if keys else None
        out: Dict[str, Any] = {"scal": {k: v.clone() for k, v in
                                        metrics.items() if v.ndim == 1}}
        if stream is not None:
            out["stream"] = {k: stream[:, :, j] for j, k in enumerate(keys)}
        if do_srank and tr.srank_every:
            with annotate("repro.fleet_srank"):
                out["srank"] = effective_rank_members(metrics["q_features"])
        if do_eval:
            with annotate("repro.fleet_eval"):
                out["eval"] = [None if self.done[m] else
                               tr.evaluate(member_state(fls, m))
                               for m in range(self.n_members)]
        if frozen:
            _put_members(fls, frozen, saved)
        self._fls = fls
        return out

    # ------------------------------------------------------------ running
    def run(self, steps: Optional[int] = None, *,
            stop_at_return: Optional[float] = None,
            progress: Optional[Callable] = None,
            eval_at_end: bool = False) -> List[RunResult]:
        """Advance every non-done member ``steps`` supersteps (default:
        the spec budget), evaluating at absolute multiples of
        ``eval.every`` as ``Experiment.run`` does (and at the end with
        ``eval_at_end``). ``stop_at_return`` freezes a member once its
        latest eval return reaches it; ``progress(label, step, ret)`` is
        called a recorded eval. Returns ``results()``."""
        t0 = time.time()
        ev = self.spec.eval
        eval_every, srank_every = ev.every, ev.srank_every
        if steps is None:
            steps = self.spec.execution.total_steps
        self._ensure_init()
        s, end = self.step, self.step + steps
        while s < end:
            stops = [(s // eval_every + 1) * eval_every, end]
            if srank_every:
                stops.append((s // srank_every + 1) * srank_every)
            stop = min(stops)
            do_eval = (stop % eval_every == 0
                       or (eval_at_end and stop == end))
            do_srank = (bool(srank_every) and stop % srank_every == 0)
            tc = time.time()
            with annotate("repro.fleet_chunk_dispatch"):
                out = self.chunk(stop - s, do_eval, do_srank)
            bad: frozenset = frozenset()
            if self._guard is not None:
                viol = self._guard_check(s, stop, do_srank, out)
                if viol:
                    bad = self._guard_recover_members(viol, stop)
            self._record(out, s, stop, do_eval, do_srank, time.time() - tc,
                         stop_at_return, progress, skip=bad)
            s = stop
        self.step = end
        self._wall += time.time() - t0
        for obs in self._obs:
            if obs.enabled:
                obs.drain()
        return self.results()

    def _record(self, out, s0: int, stop: int, do_eval: bool,
                do_srank: bool, wall_c: float, stop_at_return, progress,
                skip: frozenset = frozenset()):
        """Host epilogue of one chunk: stream flush, srank and eval
        bookkeeping of every active member, early-stop updates. ``skip``
        members (just rolled back by the guard) have their outputs
        discarded."""
        live = [m for m in range(self.n_members)
                if not self.done[m] and m not in skip]
        if "stream" in out:
            for m in live:
                obs = self._obs[m]
                if obs.enabled:
                    obs.flush_chunk(s0, {k: v[:, m] for k, v in
                                         out["stream"].items()})
                    obs.chunk_event(s0, stop, wall_c)
        if do_srank and "srank" in out:
            srank = out["srank"].cpu().numpy()
            for m in live:
                self.sranks[m].append(int(srank[m]))
                self._obs[m].log_event("srank", step=stop,
                                       srank=int(srank[m]))
        if do_eval:
            scal = {k: v.cpu().numpy() for k, v in out["scal"].items()}
            for m in live:
                ret = float(out["eval"][m].cpu().numpy().mean())
                scalars = {k: float(v[m]) for k, v in scal.items()}
                self.returns[m].append(ret)
                self.eval_steps[m].append(stop)
                self._last_metrics[m] = scalars
                self._rows[m].append({"step": stop, "return": ret,
                                      **scalars})
                self._obs[m].log_eval(stop, ret, scalars)
                if progress:
                    progress(self.labels[m], stop, ret)
            if stop_at_return is not None:
                for m in range(self.n_members):
                    if (not self.done[m] and self.returns[m]
                            and self.returns[m][-1] >= stop_at_return):
                        self.done[m] = True
                        self._obs[m].log_event(
                            "early_stop", step=stop,
                            ret=self.returns[m][-1],
                            threshold=float(stop_at_return))

    # ------------------------------------------------------------- guarding
    def attach_guard(self, store) -> None:
        """Attach a ``DurableStore`` of fleet checkpoints (``Fleet.save``
        payloads): the rollback source for guard.policy='rollback'."""
        self._guard_store = store

    def _guard_check(self, s0: int, stop: int, do_srank: bool, out) -> list:
        """Per-member health checks of one chunk's outputs. Done members
        are exempt: their state was restored at the chunk's end."""
        viol: list = []
        stream = out.get("stream")
        for m in range(self.n_members):
            if self.done[m]:
                continue
            mm = self._guard_members[m]
            if stream is not None:
                viol += mm.check_stream(
                    s0, {k: v[:, m] for k, v in stream.items()}, member=m)
            if do_srank and self._guard.spec.srank_collapse \
                    and "srank" in out:
                series = self.sranks[m] + [int(out["srank"][m])]
                viol += mm.check_srank(stop, series, member=m)
        viol += [v for v in self._guard.check_member_params(
                     stop, self._fls.agent["params"])
                 if not self.done[v.member]]
        return viol

    def _guard_recover_members(self, violations: list,
                               stop: int) -> frozenset:
        """Apply the fleet guard policy: halt raises; rollback restores the
        violating MEMBERS' slices and generators from the newest good
        fleet checkpoint, in place, and perturbs their generators with the
        recovery ordinal (``fold_in``), so healthy neighbours' bits are
        never touched. Returns the violating members for ``_record`` to
        skip."""
        mon = self._guard
        for v in violations:
            d = v.as_dict()
            m = d.pop("member", 0)
            self._obs[m].log_event("guard_violation", **d)
        bad = frozenset(v.member for v in violations)
        try:
            if mon.spec.policy == "halt":
                raise GuardViolation(
                    f"guard: halt on {violations[0].reason} at step "
                    f"{violations[0].step} (member(s) {sorted(bad)})",
                    violations, mon.recoveries)
            ordinal = mon.spend_recovery(violations)
            store = self._guard_store
            if store is None:
                raise GuardViolation(
                    "guard.policy='rollback' needs a DurableStore — call "
                    "Fleet.attach_guard(store) (the supervisor does this "
                    "automatically)", violations, mon.recoveries)
            path = store.restore_latest(
                on_bad=lambda b: self._obs[0].log_event(
                    "guard_bad_checkpoint", step=stop, path=str(b.path),
                    reason=b.reason))
            if path is None:
                raise GuardViolation(
                    f"guard rollback: no good checkpoint in {store.dir}",
                    violations, mon.recoveries)
        except GuardViolation:
            for obs in self._obs:
                obs.drain()
            raise
        good = self._load_state(store.payload(path), DurableStore.step_of(
            path))
        members = sorted(bad)
        _put_members(self._fls, members, _members_of(good, members))
        for m in members:
            fold_in(self._fls.gen[m], ordinal)
        from_step = DurableStore.step_of(path)
        for m in members:
            self._obs[m].log_event(
                "guard_rollback", step=stop, recovery=ordinal,
                detected=violations[0].step, rolled_back_to=from_step,
                reason=violations[0].reason)
            self._obs[m].drain()
        return bad

    def set_done(self, members, value: bool = True) -> None:
        """Freeze (or unfreeze) members by index list or ``(E,)`` bool
        mask. A frozen member's state stays untouched through later chunks,
        and unfreezing resumes it bit for bit."""
        members = np.asarray(members)
        if members.dtype == bool:
            if members.shape != (self.n_members,):
                raise SpecError(f"done mask shape {members.shape} != "
                                f"({self.n_members},)")
            self.done = members.copy() if value else ~members
        else:
            self.done[members] = value

    # --------------------------------------------------------- PBT stretch
    def exploit_explore(self, *, fraction: float = 0.25,
                        noise_scale: float = 0.0,
                        scores: Optional[Sequence[float]] = None) -> dict:
        """Truncation selection on the member axis (PBT exploit/explore).

        Ranks members by ``scores`` (default: each member's latest eval
        return), copies the agent state (params, opt, step) of the top
        ``fraction`` onto the bottom ``fraction`` and, with ``noise_scale``
        > 0, scales each copied param leaf by ``1 + noise_scale * z``, ``z``
        standard normals drawn from the loser's own generator, leaf by leaf
        in the params' order. Actors, replay and the rest of each member's
        state stay its own. Done members are never overwritten or copied
        from. Returns ``{"copied": {loser_label: winner_label},
        "scores": [...]}``."""
        if not 0.0 < fraction <= 0.5:
            raise SpecError(f"exploit_explore fraction={fraction} must be "
                            f"in (0, 0.5]")
        self._ensure_init()
        if scores is None:
            scores = [r[-1] if r else -np.inf for r in self.returns]
        scores = np.asarray(scores, np.float64)
        if scores.shape != (self.n_members,):
            raise SpecError(f"scores shape {scores.shape} != "
                            f"({self.n_members},)")
        eligible = np.nonzero(~self.done & np.isfinite(scores))[0]
        k = min(int(round(self.n_members * fraction)), len(eligible) // 2)
        if k < 1:
            return {"copied": {}, "scores": scores.tolist()}
        order = eligible[np.argsort(scores[eligible])]
        losers, winners = order[:k], order[-k:][::-1]
        fls = self._fls
        lo = torch.as_tensor(losers.copy(), device=fls.step.device)
        wi = torch.as_tensor(winners.copy(), device=fls.step.device)
        with torch.no_grad():
            for leaf in tree_leaves(fls.agent):
                leaf[lo] = leaf[wi]
            if noise_scale > 0.0:
                params = tree_leaves(fls.agent["params"])
                for m in losers:
                    gen = fls.gen[m]
                    for leaf in params:
                        z = torch.randn(leaf.shape[1:], generator=gen,
                                        device=gen.device, dtype=leaf.dtype)
                        leaf[m] = leaf[m] * (1.0 + noise_scale * z)
        copied = {self.labels[l]: self.labels[w]
                  for l, w in zip(losers, winners)}
        for l, w in zip(losers, winners):
            self._obs[l].log_event("exploit", step=self.step,
                                   copied_from=self.labels[w],
                                   noise_scale=float(noise_scale))
        return {"copied": copied, "scores": scores.tolist()}

    # ------------------------------------------------------------ results
    def results(self) -> List[RunResult]:
        """One cumulative ``RunResult`` a member (fleet order). The wall
        time is the fleet's: members run in lockstep."""
        out = []
        for m in range(self.n_members):
            metrics = dict(self._last_metrics[m],
                           host_dispatches=float(self.trainer.dispatches))
            out.append(RunResult(
                returns=list(self.returns[m]),
                eval_steps=list(self.eval_steps[m]),
                sranks=list(self.sranks[m]), metrics=metrics,
                param_count=self.trainer.n_params, wall_time_s=self._wall))
        return out

    def metrics(self, member: int):
        """The eval rows of one member."""
        return iter([dict(r) for r in self._rows[member]])

    @property
    def obs(self) -> List[ObsRun]:
        return self._obs

    def close(self) -> None:
        for obs in self._obs:
            obs.close()

    # ------------------------------------------------------ checkpointing
    def save(self, path: str) -> None:
        """The whole fleet state -> one checkpoint through ``ckpt``: the
        stacked state under the reference's leaf names, the members'
        generator states as ``fleet/.gen`` (``(E, bytes)`` uint8), the
        specs and histories in the metadata. The card and the obs sinks
        are drained first; nothing is captured anew."""
        self._ensure_init()
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)
        for obs in self._obs:
            obs.drain()
        fls = self._fls
        state = {
            "specs": [s.to_dict() for s in self.specs],
            "labels": self.labels, "points": self.points,
            "step": self.step, "done": self.done.tolist(),
            "returns": self.returns, "eval_steps": self.eval_steps,
            "sranks": self.sranks, "rows": self._rows,
            "last_metrics": self._last_metrics,
            "wall_time_s": self._wall,
            "n_params": int(self.trainer.n_params),
            "dispatches": int(self.trainer.dispatches),
            "obs": [obs.state() for obs in self._obs],
        }
        gens = torch.stack([g.get_state() for g in fls.gen])
        with annotate("repro.fleet_ckpt_save"):
            ckpt.save(path, {_CKPT_KEY: fls._replace(gen=gens)},
                      metadata={_CKPT_KEY: state})
        for obs in self._obs:
            obs.log_event("save", step=self.step, path=str(path))
            obs.drain()

    def _load_state(self, path: str, step: int) -> TrainLoopState:
        """A fleet state loaded from a ``save`` checkpoint (either
        package's) onto this fleet's device, with generators of its own: the
        saved ones, or for a JAX checkpoint (no torch generator states)
        each member's seeded by ``resume_seed(seed, step)``."""
        tmpl = self.trainer.fleet_template(self.seeds.tolist())
        has_gen = _GEN_LEAF in ckpt.leaf_names(path)
        gens = torch.stack([g.get_state() for g in tmpl.gen]) \
            if has_gen else None
        loaded = ckpt.restore(path, {_CKPT_KEY: tmpl._replace(gen=gens)},
                              self.trainer.device)[_CKPT_KEY]
        for m, g in enumerate(tmpl.gen):
            if has_gen:
                g.set_state(loaded.gen[m].cpu().clone())
            else:
                g.manual_seed(resume_seed(int(self.seeds[m]), step))
        return loaded._replace(gen=tmpl.gen)

    @classmethod
    def restore(cls, path: str, *, device=None) -> "Fleet":
        """A fleet rebuilt from ``save`` output (either package's) onto
        ``device`` (default: the card); under ``loop="scan"`` on the card
        the first chunk captures its graph from the restored state."""
        meta = ckpt.load_metadata(path)
        if meta is None or _CKPT_KEY not in meta:
            raise FileNotFoundError(
                f"{path}: no fleet-bearing checkpoint metadata — was this "
                f"saved by Fleet.save?")
        st = meta[_CKPT_KEY]
        fl = cls([ExperimentSpec.from_dict(d) for d in st["specs"]],
                 labels=list(st["labels"]), points=st.get("points"),
                 device=device)
        fl.step = int(st["step"])
        fl._fls = fl._load_state(path, fl.step)
        fl.done = np.asarray(st["done"], bool)
        fl.returns = [[float(r) for r in rs] for rs in st["returns"]]
        fl.eval_steps = [[int(s) for s in ss] for ss in st["eval_steps"]]
        fl.sranks = [[int(s) for s in ss] for ss in st["sranks"]]
        fl._rows = [[dict(r) for r in rs] for rs in st.get("rows", [])] \
            or [[] for _ in fl.specs]
        fl._last_metrics = [dict(m) for m in st.get("last_metrics", [])] \
            or [{} for _ in fl.specs]
        fl._wall = float(st.get("wall_time_s", 0.0))
        fl.trainer.n_params = int(st["n_params"])
        fl.trainer.dispatches = int(st.get("dispatches", 0))
        for obs, ost in zip(fl._obs, st.get("obs", [])):
            obs.load_state(ost)
            obs.log_event("restore", step=fl.step, path=str(path))
            obs.drain()
        return fl


# ------------------------------------------------------------------ sweep

@dataclasses.dataclass
class MemberResult:
    """One grid member's outcome: where it came from and what it scored."""
    label: str
    point: Dict[str, Any]           # the override()s that define the member
    seed: int
    result: RunResult


class Sweep:
    """A grid of experiment variants, partitioned into fleets.

    ``from_grid`` expands ``axis`` x ``seeds`` into member specs, groups
    them by signature (spec modulo seed) and builds one ``Fleet`` a group,
    so a width sweep becomes per-width fleets and a pure seed battery one
    fleet. ``partition`` reports the grouping; ``run`` / ``save`` /
    ``restore`` / ``results`` fan out over the fleets."""

    def __init__(self, fleets: Sequence[Fleet],
                 order: Optional[Sequence[tuple]] = None):
        if not fleets:
            raise SpecError("Sweep needs at least one fleet")
        self.fleets = list(fleets)
        # grid order as (fleet_idx, member_idx); default: fleet order
        self._order = [tuple(o) for o in order] if order is not None else [
            (fi, mi) for fi, fl in enumerate(self.fleets)
            for mi in range(fl.n_members)]

    @classmethod
    def from_grid(cls, base, axis=None, seeds: int = 1, *, device=None,
                  **overrides) -> "Sweep":
        """A sweep over ``base`` (an ``ExperimentSpec`` or a
        ``repro_torch.rl.presets`` name).

        ``axis`` is a dict of ``override()`` key -> list of values (full
        cartesian product) or a list of override dicts (irregular grids).
        ``seeds`` replicates every grid point with ``execution.seed`` =
        base seed + 0..seeds-1. Extra ``overrides`` apply to the base spec
        first. A host-replay base is upgraded to the device replay with a
        ``SpecWarning``. ``device`` is every fleet's."""
        from repro_torch.rl import presets
        spec = presets.get(base) if isinstance(base, str) else base
        if overrides:
            spec = spec.override(**overrides)
        if spec.replay.backend != "device":
            warnings.warn(
                "Sweep.from_grid: upgrading replay.backend to 'device' "
                "(the fleet default — the host replay cannot batch under "
                "vmap). Pass replay_backend='device' to silence, or run "
                "host-backend specs solo.", SpecWarning, stacklevel=2)
            spec = spec.override(replay_backend="device")
        if isinstance(axis, Mapping):
            keys = list(axis)
            points = [dict(zip(keys, vals))
                      for vals in itertools.product(*(axis[k]
                                                      for k in keys))]
        else:
            points = [dict(p) for p in axis] if axis else [{}]
        if not points:
            points = [{}]
        for p in points:
            if any(k in ("seed", "execution.seed") for k in p):
                raise SpecError("put seeds on the seeds= axis, not in "
                                "axis= (fleet members batch over seeds)")
        _positive_seeds(seeds)
        base_seed = spec.execution.seed

        members = []                      # (sig_json, spec, label, point)
        for point in points:
            pspec = spec.override(**point) if point else spec
            ptag = ",".join(f"{k}={v}" for k, v in point.items())
            for si in range(seeds):
                mspec = pspec.override(seed=base_seed + si)
                label = (ptag + "," if ptag else "") + f"seed={base_seed+si}"
                sig = json.dumps(_fleet_signature(mspec), sort_keys=True)
                members.append((sig, mspec, label, point))

        groups: Dict[str, List[tuple]] = {}
        for sig, mspec, label, point in members:
            groups.setdefault(sig, []).append((mspec, label, point))
        fleets = [Fleet([m[0] for m in g], labels=[m[1] for m in g],
                        points=[m[2] for m in g], device=device)
                  for g in groups.values()]
        # recover grid order through the per-fleet member positions
        pos = {(id_sig, label): (fi, mi)
               for fi, (id_sig, g) in enumerate(groups.items())
               for mi, (_, label, _) in enumerate(g)}
        order = [pos[(sig, label)] for sig, _, label, _ in members]
        return cls(fleets, order=order)

    # ------------------------------------------------------------- surface
    @property
    def n_members(self) -> int:
        return sum(fl.n_members for fl in self.fleets)

    @property
    def partition(self) -> List[List[str]]:
        """Member labels grouped by fleet: the partition ``from_grid``
        chose (one entry a member-batched program)."""
        return [list(fl.labels) for fl in self.fleets]

    def describe(self) -> str:
        lines = [f"sweep: {self.n_members} members in {len(self.fleets)} "
                 f"fleet(s) (one compiled program each)"]
        for fi, fl in enumerate(self.fleets):
            lines.append(f"  fleet {fi}: {fl.n_members} member(s) — "
                         f"{', '.join(fl.labels)}")
        return "\n".join(lines)

    def run(self, steps: Optional[int] = None, **kwargs) \
            -> List[MemberResult]:
        """``Fleet.run`` on every fleet in partition order; returns
        ``results()`` (grid order)."""
        for fl in self.fleets:
            fl.run(steps, **kwargs)
        return self.results()

    def results(self) -> List[MemberResult]:
        """Per-member results in the ORIGINAL grid order (axis product
        x seeds), however the partition grouped them."""
        per_fleet = [fl.results() for fl in self.fleets]
        out = []
        for fi, mi in self._order:
            fl = self.fleets[fi]
            out.append(MemberResult(
                label=fl.labels[mi], point=dict(fl.points[mi]),
                seed=int(fl.seeds[mi]), result=per_fleet[fi][mi]))
        return out

    def close(self) -> None:
        for fl in self.fleets:
            fl.close()

    def exploit_explore(self, **kwargs) -> List[dict]:
        """``Fleet.exploit_explore`` per fleet (PBT cannot copy params
        across fleets: different shapes)."""
        return [fl.exploit_explore(**kwargs) for fl in self.fleets]

    # ------------------------------------------------------ checkpointing
    def save(self, directory: str) -> None:
        """One fleet checkpoint a fleet + a ``sweep.json`` manifest under
        ``directory``."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        for fi, fl in enumerate(self.fleets):
            fl.save(str(d / f"fleet_{fi:03d}.npz"))
        (d / "sweep.json").write_text(json.dumps(
            {"version": 1, "fleets": len(self.fleets),
             "order": [list(o) for o in self._order]}, indent=1))

    @classmethod
    def restore(cls, directory: str, *, device=None) -> "Sweep":
        d = Path(directory)
        manifest = d / "sweep.json"
        if not manifest.exists():
            raise FileNotFoundError(f"{manifest}: not a Sweep.save output")
        m = json.loads(manifest.read_text())
        fleets = [Fleet.restore(str(d / f"fleet_{fi:03d}.npz"),
                                device=device)
                  for fi in range(int(m["fleets"]))]
        return cls(fleets, order=[tuple(o) for o in m["order"]])


def _positive_seeds(seeds) -> None:
    if not isinstance(seeds, (int, np.integer)) or isinstance(seeds, bool) \
            or seeds < 1:
        raise SpecError(f"seeds={seeds!r} must be an int >= 1")
