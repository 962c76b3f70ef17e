"""The system under test, driven as a cell's traffic asks: one
``Experiment`` (``kind: "solo"``) or one ``Fleet`` of ``members`` seeds
(``kind: "fleet"``) of the configuration's spec with the cell's
overrides, on one device.

``load`` hands the system the benchmark's start (``sac_ref.init_starts``
of ``seeds``): into a state the system builds without its own warm-up
(the template its ``restore`` loads into), each leaf copied by its
checkpoint path, the generator set, and the warm-up's rows added through
the system's own replay add; ``check_step`` advances one superstep
through the timed path (the run's chunk function, whose first call
captures the CUDA graph) and returns what it produced; ``run`` is the
window's call (``Experiment.run`` / ``Fleet.run``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from bench.reference import sac_ref as ref
from bench.reference.judge import LOSS_KEYS


def flatten(tree: Any, prefix: str) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _host(t: Any, m: int = -1) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return (t if m < 0 else t[m]).detach().cpu().numpy().copy()
    return np.array(t if m < 0 else t[m])


def _spec(config: dict, cell: dict, seed: int):
    from repro_torch.rl.experiment import ExperimentSpec
    spec = ExperimentSpec.from_dict(config["spec"])
    return spec.override(**cell.get("overrides", {}), seed=int(seed))


class Driver:
    """What both kinds share; ``members`` and the live state come from
    the subclass."""
    members = 1

    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.config, self.cell = config, cell
        self.device = torch.device(device)
        self.spec = _spec(config, cell, seed)
        self.seeds = [int(seed) + m for m in range(self.members)]
        self.trainer = None

    # the live loop state (a fleet's: member-stacked)
    def state(self):
        raise NotImplementedError

    _stacked = False
    n_checked = 0

    def _idx(self, m: int) -> int:
        return m if self._stacked else -1

    def _put(self, ls, start: Dict[str, Any]) -> None:
        """One member's start into its state ``ls`` (a fleet's: views of
        the member's slices), in place."""
        tr = self.trainer
        for kind in ("params", "opt"):
            have = dict(flatten(ls.agent[kind], kind))
            if set(have) != set(start[kind]):
                raise ValueError(f"the start's {kind} and the system's "
                                 f"differ: {sorted(set(have) ^ set(start[kind]))}")
            for p, v in have.items():
                if v.shape != start[kind][p].shape:
                    raise ValueError(f"{p}: {tuple(v.shape)} in the system, "
                                     f"{tuple(start[kind][p].shape)} given")
                v.copy_(start[kind][p])
        for f, v in start["env"].items():
            getattr(ls.actors, f).copy_(v)
        ls.gen.set_state(start["gen_state"])
        rows = start["store"]
        if tr.host:
            n = rows["obs"].shape[0]
            tr.host_add(torch.cat([rows[k].reshape(n, -1)
                                   for k in tr.row_shapes], 1).cpu().numpy())
            tr.rng = np.random.default_rng()
            tr.rng.bit_generator.state = start["rng_state"]
        else:
            from repro_torch.replay.device import replay_add
            replay_add(tr.dcfg, ls.replay, rows)

    def grads(self) -> List[Dict[str, np.ndarray]]:
        """Each member's first gradient as AdamW got it: its first moment
        over ``1 - b1``, by parameter path (read after one step)."""
        b1 = self.config["constants"]["adam_b1"]
        ls, i = self.state(), self._idx
        return [{ref.opt_param_path(p): _host(v, i(m)) / (1.0 - b1)
                 for p, v in flatten(ls.agent["opt"], "opt")
                 if ref.opt_param_path(p)} for m in range(self.members)]

    def finals(self, ptr0: List[int]) -> List[Dict[str, Any]]:
        """Each member's params, the rows the checked steps wrote and the
        actors' observations (read after the last checked step)."""
        from repro_torch.rl.envs import make_env
        env = make_env(self.spec.env)
        ls, tr, out = self.state(), self.trainer, []
        n = self.n_checked * tr.n_actors
        for m in range(self.members):
            i = self._idx(m)
            rows = (ptr0[m] + np.arange(n)) % tr.dcfg.capacity
            if tr.host:
                inner = getattr(tr.buffer, "_inner", tr.buffer)
                store = {k: v[rows].copy() for k, v in inner.data.items()}
            else:
                store = {k: _host(v, i)[rows] for k, v in
                         ls.replay["store"]["data"].items()}
            actors = ls.actors if i < 0 else type(ls.actors)(
                *(t[i] for t in ls.actors))
            out.append({"params3": {p: _host(v, i) for p, v in
                                    flatten(ls.agent["params"], "params")},
                        "store3": store, "obs3": _host(env.obs(actors))})
        return out

    def warm_epilogue(self) -> None:
        """The srank epilogue's first call builds its solver's state: make
        it at set-up, at the shape the window's epilogues use."""
        graph = getattr(self.trainer, "graph", None) or getattr(
            getattr(self, "fleet", None), "graph", None)
        if not self.spec.eval.srank_every or graph is None:
            return
        from repro_torch.core import effective_rank as er
        feat = graph.metrics["q_features"].clone()
        (er.effective_rank_members if self._stacked
         else er.effective_rank)(feat)

    def finite(self) -> List[bool]:
        """Whether each member's parameters are all finite."""
        ls = self.state()
        leaves = [v for _, v in flatten(ls.agent["params"], "")]
        if not self._stacked:
            return [bool(all(torch.isfinite(v).all() for v in leaves))]
        ok = torch.stack([torch.isfinite(v.reshape(v.shape[0], -1)).all(1)
                          for v in leaves]).all(0)
        return [bool(x) for x in ok.cpu()]


class Solo(Driver):
    """One ``Experiment``."""

    def __init__(self, config, cell, seed, device):
        super().__init__(config, cell, seed, device)
        from repro_torch.rl.experiment import Experiment
        self.exp = Experiment.from_spec(self.spec, device=self.device)
        self.trainer = self.exp.trainer

    def state(self):
        return self.exp._ls

    def load(self, starts: List[Dict[str, Any]]) -> None:
        ls = self.trainer.init_template()
        self._put(ls, starts[0])
        self.exp._ls = ls

    def check_step(self) -> List[Dict[str, Any]]:
        """One superstep through the run's chunk function (its first call
        captures the graph); the losses, sampled rows and priorities."""
        ls, out = self.trainer.chunk_fn(1, False)(self.exp._ls)
        self.exp._ls, self.exp.step = ls, self.exp.step + 1
        self.n_checked += 1
        batch, prio = out["last"]
        return [{"losses": {k: float(v) for k, v in out["scal"].items()
                            if k in LOSS_KEYS},
                 "batch": {k: _host(v) for k, v in batch.items()},
                 "priorities": _host(prio)}]

    def run(self, steps: int) -> None:
        self.exp.run(steps)


class FleetRun(Driver):
    """One ``Fleet`` of ``members`` seeds: ``seed``, ``seed + 1``, ..."""
    _stacked = True

    def __init__(self, config, cell, seed, device):
        super().__init__(config, cell, seed, device)
        from repro_torch.rl.sweep import Fleet
        self.members = int(cell["members"])
        self.seeds = [int(seed) + m for m in range(self.members)]
        self.fleet = Fleet([self.spec.override(seed=s) for s in self.seeds],
                           device=self.device)
        self.trainer = self.fleet.trainer
        step = self.trainer.fleet_step
        self._last = None

        def recorded(fls, draws=None):
            # a fleet chunk returns no batch: on the CPU take the step's
            self._last = step(fls, draws)
            return self._last
        self.trainer.fleet_step = recorded

    def state(self):
        return self.fleet._fls

    def load(self, starts: List[Dict[str, Any]]) -> None:
        from repro_torch.rl.runner import member_state
        fls = self.trainer.fleet_template(self.seeds)
        for m, start in enumerate(starts):
            self._put(member_state(fls, m), start)
        self.fleet._fls = fls

    def check_step(self) -> List[Dict[str, Any]]:
        out = self.fleet.chunk(1, False)
        self.fleet.step += 1
        self.n_checked += 1
        g = self.fleet.graph
        if g is None:                       # the CPU: eager supersteps
            _, metrics, batch = self._last
        elif self.n_checked == 1:           # the graph's eager warm-up
            metrics, batch = g.warm
        else:
            metrics, batch = g.metrics, g.batch
        return [{"losses": {k: float(v[m]) for k, v in out["scal"].items()
                            if k in LOSS_KEYS},
                 "batch": {k: _host(v, m) for k, v in batch.items()
                           if k != "add_step"},
                 "priorities": _host(metrics["priorities"], m)}
                for m in range(self.members)]

    def run(self, steps: int) -> None:
        self.fleet.run(steps)



KINDS = {"solo": Solo, "fleet": FleetRun}


def make(config: dict, cell: dict, seed: int, device) -> Driver:
    return KINDS[cell["kind"]](config, cell, seed, device)
