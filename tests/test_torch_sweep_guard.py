"""A fleet's obs, guard and checkpoints in the port, on the CPU, and
across the packages.

* Per-member obs: each member's ``ObsRun`` writes under
  ``<log_dir>/<label>/`` with every row tagged ``"member"``; the port's
  ``obs.report`` merges such a sweep directory, the port's and the JAX
  package's alike.
* The fleet guard (the port's analogues of ``tests/test_guard.py``'s
  fleet tests): ``halt`` raises naming the member; a member poisoned after
  a durable save rolls back from the store while its neighbours stay
  bitwise a fault-free fleet, and the rolled-back member is the restored
  checkpoint with its generator perturbed by ``fold_in(gen, 1)`` run for
  the rest of the fleet's schedule; ``member_finite`` and
  ``poison_params(member=)``; ``supervise --seeds 2`` runs a fleet.
* A JAX ``Fleet.save`` restores in the port with every leaf the packages
  share equal (its members' generators seeded by ``resume_seed``).
"""
import json

import numpy as np
import pytest
import torch

from repro.rl.experiment import ExperimentSpec as JSpec
from repro.rl.sweep import Fleet as JFleet
from repro_torch.checkpoint import ckpt
from repro_torch.common import tree_leaves
from repro_torch.guard import (DurableStore, GuardViolation, chaos, fold_in,
                               member_finite, supervise)
from repro_torch.obs import report
from repro_torch.rl.experiment import ExperimentSpec, resume_seed
from repro_torch.rl.runner import clone_state, member_state, state_leaves
from repro_torch.rl.sweep import Fleet

_SMALL = dict(num_units=16, num_layers=1, use_ofenet=False, n_core=1,
              n_env=4, total_steps=12, warmup_steps=8, eval_every=3,
              eval_episodes=1, replay_capacity=256, batch_size=16,
              replay_backend="device", loop="scan")


def _small(**overrides):
    return ExperimentSpec().override(**{**_SMALL, **overrides})


def _guarded(policy, **kw):
    return _small(**{"guard.enabled": True, "guard.policy": policy, **kw})


def _fleet(spec, seeds=(0, 1)):
    return Fleet([spec.override(seed=s) for s in seeds], device="cpu")


def _same_member(a, b, m) -> bool:
    return all(torch.equal(x[m], y[m]) for x, y in
               zip(state_leaves(a), state_leaves(b))) \
        and torch.equal(a.gen[m].get_state(), b.gen[m].get_state())


# ------------------------------------------------------------------- obs

def test_obs_streams_demux_per_member(tmp_path):
    spec = _small(**{"obs.log_dir": str(tmp_path / "sweep"),
                     "obs.enabled": True, "obs.sinks": "jsonl",
                     "obs.log_every": 1})
    fleet = Fleet([spec.override(seed=s) for s in (0, 1)],
                  labels=["seed=0", "seed=1"], device="cpu")
    fleet.run(6)
    fleet.close()
    dirs = sorted(p.name for p in (tmp_path / "sweep").iterdir())
    assert dirs == ["seed=0", "seed=1"]
    rows = {}
    for d in dirs:
        lines = [json.loads(l) for l in
                 (tmp_path / "sweep" / d / "metrics.jsonl")
                 .read_text().splitlines()]
        assert lines and all(r["member"] == d for r in lines)
        rows[d] = lines
    assert [r["step"] for r in rows["seed=0"] if r["kind"] == "train"] \
        == list(range(1, 7))
    r0 = [r["return"] for r in rows["seed=0"] if r["kind"] == "eval"]
    r1 = [r["return"] for r in rows["seed=1"] if r["kind"] == "eval"]
    assert r0 and r1 and r0 != r1
    merged = report.load_rows(str(tmp_path / "sweep"))
    assert len(merged) == len(rows["seed=0"]) + len(rows["seed=1"])
    summary = report.summarize(merged)
    assert summary["throughput"]["chunks"] == 4
    assert "member" not in summary.get("losses", {})


def test_report_merges_a_jax_sweep_directory(tmp_path):
    jspec = JSpec().override(**{**_SMALL, "obs.enabled": True,
                                "obs.sinks": "jsonl",
                                "obs.log_dir": str(tmp_path / "jx")})
    jf = JFleet([jspec.override(seed=s) for s in (0, 1)])
    jf.run(6)
    jf.close()
    rows = report.load_rows(str(tmp_path / "jx"))
    assert {r.get("member") for r in rows} == {"seed=0", "seed=1"}
    evals = [r for r in rows if r["kind"] == "eval"]
    assert len(evals) == 4
    assert report.summarize(rows)["eval"] is not None


# ----------------------------------------------------------------- guard

def test_fleet_halt_raises_naming_the_member():
    fleet = _fleet(_guarded("halt"))
    fleet.run(3)
    chaos.poison_params(fleet, member=1)
    with pytest.raises(GuardViolation, match=r"member\(s\) \[1\]") as gv:
        fleet.run(3)
    assert {v.member for v in gv.value.violations} == {1}


def test_fleet_member_rollback_leaves_neighbors_bitwise(tmp_path):
    control = _fleet(_guarded("rollback"))
    control.run(12)
    fleet = _fleet(_guarded("rollback"))
    store = DurableStore(str(tmp_path), keep=3)
    fleet.attach_guard(store)
    fleet.run(6)
    store.save(lambda p: fleet.save(p), 6)
    chaos.poison_params(fleet, member=1)
    fleet.run(6)                              # member 1 rolls back to 6
    assert fleet.step == 12 and fleet._guard.recoveries == 1
    assert _same_member(fleet._fls, control._fls, 0)
    assert fleet.returns[0] == control.returns[0]
    assert member_finite(fleet._fls.agent["params"]).all()
    # lockstep: member 1 restarts from the step-6 checkpoint with its
    # generator perturbed and runs only the fleet's remaining schedule
    good = Fleet.restore(DurableStore.payload(store.checkpoints()[0]),
                         device="cpu")
    fold_in(good._fls.gen[1], 1)
    good.run(3)
    assert _same_member(fleet._fls, good._fls, 1)


def test_fleet_rollback_without_store_raises():
    fleet = _fleet(_guarded("rollback"))
    fleet.run(3)
    chaos.poison_params(fleet, member=0)
    with pytest.raises(GuardViolation, match="store"):
        fleet.run(3)


def test_member_finite_and_poison_params():
    fleet = _fleet(_small(), seeds=(0, 1, 2))
    fleet.run(3)
    assert member_finite(fleet._fls.agent["params"]).tolist() == \
        [True] * 3
    chaos.poison_params(fleet, member=2)
    assert member_finite(fleet._fls.agent["params"]).tolist() == \
        [True, True, False]
    with pytest.raises(RuntimeError, match="member="):
        chaos.poison_params(fleet)
    with pytest.raises(RuntimeError, match="not initialized"):
        chaos.poison_params(_fleet(_small()), member=0)


def test_supervise_seeds_runs_a_fleet(tmp_path):
    args = ["smoke", "--dir", str(tmp_path), "--steps", "6",
            "--save-every", "3", "--seeds", "2", "--device", "cpu",
            "--override", "replay.backend=device", "--worker"]
    assert supervise.main(args) == 0
    res = json.loads((tmp_path / "result.json").read_text())
    assert res["step"] == 6 and len(res["returns"]) == 2
    store = DurableStore(str(tmp_path / "ckpts"))
    fl = Fleet.restore(DurableStore.payload(store.restore_latest()),
                       device="cpu")
    assert fl.n_members == 2 and fl.step == 6
    assert res["params_sha256"] == supervise._digest(
        fl._fls.agent["params"])


# ----------------------------------------------------- JAX checkpoints in

def test_jax_fleet_checkpoint_restores_with_shared_leaves_equal(tmp_path):
    path = str(tmp_path / "jfleet.npz")
    jspec = JSpec().override(**_SMALL)
    jf = JFleet([jspec.override(seed=s) for s in (3, 5)])
    jf.run(4)
    jf.save(path)
    fl = Fleet.restore(path, device="cpu")
    assert fl.step == 4 and fl.returns == jf.returns
    names = set(ckpt.leaf_names(path))
    with np.load(path) as data:
        ours = dict(ckpt._leaves({"fleet": fl._fls._replace(gen=None)}))
        assert ours and set(ours) <= names
        for name, t in ours.items():
            np.testing.assert_array_equal(t.numpy(), data[name], name)
    for m, seed in enumerate((3, 5)):
        want = torch.Generator().manual_seed(resume_seed(seed, 4))
        assert torch.equal(fl._fls.gen[m].get_state(), want.get_state())
    fl.run(2)
    assert fl.step == 6 and all(len(r) == 2 for r in fl.returns)
