"""The port's guard (``repro_torch.guard``) against the JAX package's and
its own contracts (mirroring ``tests/test_guard.py`` for a solo run).

* Store: staged commits, retention, torn saves, checksum fallback; each
  package's ``DurableStore`` lists, verifies and ``restore_latest``s the
  other's store, corrupt fallback included.
* Monitor: the same numpy stream and scalars through the reference's
  ``Monitor`` and the port's give the same violations (reasons, steps,
  the spike window); ``all_finite`` over params; ``fold_in``, the
  generator perturbation of a recovery.
* Contracts, both loops: a guarded run with no violation equals an
  unguarded one bitwise; ``halt`` reports the exact detection step
  (``arm_nan_step(at_step=10)`` -> 11); ``skip`` spends its budget and
  raises, and a skip of a transient fault is "snapshot + ``fold_in`` +
  rerun" bitwise; ``rollback`` equals "restore the checkpoint +
  ``fold_in`` + rerun" bitwise, and raises without a store.
* ``BufferedWriter`` retries a transient sink error and surfaces a
  permanent one at drain (``FlakySink``).
* Supervisor (subprocesses on the CPU): SIGKILL mid-segment or mid-save
  auto-resumes to the params digest of an uninterrupted run; a spent
  budget writes ``incident.json`` and exits 2; ``--seeds 2`` runs a
  fleet, which refuses the host replay; the digest equals the
  reference's on the same params.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.common import tree_map
from repro_torch.guard import (CheckpointCorrupt, DurableStore, GuardSpec,
                               GuardViolation, Monitor, all_finite, chaos,
                               fold_in)
from repro_torch.obs.writers import BufferedWriter, MemoryWriter
from repro_torch.rl.experiment import Experiment, ExperimentSpec, SpecError
from repro_torch.rl.runner import clone_state, state_leaves

_SMALL = dict(num_units=16, num_layers=1, use_ofenet=False, n_core=1,
              n_env=4, total_steps=12, warmup_steps=8, eval_every=3,
              eval_episodes=1, replay_capacity=256, batch_size=16,
              replay_backend="device", loop="scan")
_SRC = str(Path(__file__).resolve().parent.parent / "src")
# the supervisor's runs: the smoke preset on the port's device replay
_SMOKE = ["--override", "replay.backend=device", "--device", "cpu"]


def _small(**overrides):
    return ExperimentSpec().override(**{**_SMALL, **overrides})


def _guarded(policy="halt", **overrides):
    return _small(**{"guard.enabled": True, "guard.policy": policy,
                     **overrides})


def _run(spec, steps):
    exp = Experiment.from_spec(spec, device="cpu")
    exp.run(steps)
    return exp


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(state_leaves(a),
                                                 state_leaves(b))) \
        and torch.equal(a.gen.get_state(), b.gen.get_state())


def _npz_saver(value):
    def save(path):
        np.savez(path, x=np.full(8, value, dtype=np.float32))
    return save


# ------------------------------------------------------------ DurableStore

def test_store_commit_verify_retain_and_abort(tmp_path):
    st = DurableStore(str(tmp_path / "a"), keep=2)
    for s in (10, 20, 30):
        st.save(_npz_saver(s), s)
    assert [DurableStore.step_of(p) for p in st.checkpoints()] == [20, 30]
    for p in st.checkpoints():
        st.verify(p)
    best = st.restore_latest()
    assert DurableStore.step_of(best) == st.latest_step() == 30
    assert np.all(np.load(DurableStore.payload(best))["x"] == 30)
    st._pre_commit_hook = lambda staging: (_ for _ in ()).throw(
        RuntimeError("chaos: die before commit"))
    with pytest.raises(RuntimeError, match="die before commit"):
        st.save(_npz_saver(40), 40)
    st._pre_commit_hook = None
    assert [DurableStore.step_of(p) for p in st.checkpoints()] == [20, 30]
    torn = tmp_path / "a" / "staging-99999-deadbeef"
    torn.mkdir()
    (torn / "state.npz").write_bytes(b"partial garbage")
    assert len(st.checkpoints()) == 2 and st.clean_staging() == 1
    assert not torn.exists()


def test_store_corrupt_fallback_and_exhaustion(tmp_path):
    st = DurableStore(str(tmp_path), keep=5)
    for s in (10, 20, 30):
        st.save(_npz_saver(s), s)
    chaos.corrupt_checkpoint(st.checkpoints()[-1], mode="bitflip")
    bad = []
    assert DurableStore.step_of(st.restore_latest(on_bad=bad.append)) == 20
    assert len(bad) == 1 and isinstance(bad[0], CheckpointCorrupt)
    assert "checksum" in bad[0].reason
    chaos.corrupt_checkpoint(st.checkpoints()[0], mode="truncate")
    chaos.corrupt_checkpoint(st.checkpoints()[1], mode="truncate")
    bad2 = []
    assert st.restore_latest(on_bad=bad2.append) is None
    assert len(bad2) == 3 and "size" in bad2[-1].reason


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_the_others_store(tmp_path, writer):
    from repro.guard import chaos as jchaos
    from repro.guard.store import DurableStore as JStore
    stores = {"jax": (JStore, jchaos), "torch": (DurableStore, chaos)}
    w_store, w_chaos = stores[writer]
    r_store = stores["torch" if writer == "jax" else "jax"][0]
    st = w_store(str(tmp_path), keep=5)
    for s in (6, 12, 18):
        st.save(_npz_saver(s), s)
    w_chaos.corrupt_checkpoint(st.checkpoints()[-1], mode="bitflip")
    other = r_store(str(tmp_path), keep=5)
    assert [p.name for p in other.checkpoints()] == \
        [p.name for p in st.checkpoints()]
    for p in other.checkpoints()[:2]:
        other.verify(p)
    with pytest.raises(Exception, match="checksum"):
        other.verify(other.checkpoints()[-1])
    bad = []
    good = other.restore_latest(on_bad=bad.append)
    assert other.step_of(good) == 12 and len(bad) == 1
    assert np.all(np.load(other.payload(good))["x"] == 12)


# ------------------------------------------------------------------ monitor

def _monitors(**kw):
    from repro.guard.monitor import GuardSpec as JGuardSpec
    from repro.guard.monitor import Monitor as JMonitor
    return (Monitor(GuardSpec(enabled=True, **kw)),
            JMonitor(JGuardSpec(enabled=True, **kw)))


def test_monitor_gives_the_reference_violations():
    rng = np.random.default_rng(0)
    ours, ref = _monitors(spike_factor=4.0, spike_window=16,
                          srank_collapse=0.5)
    seen = []
    for chunk in range(4):
        loss = np.abs(rng.standard_normal(12)).astype(np.float32) + 0.5
        stream = {"critic_loss": loss, "alpha": np.full(12, 0.1, np.float32)}
        if chunk == 1:
            loss[3] = 40.0                        # a spike at step 16
        if chunk == 2:
            stream["alpha"][5] = np.nan           # step 30
            loss[7] = np.inf                      # step 32
        a = [v.as_dict() for v in ours.check_stream(12 * chunk, stream)]
        b = [v.as_dict() for v in ref.check_stream(12 * chunk, stream)]
        assert a == b
        seen += [(v["reason"], v["step"]) for v in a]
    assert list(ours._spike_hist) == list(ref._spike_hist)
    assert seen == [("spike", 16), ("nonfinite_stream", 30),
                    ("nonfinite_stream", 32)]
    assert [v.as_dict() for v in ours.check_scalars(49, {"x": np.nan})] \
        == [v.as_dict() for v in ref.check_scalars(49, {"x": np.nan})]
    for sranks in ([40, 30], [40, 19], [5]):
        assert [v.as_dict() for v in ours.check_srank(50, sranks)] == \
            [v.as_dict() for v in ref.check_srank(50, sranks)]
    assert ours.check_srank(50, [40, 19])[0].reason == "srank_collapse"
    for m in (ours, ref):
        m.spec = type(m.spec)(enabled=True, max_recoveries=1)
        assert m.spend_recovery([]) == 1
    with pytest.raises(GuardViolation, match="budget spent"):
        ours.spend_recovery([])


def test_all_finite_and_fold_in():
    params = {"a": torch.ones(3), "b": [torch.zeros(2, 2)],
              "n": torch.tensor(3)}
    assert all_finite(params)
    params["b"][0][1, 1] = 3e38                  # finite, squares overflow
    assert all_finite(params)
    for bad in (float("nan"), float("inf"), -float("inf")):
        p = {"a": torch.ones(3), "b": torch.tensor([1.0, bad])}
        assert not all_finite(p)
    m = Monitor(GuardSpec(enabled=True))
    assert m.check_params(7, {"a": torch.tensor([float("nan")])})[0].step \
        == 7
    g = torch.Generator().manual_seed(0)
    s0 = g.get_state()
    outs = []
    for ordinal in (1, 1, 2):
        g.set_state(s0)
        fold_in(g, ordinal)
        outs.append(torch.rand(4, generator=g))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    g.set_state(s0)
    assert not torch.equal(outs[0], torch.rand(4, generator=g))


def test_guard_spec_validation():
    with pytest.raises(SpecError, match="policy"):
        _guarded(policy="restart")
    with pytest.raises(SpecError, match="srank"):
        _guarded(**{"guard.srank_collapse": 0.5, "eval.srank_every": 0})
    with pytest.raises(SpecError, match="spike_factor"):
        _guarded(**{"guard.spike_factor": -1.0})
    with pytest.raises(ValueError, match="max_recoveries"):
        GuardSpec(max_recoveries=-1)
    from repro.rl.experiment import ExperimentSpec as JSpec
    spec = _guarded("rollback", **{"guard.spike_factor": 3.0})
    assert JSpec.from_dict(spec.to_dict()).to_dict() == spec.to_dict()


# ------------------------------------------------------- detection + halt

@pytest.mark.parametrize("loop", ["python", "scan"])
def test_guarded_run_is_bitwise_invisible(loop):
    plain = _run(_small(loop=loop), 12)
    guarded = _run(_guarded("halt", loop=loop), 12)
    assert _bitwise(plain._ls, guarded._ls)
    assert plain.returns == guarded.returns


@pytest.mark.parametrize("loop", ["python", "scan"])
def test_halt_reports_exact_detection_step(loop):
    exp = Experiment.from_spec(_guarded("halt", loop=loop), device="cpu")
    chaos.arm_nan_step(exp.trainer, at_step=10)
    with pytest.raises(GuardViolation) as gv:
        exp.run(12)
    viols = gv.value.violations
    assert any(v.reason == "nonfinite_stream" for v in viols)
    # the counter reads at_step once that update retires, so the poisoned
    # superstep is the NEXT one: detection is exact, at step 11
    assert min(v.step for v in viols) == 11
    assert gv.value.recoveries == 0 and gv.value.step == 11


@pytest.mark.parametrize("loop", ["python", "scan"])
def test_persistent_fault_exhausts_recovery_budget(loop):
    exp = Experiment.from_spec(
        _guarded("skip", loop=loop, **{"guard.max_recoveries": 2}),
        device="cpu")
    chaos.arm_nan_step(exp.trainer, at_step=10)
    with pytest.raises(GuardViolation) as gv:
        exp.run(12)
    assert gv.value.recoveries == 2


def test_skip_of_a_transient_fault_is_snapshot_fold_in_and_rerun():
    """A fault that fires once inside a segment (NaN params into the
    superstep from step 7): skip rewinds to the segment's start (6),
    perturbs the generator with ordinal 1 and reruns it clean."""
    spec = _guarded("skip")
    exp = _run(spec, 6)
    snap = clone_state(exp._ls)
    inner, fired = exp.trainer.step, []

    def once(ls, draws=None):
        if int(ls.step) == 7 and not fired:
            fired.append(7)
            params = tree_map(lambda v: torch.full_like(v, float("nan")),
                              ls.agent["params"])
            ls = ls._replace(agent=dict(ls.agent, params=params))
        return inner(ls, draws)
    exp.trainer.step = once
    exp.run(6)                                # detect at 8 -> skip -> 12
    assert fired == [7] and exp.step == 12
    assert exp._monitor.recoveries == 1 and exp.eval_steps == [3, 6, 9, 12]
    assert all_finite(exp._ls.agent["params"])
    ref = Experiment.from_spec(spec, device="cpu")
    ref._ls, ref.step = snap, 6
    fold_in(ref._ls.gen, 1)
    ref.run(6)
    assert _bitwise(exp._ls, ref._ls)
    assert exp.returns[2:] == ref.returns


# ------------------------------------------------- rollback determinism

@pytest.mark.parametrize("loop", ["python", "scan"])
def test_rollback_recovery_is_reconstructible(tmp_path, loop):
    exp = Experiment.from_spec(_guarded("rollback", loop=loop),
                               device="cpu")
    store = DurableStore(str(tmp_path), keep=3)
    exp.attach_guard(store)
    exp.run(6)
    store.save(lambda p: exp.save(p), 6)
    payload = DurableStore.payload(store.checkpoints()[-1])
    chaos.poison_params(exp)                  # transient host fault
    exp.run(6)                                # detect -> rollback -> finish
    assert exp.step == 12 and exp._monitor.recoveries == 1
    assert all_finite(exp._ls.agent["params"])
    # the contract: recovery == restore + fold_in(gen, ordinal) + rerun
    ref = Experiment.restore(payload, device="cpu")
    fold_in(ref._ls.gen, 1)
    ref.run(6)
    assert _bitwise(exp._ls, ref._ls)
    assert exp.returns == ref.returns
    plain = Experiment.restore(payload, device="cpu")
    plain.run(6)                              # without the perturbation
    assert not _bitwise(exp._ls, plain._ls)


def test_rollback_without_store_raises():
    exp = _run(_guarded("rollback"), 6)
    chaos.poison_params(exp)
    with pytest.raises(GuardViolation, match="store"):
        exp.run(6)


# ------------------------------------------------------- BufferedWriter IO

def test_buffered_writer_retries_transient_oserror():
    healthy = MemoryWriter()
    flaky = chaos.FlakySink(MemoryWriter(), fails=2)
    bw = BufferedWriter([flaky, healthy], retries=3, backoff=0.001)
    bw.write([{"kind": "train", "step": 1}])
    bw.drain()
    assert flaky.attempts == 3 and flaky.delivered == 1
    assert len(healthy.rows) == 1
    bw.close()


def test_buffered_writer_surfaces_permanent_oserror_at_drain():
    flaky = chaos.FlakySink(MemoryWriter(), fails=None)
    bw = BufferedWriter([flaky], retries=2, backoff=0.001)
    bw.write([{"kind": "train", "step": 1}])
    with pytest.raises(OSError, match="transient sink IO error"):
        bw.drain()
    assert flaky.attempts == 3


# ------------------------------------------------------------- supervisor

@pytest.fixture
def worker_path(monkeypatch):
    monkeypatch.setenv("PYTHONPATH",
                       _SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))


@pytest.mark.parametrize("fault", ["kill@8", "kill-in-save@8"])
def test_supervisor_sigkill_resume_is_bitwise(tmp_path, worker_path, fault):
    from repro_torch.guard import supervise
    from repro_torch.rl import presets
    run = tmp_path / "run"
    rc = supervise.main(["smoke", "--dir", str(run), "--steps", "12",
                         "--save-every", "4", "--retries", "2",
                         "--backoff", "0.01", "--chaos", fault, *_SMOKE])
    assert rc == 0
    res = json.loads((run / "result.json").read_text())
    inc = json.loads((run / "incident.json").read_text())
    assert res["step"] == 12 and inc["status"] == "ok"
    assert inc["attempts"][0]["signal"] == "SIGKILL"
    assert inc["attempts"][-1]["exit_code"] == 0
    assert res["resumed_from"] == 4          # the segment 4-8 replayed
    assert not list((run / "ckpts").glob("staging-*"))
    ref = Experiment.from_spec(presets.get("smoke").override(
        replay_backend="device"), device="cpu")
    ref.run(12)
    assert res["params_sha256"] == supervise._digest(ref._ls.agent["params"])
    assert res["returns"] == [float(r) for r in ref.returns]


def test_supervisor_budget_spent_writes_incident(tmp_path, worker_path):
    from repro_torch.guard import supervise
    run = tmp_path / "halted"
    rc = supervise.main([
        "smoke", "--dir", str(run), "--steps", "12", "--save-every", "6",
        "--retries", "0", "--backoff", "0.01", "--chaos", "nan@6",
        "--override", "guard.enabled=true",
        "--override", "guard.policy=halt", *_SMOKE])
    assert rc == supervise.EXIT_BUDGET_SPENT
    inc = json.loads((run / "incident.json").read_text())
    assert inc["status"] == "failed"
    att = inc["attempts"][0]
    assert att["exit_code"] == supervise.EXIT_GUARD
    assert any(v["reason"] == "nonfinite_params" for v in att["violations"])


def test_supervisor_rollback_and_fleet_refusal(tmp_path):
    from repro_torch.guard import supervise
    from repro_torch.rl.experiment import SpecError
    # --seeds 2 runs a Fleet (tests/test_torch_sweep_guard.py), which
    # refuses the smoke preset's host replay as the reference's does
    with pytest.raises(SpecError, match="replay.backend"):
        supervise.main(["smoke", "--dir", str(tmp_path), "--seeds", "2",
                        "--device", "cpu", "--worker"])
    rc = supervise.main([
        "smoke", "--dir", str(tmp_path / "rb"), "--steps", "12",
        "--save-every", "6", "--chaos", "nan@6", "--worker",
        "--override", "guard.enabled=true",
        "--override", "guard.policy=rollback", *_SMOKE])
    assert rc == 0
    res = json.loads((tmp_path / "rb" / "result.json").read_text())
    assert res["step"] == 12 and res["recoveries"] == 1


def test_digest_equals_the_references_on_the_same_params():
    import jax
    from repro.guard import supervise as jsupervise
    from repro.rl.experiment import ExperimentSpec as JSpec
    from repro.rl.runner import Trainer as JTrainer
    from repro_torch import convert
    from repro_torch.guard import supervise
    jtr = JTrainer(JSpec().override(**dict(_SMALL, use_ofenet=True,
                                           ofenet_units=8,
                                           ofenet_layers=2)))
    jparams = jtr.init_template().agent["params"]
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    assert supervise._digest(tparams) == jsupervise._digest(jparams)
