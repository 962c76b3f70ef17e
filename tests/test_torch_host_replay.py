"""The port's host replay (``repro_torch.rl.replay``, ``replay.backend=
"host"``) against the JAX package's and its own contracts.

* ``rl/replay.py`` against ``repro.rl.replay``: one seeded sequence of
  adds (duplicates within a refresh, wraparound, ``n_step=3``'s
  ``disc``), samples and priority refreshes through both, equal bit for
  bit (arrays, tree, cursor, indices, weights, the generator's state);
  and the port's copies of ``tests/test_replay.py``'s eight tests.
* One host superstep against the reference's ``Trainer.py_step`` with
  ``replay_backend="host"``: SAC and TD3, ``n_step`` 1 and 3, the port
  fed the draws of the reference's key split and a copy of its buffer
  and NumPy generator; the sampled indices equal, the rest at the
  one-superstep harness's tolerance (``tests/test_torch_train.py``).
* The run's contracts with a host buffer: both loops and any chunking
  bitwise (state, buffer, tree, cursor, NumPy generator);
  ``run(17); save; restore; run(23)`` bitwise ``run(40)``; a JAX
  ``Experiment.save`` of a host run restores with its buffer, tree and
  ``rng_state`` bitwise; obs on or off bitwise; the guard's ``skip``
  rewinds the buffer and the NumPy generator exactly; no staleness keys;
  every host preset and ``ExperimentSpec()`` train as they are; the
  supervisor's ``smoke`` resumes with no override to the uninterrupted
  run's digest; a host checkpoint serves through
  ``Policy.from_checkpoint`` and the ``serve_policy`` CLI.
* On the card (skipped here): the superstep's two CUDA graphs with the
  host buffer between them replay bitwise eager supersteps.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # optional-hypothesis shim
from _transitions import mk_batch

from repro_torch.checkpoint import ckpt
from repro_torch.common import tree_leaves, tree_map
from repro_torch.guard import fold_in
from repro_torch.rl import presets
from repro_torch.rl.envs import EnvState
from repro_torch.rl.experiment import Experiment, ExperimentSpec
from repro_torch.rl.replay import (PrioritizedReplay, SumTree, UniformReplay,
                                   buffer_state, load_buffer_state)
from repro_torch.rl.runner import (TrainLoopState, Trainer, clone_state,
                                   state_leaves)

_BASE = dict(env="pendulum", num_units=16, num_layers=2, use_ofenet=True,
             ofenet_units=8, ofenet_layers=2, n_core=1, n_env=4,
             total_steps=6, warmup_steps=8, eval_every=3, eval_episodes=2,
             replay_capacity=64, batch_size=16, replay_backend="host",
             replay_kernel="xla")
# capacity 64 with 4 rows a superstep: the buffer wraps within 40 steps
_SCAN = dict(_BASE, block_backend="fused", eval_every=10, srank_every=5)
_SRC = str(Path(__file__).resolve().parent.parent / "src")


def _host_equal(a, b):
    """Two ``buffer_state``s bitwise equal (the generator's state too)."""
    return (a["data"].keys() == b["data"].keys()
            and all(np.array_equal(a["data"][k], b["data"][k])
                    for k in a["data"])
            and np.array_equal(a["tree"], b["tree"])
            and (a["ptr"], a["count"], a["max_priority"], a["rng_state"])
            == (b["ptr"], b["count"], b["max_priority"], b["rng_state"]))


def _state_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(state_leaves(a),
                                                 state_leaves(b))) \
        and torch.equal(a.gen.get_state(), b.gen.get_state())


def _run_equal(e1, e2):
    tr1, tr2 = e1.trainer, e2.trainer
    return _state_equal(e1._ls, e2._ls) and _host_equal(
        buffer_state(tr1.buffer, tr1.rng), buffer_state(tr2.buffer, tr2.rng))


# ------------------------------------------------ rl/replay.py, bitwise

@pytest.mark.parametrize("prioritized", [True, False])
@pytest.mark.parametrize("n_step", [1, 3])
def test_host_replay_is_the_reference_bit_for_bit(prioritized, n_step):
    from repro.rl import replay as jreplay
    cls = "PrioritizedReplay" if prioritized else "UniformReplay"
    ref = getattr(jreplay, cls)(50, 3, 2, n_step=n_step)
    port = (PrioritizedReplay if prioritized else UniformReplay)(
        50, 3, 2, n_step=n_step)
    rng_r, rng_p = np.random.default_rng(7), np.random.default_rng(7)
    data = np.random.default_rng(11)
    for i in range(12):                      # 12 x 9 rows: wraps twice
        batch = mk_batch(9, seed=i)
        if n_step > 1:
            batch["disc"] = data.uniform(0, 1, 9).astype(np.float32)
        ref.add_batch(batch)
        port.add_batch(batch)
        out_r, idx_r, w_r = ref.sample(16, rng_r)
        out_p, idx_p, w_p = port.sample(16, rng_p)
        np.testing.assert_array_equal(idx_p, idx_r)
        np.testing.assert_array_equal(w_p, w_r)
        assert w_p.dtype == w_r.dtype
        assert out_p.keys() == out_r.keys()
        for k in out_r:
            np.testing.assert_array_equal(out_p[k], out_r[k])
        # duplicates in one refresh: the last value wins in both
        idx = np.concatenate([idx_r, idx_r[:4]])
        pr = data.exponential(1.0, idx.shape)
        ref.update_priorities(idx, pr)
        port.update_priorities(idx, pr)
        assert _host_equal(buffer_state(port, rng_p),
                           buffer_state(ref, rng_r))
    assert ("disc" in getattr(port, "_inner", port).data) == (n_step > 1)


def test_buffer_state_round_trips_into_a_fresh_buffer():
    buf, rng = PrioritizedReplay(16, 3, 2), np.random.default_rng(0)
    buf.add_batch(mk_batch(20))
    buf.update_priorities(np.arange(5), np.arange(5.0))
    rng.uniform(size=3)
    snap = buffer_state(buf, rng)
    other = PrioritizedReplay(16, 3, 2)
    rng2 = load_buffer_state(other, snap)
    assert _host_equal(buffer_state(other, rng2), snap)
    assert rng2.uniform() == rng.uniform()
    buf.add_batch(mk_batch(3, seed=1))       # the snapshot is a copy
    assert not _host_equal(buffer_state(buf, rng), snap)


# ------------------------- the port's copies of tests/test_replay.py

@given(st.integers(min_value=1, max_value=500),
       st.lists(st.floats(min_value=0.01, max_value=100.0),
                min_size=1, max_size=50))
@settings(max_examples=50, deadline=None)
def test_sumtree_total_invariant(capacity, values):
    tree = SumTree(capacity)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, capacity, size=len(values))
    for i, v in zip(idx, values):
        tree.set(np.array([i]), np.array([v]))
    leaves = tree.tree[tree.size // 2: tree.size // 2 + capacity]
    assert np.isclose(tree.total, leaves.sum(), rtol=1e-9)


@given(st.integers(min_value=2, max_value=200))
@settings(max_examples=30, deadline=None)
def test_sumtree_sample_respects_mass(capacity):
    tree = SumTree(capacity)
    rng = np.random.default_rng(1)
    pr = rng.uniform(0.0, 1.0, capacity)
    pr[rng.integers(0, capacity, capacity // 2)] = 0.0
    tree.set(np.arange(capacity), pr)
    if tree.total == 0:
        return
    targets = rng.uniform(0, tree.total, size=256) * (1 - 1e-12)
    leaves = tree.sample(targets)
    assert (leaves >= 0).all() and (leaves < capacity).all()
    assert (pr[leaves] > 0).all()


def test_sumtree_sampling_proportional():
    tree = SumTree(4)
    tree.set(np.arange(4), np.array([1.0, 2.0, 3.0, 4.0]))
    rng = np.random.default_rng(2)
    targets = rng.uniform(0, tree.total, size=200_000)
    counts = np.bincount(tree.sample(targets), minlength=4)
    np.testing.assert_allclose(counts / counts.sum(),
                               np.array([1, 2, 3, 4]) / 10, atol=0.01)


def test_sumtree_sample_target_equal_total_stays_in_range():
    capacity = 5
    tree = SumTree(capacity)
    tree.set(np.arange(capacity), np.array([1.0, 2.0, 3.0, 4.0, 5.0]))
    leaves = tree.sample(np.array([tree.total, tree.total - 1e-13,
                                   np.nextafter(tree.total, np.inf)]))
    assert (leaves >= 0).all() and (leaves < capacity).all()
    assert leaves[0] == capacity - 1


@given(st.integers(min_value=1, max_value=64),
       st.integers(min_value=16, max_value=128))
@settings(max_examples=20, deadline=None)
def test_replay_roundtrip(n_add, capacity):
    buf = PrioritizedReplay(capacity, 3, 2)
    buf.add_batch(mk_batch(n_add))
    assert len(buf) == min(n_add, capacity)
    rng = np.random.default_rng(3)
    out, idx, w = buf.sample(8, rng)
    assert out["obs"].shape == (8, 3)
    assert (w > 0).all() and (w <= 1.0 + 1e-6).all()
    buf.update_priorities(idx, np.abs(rng.normal(size=8)))
    out2, _, _ = buf.sample(8, rng)
    assert np.isfinite(out2["rew"]).all()


def test_replay_wraparound_overwrites_oldest():
    buf = PrioritizedReplay(8, 3, 2)
    b1 = mk_batch(8, seed=1)
    buf.add_batch(b1)
    b2 = mk_batch(4, seed=2)
    buf.add_batch(b2)
    assert len(buf) == 8
    np.testing.assert_array_equal(buf.data["obs"][:4], b2["obs"])
    np.testing.assert_array_equal(buf.data["obs"][4:], b1["obs"][4:])


def test_prioritized_focuses_high_td():
    buf = PrioritizedReplay(100, 3, 2, alpha=1.0)
    buf.add_batch(mk_batch(100))
    pr = np.full(100, 1e-3)
    pr[7] = 10.0
    buf.update_priorities(np.arange(100), pr)
    rng = np.random.default_rng(4)
    hits = 0
    for _ in range(50):
        _, idx, _ = buf.sample(16, rng)
        hits += (idx == 7).sum()
    assert hits > 200      # ~>25% of 800 draws go to the hot index


def test_uniform_replay_is_uniform():
    buf = UniformReplay(64, 3, 2)
    buf.add_batch(mk_batch(64))
    rng = np.random.default_rng(5)
    _, idx, w = buf.sample(32, rng)
    assert (w == 1.0).all()
    assert idx.min() >= 0 and idx.max() < 64


# -------------------------------- one superstep against py_step (host)

def _close(a, b, rtol, what):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-12),
                               err_msg=what)


def _recording(buf):
    """Wrap ``buf.sample`` to keep the indices it returns."""
    seen, inner = [], buf.sample

    def sample(*a):
        out = inner(*a)
        seen.append(np.array(out[1]))
        return out
    buf.sample = sample
    return seen


@pytest.mark.parametrize("algo,n_step,backend", [
    pytest.param("sac", 1, "fused", id="sac-1"),
    pytest.param("sac", 3, "jnp", id="sac-3"),
    pytest.param("td3", 1, "jnp", id="td3-1"),
    pytest.param("td3", 3, "fused", id="td3-3")])
def test_host_superstep_matches_jax_py_step(algo, n_step, backend):
    from test_torch_train import _np, jax_superstep_draws
    from repro.rl.experiment import ExperimentSpec as JSpec
    from repro.rl.runner import Trainer as JTrainer
    from repro_torch import convert
    over = dict(_BASE, algo=algo, n_step=n_step, block_backend=backend)
    jtr = JTrainer(JSpec().override(**over))
    jls = jtr.init()
    ttr = Trainer(ExperimentSpec().override(**over), device="cpu")
    ttr.rng = load_buffer_state(ttr.buffer, buffer_state(jtr.buffer,
                                                         jtr.rng))
    t = lambda tree: convert.params_from_numpy(_np(tree), device="cpu")
    tls = TrainLoopState(
        t(jls.agent), EnvState(*(torch.from_numpy(np.array(a)) for a in
                                 (jls.actors.q, jls.actors.qd,
                                  jls.actors.t))),
        t(jls.nstep) if n_step > 1 else None,
        torch.from_numpy(np.array(jls.replay)), torch.Generator(),
        torch.tensor(int(jls.step), dtype=torch.int32))
    assert tls.replay.dtype == torch.int32 and tls.replay.ndim == 0
    draws = jax_superstep_draws(jtr, jls.key)
    del draws["u"]                      # the host sampler draws from rng
    j_idx, t_idx = _recording(jtr.buffer), _recording(ttr.buffer)
    jls2, jm, jb = jtr.py_step(jls)
    tls2, tm, tb = ttr.step(tls, draws)
    np.testing.assert_array_equal(t_idx[0], j_idx[0])
    assert ttr.rng.bit_generator.state == jtr.rng.bit_generator.state
    j = _np(jls2)
    for a, b in zip(tree_leaves(tls2.agent["params"]),
                    tree_leaves(j.agent["params"])):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    for name in j.agent["opt"]:
        for part in ("mu", "nu"):
            for a, b in zip(tree_leaves(tls2.agent["opt"][name][part]),
                            tree_leaves(j.agent["opt"][name][part])):
                _close(a.numpy(), b, 1e-3, f"opt/{name}/{part}")
    _close(tls2.actors.q.numpy(), j.actors.q, 1e-5, "actors.q")
    np.testing.assert_array_equal(tls2.actors.t.numpy(), j.actors.t)
    if n_step > 1:
        for k in j.nstep:
            _close(tls2.nstep[k].numpy(), j.nstep[k], 1e-5, f"nstep/{k}")
    hj = buffer_state(jtr.buffer, jtr.rng)
    ht = buffer_state(ttr.buffer, ttr.rng)
    assert (ht["ptr"], ht["count"]) == (hj["ptr"], hj["count"])
    assert set(ht["data"]) == set(hj["data"])
    for k in hj["data"]:
        _close(ht["data"][k], hj["data"][k], 1e-5, f"buffer/{k}")
    _close(ht["tree"], hj["tree"], 1e-4, "tree")
    _close(ht["max_priority"], hj["max_priority"], 1e-4, "max_priority")
    _close(tm["priorities"].numpy(), np.asarray(jm["priorities"]), 1e-3,
           "priorities")
    np.testing.assert_array_equal(tb["weight"].numpy(),
                                  np.asarray(jb["weight"]))
    assert set(tb) == set(jb)
    for k in jb:
        _close(tb[k].numpy(), np.asarray(jb[k]), 1e-5, f"batch/{k}")
    assert int(tls2.step) == int(j.step) == 1
    assert torch.equal(tls2.replay, tls.replay)
    assert not {k for k in tm if k.startswith("staleness")}
    assert set(tm) == set(jm)


# ------------------------------------------------ the run's contracts

def _exp(loop, **kw):
    return Experiment.from_spec(ExperimentSpec().override(**dict(
        _SCAN, loop=loop, **kw)), device="cpu")


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_host_loops_and_chunkings_are_bitwise(algo):
    split, whole, py = _exp("scan", algo=algo), _exp("scan", algo=algo), \
        _exp("python", algo=algo)
    split.run(17)
    rs = split.run(23, keep_last=True)
    for other in (whole, py):
        r = other.run(40, keep_last=True)
        assert _run_equal(split, other)
        assert rs.returns == r.returns and rs.sranks == r.sranks
        assert rs.eval_steps == r.eval_steps == [10, 20, 30, 40]
        assert rs.metrics == r.metrics
        np.testing.assert_array_equal(rs.last_priorities, r.last_priorities)
        for k, v in rs.last_batch.items():
            assert torch.equal(v, r.last_batch[k]), k
    assert split.trainer.buffer.count == 64          # wrapped
    assert set(rs.last_batch) == {"obs", "act", "rew", "next_obs", "done",
                                  "weight"}
    assert not {k for k in rs.metrics if k.startswith("staleness")}


@pytest.mark.parametrize("loop,n_step,algo", [("scan", 3, "sac"),
                                              ("python", 1, "td3"),
                                              ("python", 3, "sac"),
                                              ("scan", 1, "td3")])
def test_host_save_restore_mid_period_is_bitwise_the_uninterrupted_run(
        tmp_path, loop, n_step, algo):
    spec = ExperimentSpec().override(**dict(_SCAN, loop=loop,
                                            n_step=n_step, algo=algo))
    first = Experiment.from_spec(spec, device="cpu")
    first.run(17)
    path = str(tmp_path / "run.npz")
    first.save(path)
    names = ckpt.leaf_names(path)
    fields = ["act", "done", "next_obs", "obs", "rew"] + (
        ["disc"] if n_step > 1 else [])
    assert {f"host/data/{k}" for k in fields} | {"host/tree",
                                                 "loop/.replay"} \
        <= set(names)
    assert ("host/data/disc" in names) == (n_step > 1)
    meta = ckpt.load_metadata(path)["experiment"]["buffer"]
    assert set(meta) == {"ptr", "count", "max_priority", "rng_state"}
    resumed = Experiment.restore(path, device="cpu")
    assert _run_equal(resumed, first)
    rr = resumed.run(23, keep_last=True)
    whole = Experiment.from_spec(spec, device="cpu")
    rw = whole.run(40, keep_last=True)
    assert _run_equal(resumed, whole)
    assert rr.returns == rw.returns and rr.sranks == rw.sranks
    assert rr.eval_steps == rw.eval_steps == [10, 20, 30, 40]
    assert rr.metrics == rw.metrics


@pytest.mark.parametrize("prioritized", [True, False])
def test_jax_host_checkpoint_restores_with_buffer_and_rng_bitwise(
        tmp_path, prioritized):
    from repro.rl.experiment import Experiment as JExperiment
    from repro.rl.experiment import ExperimentSpec as JSpec
    over = dict(_BASE, n_step=3, block_backend="jnp",
                prioritized=prioritized)
    jexp = JExperiment.from_spec(JSpec().override(**over))
    jexp.run(4)
    path = str(tmp_path / "jax.npz")
    jexp.save(path)
    texp = Experiment.restore(path, device="cpu")
    assert texp.spec.to_dict() == jexp.spec.to_dict()
    assert texp.step == 4 and texp.returns == jexp.returns
    jb, tr = jexp.trainer.buffer, texp.trainer
    assert _host_equal(buffer_state(tr.buffer, tr.rng),
                       buffer_state(jb, jexp.trainer.rng))
    with np.load(path) as data:
        saved = {k: data[k] for k in data.files}
    got = dict(ckpt._leaves({"loop": texp._ls._replace(gen=None)}))
    jax_only = {k for k in saved if k.endswith(".key")} | {ckpt.META_KEY}
    host = {k for k in saved if k.startswith("host/")}
    assert set(got) == set(saved) - jax_only - host
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), saved[k], err_msg=k)
        assert t.numpy().dtype == saved[k].dtype, k
    # the next sample draws what the reference's would
    a = tr.buffer.sample(16, tr.rng)[1]
    b = jb.sample(16, jexp.trainer.rng)[1]
    np.testing.assert_array_equal(a, b)
    res = texp.run(2)
    assert texp.step == 6 and res.eval_steps == [3, 6]
    assert np.isfinite(res.metrics["critic_loss"])


@pytest.mark.parametrize("loop", ["python", "scan"])
def test_host_obs_stream_is_bitwise_invisible(loop, tmp_path):
    base = dict(_BASE, loop=loop, total_steps=12)
    off = Experiment.from_spec(ExperimentSpec().override(**base),
                               device="cpu")
    r_off = off.run(eval_at_end=True, keep_last=True)
    exp = Experiment.from_spec(ExperimentSpec().override(
        **base, **{"obs.enabled": True, "obs.sinks": ("jsonl", "memory"),
                   "obs.log_dir": str(tmp_path), "obs.log_every": 1}),
        device="cpu")
    r_on = exp.run(eval_at_end=True, keep_last=True)
    assert _run_equal(off, exp)
    assert r_on.returns == r_off.returns
    np.testing.assert_array_equal(r_on.last_priorities, r_off.last_priorities)
    train = [r for r in exp.obs.rows if r["kind"] == "train"]
    assert [r["step"] for r in train] == list(range(1, 13))
    assert not any(k.startswith("staleness") for r in train for k in r)
    exp.close()


@pytest.mark.parametrize("loop", ["python", "scan"])
def test_guard_skip_rewinds_the_host_buffer_and_numpy_generator(loop):
    """NaN params into the segment's last superstep (ls.step 8), whose
    refresh writes NaN priorities into the host tree (the next sample
    would raise): skip rewinds to the segment's start (6), with the
    buffer, tree, cursor and NumPy generator as they were there, perturbs
    only the torch generator, and reruns."""
    spec = ExperimentSpec().override(**dict(
        _BASE, loop=loop, total_steps=12, **{"guard.enabled": True,
                                             "guard.policy": "skip"}))
    exp = Experiment.from_spec(spec, device="cpu")
    exp.run(6)
    snap = clone_state(exp._ls)
    host = buffer_state(exp.trainer.buffer, exp.trainer.rng)
    inner, fired = exp.trainer.step, []

    def once(ls, draws=None):
        if int(ls.step) == 8 and not fired:
            fired.append(8)
            params = tree_map(lambda v: torch.full_like(v, float("nan")),
                              ls.agent["params"])
            ls = ls._replace(agent=dict(ls.agent, params=params))
        return inner(ls, draws)
    exp.trainer.step = once
    exp.run(6)
    assert fired == [8] and exp.step == 12
    assert exp._monitor.recoveries == 1
    ref = Experiment.from_spec(spec, device="cpu")
    ref._ls, ref.step = snap, 6
    ref.trainer.rng = load_buffer_state(ref.trainer.buffer, host)
    fold_in(ref._ls.gen, 1)
    ref.run(6)
    assert _run_equal(exp, ref)
    assert exp.returns[2:] == ref.returns


@pytest.mark.parametrize("name", [n for n in presets.names()
                                  if presets.get(n).replay.backend == "host"])
def test_every_host_preset_trains_as_it_is(name):
    spec = presets.get(name)
    assert spec.replay.kernel == "xla"
    exp = Experiment.from_spec(spec.override(
        warmup_steps=2 * spec.execution.n_actors, eval_every=2,
        eval_episodes=1, replay_capacity=512, batch_size=16), device="cpu")
    res = exp.run(2)
    assert res.eval_steps == [2] and np.isfinite(res.returns).all()
    assert not {k for k in res.metrics if k.startswith("staleness")}
    assert exp.trainer.buffer.count == 4 * spec.execution.n_actors


def test_default_spec_trains_on_the_host_replay():
    spec = ExperimentSpec()
    assert spec.replay.backend == "host"
    exp = Experiment.from_spec(spec.override(
        warmup_steps=16, eval_every=1, eval_episodes=1, batch_size=16,
        replay_capacity=256), device="cpu")
    assert np.isfinite(exp.run(1).returns).all()
    assert isinstance(exp.trainer.buffer, PrioritizedReplay)
    uni = Trainer(spec.override(prioritized=False), device="cpu")
    assert isinstance(uni.buffer, UniformReplay)


def test_host_checkpoint_serves_through_policy_from_checkpoint(tmp_path):
    from repro_torch.rl.policy import Policy
    exp = Experiment.from_spec(ExperimentSpec().override(**_BASE),
                               device="cpu")
    exp.run(3)
    path = str(tmp_path / "host.npz")
    exp.save(path)
    pol = Policy.from_checkpoint(path, device="cpu")
    for a, b in zip(tree_leaves(pol.params),
                    tree_leaves(exp._ls.agent["params"])):
        assert torch.equal(a, b)
    obs = np.random.default_rng(0).standard_normal((5, 3)).astype(
        np.float32)
    assert torch.equal(pol.act_deterministic(obs),
                       exp.policy().act_deterministic(obs))


@pytest.fixture
def worker_path(monkeypatch):
    monkeypatch.setenv("PYTHONPATH",
                       _SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))


def test_supervisor_smoke_with_no_override_resumes_bitwise(
        tmp_path, worker_path, capsys):
    from repro_torch.guard import supervise
    from repro_torch.launch import serve_policy
    run = tmp_path / "run"
    rc = supervise.main(["smoke", "--dir", str(run), "--steps", "12",
                         "--save-every", "4", "--retries", "2",
                         "--backoff", "0.01", "--chaos", "kill-in-save@8",
                         "--device", "cpu"])
    assert rc == 0
    res = json.loads((run / "result.json").read_text())
    inc = json.loads((run / "incident.json").read_text())
    assert res["step"] == 12 and inc["status"] == "ok"
    assert inc["attempts"][0]["signal"] == "SIGKILL"
    assert res["resumed_from"] == 4
    ref = Experiment.from_spec(presets.get("smoke"), device="cpu")
    assert ref.trainer.buffer is not None
    ref.run(12)
    assert res["params_sha256"] == supervise._digest(ref._ls.agent["params"])
    assert res["returns"] == [float(r) for r in ref.returns]
    # the serving CLI on the store of host checkpoints, and training one
    capsys.readouterr()
    assert serve_policy.main(["smoke", "--ckpt-dir", str(run / "ckpts"),
                              "--requests", "16", "--clients", "2",
                              "--device", "cpu"]) == 0
    assert serve_policy.main(["smoke", "--ckpt-dir", str(tmp_path / "srv"),
                              "--train", "3", "--requests", "16",
                              "--clients", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("16 requests / 2 clients") == 2
    assert "committed checkpoint step-3" in out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs capture CUDA kernels")
    return torch.device("cuda")


def test_cuda_host_graphs_replay_bitwise_eager_supersteps(cuda_device):
    spec = ExperimentSpec().override(**dict(_SCAN, loop="scan"))
    tr = Trainer(spec, device=cuda_device)
    ls = tr.init()
    host0 = buffer_state(tr.buffer, tr.rng)
    eager, graph = clone_state(ls), clone_state(ls)
    for _ in range(6):
        eager, _, _ = tr.step(eager)
    host_eager = buffer_state(tr.buffer, tr.rng)
    tr.rng = load_buffer_state(tr.buffer, host0)
    graph, _ = tr.chunk_fn(2, False)(graph)       # capture: warm-up + 1
    graph, _ = tr.chunk_fn(4, False)(graph)
    torch.cuda.synchronize()
    assert _state_equal(graph, eager)
    assert _host_equal(buffer_state(tr.buffer, tr.rng), host_eager)
    assert tr.graph.host and tr.captures == 1
