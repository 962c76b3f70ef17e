"""The port's training loop against the JAX reference.

* One superstep: the reference's ``Trainer`` warms up and hands its
  ``TrainLoopState`` over (``convert.params_from_numpy``); the port's
  ``Trainer.step`` from that state, fed the draws the reference's
  ``_device_step`` makes from its key (``key, kc, ks, ku = split(key, 4)``:
  policy noise and resets from ``kc``, the stratified uniforms from
  ``ks``, the update's two Gaussians from ``ku``), must give the
  reference's params, AdamW state, actors, replay store, sum-tree,
  ``max_priority``, ``add_step`` stamps and learner step. Device replay
  with the pallas sum-tree (interpret mode in the reference), OFENet on,
  fused and jnp blocks, n_step 1 and 3. Tolerances as in
  ``test_torch_sac.py``; the tree holds new priorities, rtol 1e-4.
* ``Experiment.from_spec(...).run(steps)`` on ``device="cpu"`` finishes
  with finite losses, evaluates at multiples of ``eval.every``, returns a
  ``RunResult``; ``Policy.from_experiment`` acts.
* ``execution.loop="scan"`` (``Trainer.chunk_fn``; eager on the CPU):
  a run in chunks (17 + 23 supersteps) is bitwise one call of 40 and the
  ``loop="python"`` run, eval at multiples of 10 and srank at multiples of
  5 in both loops; the eval steps and the number of sranks are the
  reference's scan loop on the same spec (the values differ: the random
  streams do, ROADMAP C4). On the card (skipped here) the graph's replays
  are bitwise the eager supersteps.
* What the port does not have raises at once, naming its ROADMAP item
  (also under obs, which is ported); the presets that take the effective
  rank build a ``Trainer``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.rl.experiment import ExperimentSpec as JSpec
from repro.rl.runner import Trainer as JTrainer
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.common import tree_leaves
from repro_torch.rl.envs import EnvState
from repro_torch.rl.experiment import (Experiment, ExperimentSpec as TSpec,
                                      resume_seed)
from repro_torch.rl.policy import Policy
from repro_torch.rl import presets as tpresets
from repro_torch.rl.runner import (TrainLoopState, Trainer, UnportedError,
                                   _copy_into, clone_state, median,
                                   state_leaves)

_BASE = dict(env="pendulum", num_units=16, num_layers=2, use_ofenet=True,
             ofenet_units=8, ofenet_layers=2, n_core=1, n_env=4,
             total_steps=6, warmup_steps=8, eval_every=3, eval_episodes=2,
             replay_capacity=64, batch_size=16, replay_backend="device",
             replay_kernel="pallas")


def _np(tree):
    """Arrays as numpy; PRNG keys (the reference's, not ported) as None."""
    return jax.tree_util.tree_map(
        lambda x: None if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)
        else np.asarray(x), tree)


def _port_state(jls, n_step):
    t = lambda tree: convert.params_from_numpy(_np(tree), device="cpu")
    actors = EnvState(*(torch.from_numpy(np.array(a)) for a in
                        (jls.actors.q, jls.actors.qd, jls.actors.t)))
    return TrainLoopState(t(jls.agent), actors,
                          t(jls.nstep) if n_step > 1 else None,
                          t(jls.replay), torch.Generator(),
                          torch.tensor(int(jls.step), dtype=torch.int32))


def jax_superstep_draws(jtr, key):
    """The draws of ``_device_step`` from ``key``, as the port takes them."""
    _, kc, ks, ku = jax.random.split(key, 4)
    env, n, a = jtr.env, jtr.n_actors, jtr.env.act_dim
    (k,) = jax.random.split(kc, 1)
    resets = []
    for rk in jax.random.split(k, n):
        k1, k2, _ = jax.random.split(rk, 3)       # pendulum's reset
        resets.append([float(jax.random.uniform(k1, ())),
                       float(jax.random.uniform(k2, ()))])
    f = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    draws = {"collect": {"noise": f(jax.random.normal(k, (n, a)))[None],
                         "reset": f(resets)[None]},
             "u": f(jax.random.uniform(ks, (jtr.batch_size,)))}
    if jtr.spec.algo == "td3":          # td3_update: normal(ku, a.shape)
        draws["noise"] = f(jax.random.normal(ku, (jtr.batch_size, a)))
    else:                               # sac_update: k1, k2 = split(ku)
        k1, k2 = jax.random.split(ku)
        draws["eps1"] = f(jax.random.normal(k1, (jtr.batch_size, a)))
        draws["eps2"] = f(jax.random.normal(k2, (jtr.batch_size, a)))
    return draws


def _close(a, b, rtol, what):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-12),
                               err_msg=what)


@pytest.mark.parametrize("backend,n_step,algo", [
    pytest.param("fused", 1, "sac", id="fused-1"),
    pytest.param("jnp", 3, "sac", id="jnp-3"),
    pytest.param("fused", 3, "td3", id="td3-fused-3"),
    pytest.param("jnp", 1, "td3", id="td3-jnp-1")])
def test_superstep_matches_jax_device_step(backend, n_step, algo):
    over = dict(_BASE, block_backend=backend, n_step=n_step, algo=algo)
    jtr = JTrainer(JSpec().override(**over))
    jls = jtr.init()
    tls = _port_state(jls, n_step)
    draws = jax_superstep_draws(jtr, jls.key)
    jls2, _, _ = jtr.py_step(jls)
    ttr = Trainer(TSpec().override(**over), device="cpu")
    tls2, tm, _ = ttr.step(tls, draws)
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
    rs, jr = tls2.replay, j.replay
    for k in jr["store"]["data"]:
        _close(rs["store"]["data"][k].numpy(), jr["store"]["data"][k], 1e-5,
               f"store/{k}")
    assert int(rs["store"]["ptr"]) == int(jr["store"]["ptr"])
    assert int(rs["store"]["count"]) == int(jr["store"]["count"])
    _close(rs["tree"].numpy(), jr["tree"], 1e-4, "tree")
    _close(rs["max_priority"].numpy(), jr["max_priority"], 1e-4,
           "max_priority")
    np.testing.assert_array_equal(rs["add_step"].numpy(), jr["add_step"])
    assert int(tls2.step) == int(j.step) == 1
    if n_step > 1:
        for k in j.nstep:
            _close(tls2.nstep[k].numpy(), j.nstep[k], 1e-5, f"nstep/{k}")
    for k in ("critic_loss", "actor_loss", "td_error", "staleness_p50"):
        assert np.isfinite(float(tm[k]))


def test_median_averages_the_middle_pair():
    import jax.numpy as jnp
    x = np.array([3.0, 1.0, 4.0, 2.0], np.float32)
    assert float(median(torch.from_numpy(x))) == float(jnp.median(x)) == 2.5
    assert float(median(torch.tensor([5.0, 1.0, 3.0]))) == 3.0


def test_experiment_runs_and_serves_on_cpu():
    spec = TSpec().override(**dict(_BASE, block_backend="fused"))
    exp = Experiment.from_spec(spec, device="cpu")
    seen = []
    res = exp.run(4, progress=lambda step, ret, scal: seen.append(step))
    res = exp.run(1, eval_at_end=True)
    res = exp.run(1, keep_last=True)
    assert res.eval_steps == [3, 5, 6] and len(res.returns) == 3
    assert seen == [3]
    assert res.last_priorities.shape == (16,) and res.state is not None
    assert all(np.isfinite(res.returns))
    for k in ("critic_loss", "actor_loss", "aux_loss", "alpha",
              "staleness_mean"):
        assert np.isfinite(res.metrics[k]), k
    assert res.param_count > 0 and exp.step == 6
    assert len(list(exp.metrics())) == 3
    replay = exp._ls.replay
    assert int(replay["store"]["count"]) == 8 + 6 * 4
    leaves = replay["tree"][replay["tree"].shape[0] // 2:]
    np.testing.assert_allclose(float(replay["tree"][1]),
                               float(leaves.sum()), rtol=1e-5)
    pol = exp.policy()
    assert isinstance(pol, Policy)
    a = pol.act_deterministic(np.zeros((5, 3), np.float32))
    assert a.shape == (5, 1) and torch.all(a.abs() <= 1)
    assert Policy.from_experiment(exp).params is exp._ls.agent["params"]


# ids as they were when td3 (A.1, now ported) was the first case; obs
# (A.5) and the guard (A.4) are ported, and the obs case now holds that a
# mesh still refuses with it; the host replay (A.6) is ported, its cases
# gone with its refusal (tests/test_torch_host_replay.py trains it)
@pytest.mark.parametrize("over,item", [
    ({"obs.enabled": True, "execution.mesh_shards": 2,
      "execution.loop": "scan"}, "A.8"),
    ({"execution.mesh_shards": 2, "execution.loop": "scan"}, "A.8")],
    ids=["over3-obs-A.8", "over4-A.8"])
def test_unported_choices_raise_with_their_roadmap_item(over, item):
    spec = TSpec().override(**dict(_BASE, **over))
    with pytest.raises(UnportedError, match=item):
        Experiment.from_spec(spec, device="cpu")


def test_td3_trains_on_cpu():
    spec = TSpec().override(**dict(_BASE, algo="td3", block_backend="fused"))
    res = Experiment.from_spec(spec, device="cpu").run(6, keep_last=True)
    assert res.eval_steps == [3, 6] and all(np.isfinite(res.returns))
    for k in ("critic_loss", "actor_loss", "aux_loss", "q_mean",
              "staleness_mean"):
        assert np.isfinite(res.metrics[k]), k
    assert "alpha" not in res.metrics
    assert int(res.state["step"]) == 6
    assert int(res.state["opt"]["actor"]["count"]) == 3      # steps 0, 2, 4
    assert int(res.state["opt"]["critics"]["count"]) == 6


def test_save_restore_not_ported_and_device_rule():
    spec = TSpec().override(**_BASE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Experiment.from_spec(spec)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Experiment.from_spec(spec, device="cuda")


_SCAN = dict(_BASE, block_backend="fused", eval_every=10, srank_every=5)


def _bitwise(a, b, what):
    la, lb = state_leaves(a), state_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{what}: state tensor {i} differs"
    assert torch.equal(a.gen.get_state(), b.gen.get_state()), what


def _chunks_are_bitwise_one_call_and_the_python_loop(algo):
    def exp(loop):
        return Experiment.from_spec(TSpec().override(**dict(
            _SCAN, loop=loop, algo=algo)), device="cpu")
    split, whole, py = exp("scan"), exp("scan"), exp("python")
    split.run(17)
    rs = split.run(23, keep_last=True)
    rw = whole.run(40, keep_last=True)
    rp = py.run(40, keep_last=True)
    for other, r, what in ((whole, rw, "one call"), (py, rp, "python")):
        _bitwise(split._ls, other._ls, what)
        assert rs.returns == r.returns and rs.sranks == r.sranks, what
        assert rs.eval_steps == r.eval_steps == [10, 20, 30, 40], what
        assert rs.metrics == r.metrics, what
        np.testing.assert_array_equal(rs.last_priorities, r.last_priorities)
        for k, v in rs.last_batch.items():
            assert torch.equal(v, r.last_batch[k]), k
    assert len(rs.sranks) == 8 and all(1 <= s <= 16 for s in rs.sranks)


def test_scan_chunks_are_bitwise_one_call_and_the_python_loop():
    _chunks_are_bitwise_one_call_and_the_python_loop("sac")


def test_td3_scan_chunks_are_bitwise_one_call_and_the_python_loop():
    _chunks_are_bitwise_one_call_and_the_python_loop("td3")


@pytest.mark.parametrize("n_step", [1, 3])
@pytest.mark.parametrize("loop", ["scan", "python"])
@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_save_restore_mid_period_is_bitwise_the_uninterrupted_run(
        tmp_path, algo, loop, n_step):
    spec = TSpec().override(**dict(_SCAN, algo=algo, loop=loop,
                                   n_step=n_step))
    first = Experiment.from_spec(spec, device="cpu")
    first.run(17)
    path = str(tmp_path / "run.npz")
    first.save(path)
    names = ckpt.leaf_names(path)
    assert "loop/.gen" in names and "loop/.step" in names
    assert ("loop/.nstep/t" in names) == (n_step > 1)
    resumed = Experiment.restore(path, device="cpu")
    assert resumed.spec == spec and resumed.step == 17
    assert resumed._ls.gen.device.type == "cpu"
    _bitwise(resumed._ls, first._ls, "restored")
    rr = resumed.run(23, keep_last=True)
    whole = Experiment.from_spec(spec, device="cpu")
    rw = whole.run(40, keep_last=True)
    _bitwise(resumed._ls, whole._ls, "17 + save/restore + 23 vs 40")
    assert rr.returns == rw.returns and rr.eval_steps == rw.eval_steps \
        == [10, 20, 30, 40]
    assert rr.sranks == rw.sranks and len(rr.sranks) == 8
    assert rr.metrics == rw.metrics and rr.param_count == rw.param_count
    assert list(resumed.metrics()) == list(whole.metrics())


@pytest.mark.parametrize("algo,n_step", [("sac", 3), ("td3", 1)])
def test_jax_checkpoint_restores_with_every_shared_leaf_equal(
        tmp_path, algo, n_step):
    from repro.rl.experiment import Experiment as JExperiment
    over = dict(_BASE, algo=algo, n_step=n_step, block_backend="jnp")
    jexp = JExperiment.from_spec(JSpec().override(**over))
    jexp.run(4)
    path = str(tmp_path / "jax.npz")
    jexp.save(path)
    texp = Experiment.restore(path, device="cpu")
    assert texp.spec.to_dict() == jexp.spec.to_dict()
    assert texp.step == 4 and texp.returns == jexp.returns
    assert texp.eval_steps == jexp.eval_steps == [3]
    with np.load(path) as data:
        saved = {k: data[k] for k in data.files}
    got = dict(ckpt._leaves({"loop": texp._ls._replace(gen=None)}))
    jax_only = {k for k in saved if k.endswith(".key")} | {ckpt.META_KEY}
    assert set(got) == set(saved) - jax_only
    assert {"loop/.key", "loop/.actors/.key"} <= jax_only
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), saved[k], err_msg=k)
        assert t.numpy().dtype == saved[k].dtype, k
    seeded = torch.Generator().manual_seed(
        resume_seed(texp.spec.execution.seed, 4))
    assert torch.equal(texp._ls.gen.get_state(), seeded.get_state())
    res = texp.run(2)
    assert texp.step == 6 and res.eval_steps == [3, 6]
    assert np.isfinite(res.metrics["critic_loss"])


def test_scan_schedule_matches_the_reference_scan_loop():
    from repro.rl.experiment import Experiment as JExperiment
    over = dict(_SCAN, loop="scan", num_layers=1, use_ofenet=False,
                block_backend="jnp", eval_episodes=1)
    jexp = JExperiment.from_spec(JSpec().override(**over))
    texp = Experiment.from_spec(TSpec().override(**over), device="cpu")
    for steps in (17, 23):
        jr, tr = jexp.run(steps), texp.run(steps, eval_at_end=steps == 23)
    assert tr.eval_steps == jr.eval_steps == [10, 20, 30, 40]
    assert len(tr.sranks) == len(jr.sranks) == 8
    assert all(isinstance(s, int) and s >= 1 for s in tr.sranks)


def test_chunk_fn_epilogue_and_state_helpers():
    spec = TSpec().override(**_SCAN)
    tr = Trainer(spec, device="cpu")
    ls = tr.init()
    ref = clone_state(ls)
    assert not {t.data_ptr() for t in state_leaves(ls)} & {
        t.data_ptr() for t in state_leaves(ref)}
    _bitwise(ls, ref, "clone")
    ls, out = tr.chunk_fn(3, do_eval=True, do_srank=True)(ls)
    for _ in range(3):
        ref, m, batch = tr.step(ref)
    assert torch.equal(out["eval"], tr.evaluate(ref))   # the same draws
    _bitwise(ls, ref, "chunk of 3 and eval")
    from repro_torch.core.effective_rank import effective_rank
    assert int(out["srank"]) == int(effective_rank(m["q_features"]))
    assert out["eval"].shape == (spec.eval.episodes,)
    assert set(out["scal"]) == {k for k, v in m.items() if v.ndim == 0}
    assert torch.equal(out["last"][1], m["priorities"])
    assert "srank" not in tr.chunk_fn(1, False, False)(ls)[1]
    with pytest.raises(ValueError, match="n_steps"):
        tr.chunk_fn(0, False)


def test_copy_into_reads_every_source_before_writing():
    a, b = torch.arange(3.0), torch.arange(3.0) + 10
    c = torch.zeros(2, dtype=torch.int32)
    n = torch.ones(2, dtype=torch.int32)
    _copy_into([a, b, c], [b, a, n])        # a swap: each reads the old
    assert a.tolist() == [10, 11, 12] and b.tolist() == [0, 1, 2]
    assert c.tolist() == [1, 1]
    with pytest.raises(ValueError):
        _copy_into([a], [a, b])


def test_graph_captures_run_without_the_cyclic_collector():
    """Every ``StepGraph`` capture runs inside ``runner._capturing``: a
    dead cycle (a finished run's trainer and its graph) is collected
    before the capture and the collector stays off during it, since a
    graph freed mid-capture invalidates the capture; a caller's disabled
    collector stays disabled."""
    import gc
    import inspect
    import weakref
    from repro_torch.rl import runner

    class Node:
        pass
    a, b = Node(), Node()
    a.other, b.other = b, a
    dead = weakref.ref(a)
    del a, b
    assert gc.isenabled()
    with runner._capturing():
        assert dead() is None and not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with runner._capturing():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
    src = inspect.getsource(runner.StepGraph)
    assert src.count("torch.cuda.graph(") == 3
    assert src.count("_capturing()") == 3


@pytest.mark.parametrize("name", ["fig1-depth", "fig3-width",
                                  "fig5-connectivity", "fig6-ofenet",
                                  "quickstart"])
def test_presets_with_srank_build_a_trainer(name):
    spec = tpresets.get(name).override(replay_backend="device")
    assert spec.eval.srank_every > 0
    tr = Trainer(spec, device="cpu")
    assert tr.srank_every == spec.eval.srank_every


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph captures CUDA kernels")
    return torch.device("cuda")


def test_cuda_graph_replays_are_bitwise_eager_supersteps(cuda_device):
    spec = TSpec().override(**dict(_SCAN, loop="scan"))
    tr = Trainer(spec, device=cuda_device)
    ls = tr.init()
    eager, graph = clone_state(ls), clone_state(ls)
    for _ in range(6):
        eager, _, _ = tr.step(eager)
    graph, _ = tr.chunk_fn(2, False)(graph)       # capture: warm-up + 1
    graph, _ = tr.chunk_fn(4, False)(graph)
    _bitwise(graph, eager, "6 replays")
    assert torch.equal(tr.evaluate(graph), tr.evaluate(eager))


def test_cuda_td3_graph_replays_and_a_restore_under_the_graph(cuda_device,
                                                               tmp_path):
    spec = TSpec().override(**dict(_SCAN, loop="scan", algo="td3"))
    tr = Trainer(spec, device=cuda_device)
    ls = tr.init()
    eager, graph = clone_state(ls), clone_state(ls)
    for _ in range(6):                  # both delay parities, three times
        eager, _, _ = tr.step(eager)
    graph, _ = tr.chunk_fn(2, False)(graph)
    graph, _ = tr.chunk_fn(4, False)(graph)
    _bitwise(graph, eager, "6 td3 replays")
    path = str(tmp_path / "run.npz")
    whole = Experiment.from_spec(spec, device=cuda_device)
    rw = whole.run(40)
    first = Experiment.from_spec(spec, device=cuda_device)
    first.run(17)
    first.save(path)
    resumed = Experiment.restore(path, device=cuda_device)
    first.run(5)                        # moves on; then loads the file into
    first._load_payload(path, ckpt.load_metadata(path))   # its live graph
    for exp in (resumed, first):
        r = exp.run(23)
        _bitwise(exp._ls, whole._ls, "17 + save/restore + 23 vs 40")
        assert r.returns == rw.returns and r.sranks == rw.sranks
        assert r.eval_steps == rw.eval_steps
