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
* What the slice does not port raises at once, naming its ROADMAP item.
"""
import jax
import numpy as np
import pytest
import torch

from repro.rl.experiment import ExperimentSpec as JSpec
from repro.rl.runner import Trainer as JTrainer
from repro_torch import convert
from repro_torch.common import tree_leaves
from repro_torch.rl.envs import EnvState
from repro_torch.rl.experiment import Experiment, ExperimentSpec as TSpec
from repro_torch.rl.policy import Policy
from repro_torch.rl.runner import (TrainLoopState, Trainer, UnportedError,
                                   median)

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
    k1, k2 = jax.random.split(ku)
    f = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    return {"collect": {"noise": f(jax.random.normal(k, (n, a)))[None],
                        "reset": f(resets)[None]},
            "u": f(jax.random.uniform(ks, (jtr.batch_size,))),
            "eps1": f(jax.random.normal(k1, (jtr.batch_size, a))),
            "eps2": f(jax.random.normal(k2, (jtr.batch_size, a)))}


def _close(a, b, rtol, what):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-12),
                               err_msg=what)


@pytest.mark.parametrize("backend,n_step", [("fused", 1), ("jnp", 3)])
def test_superstep_matches_jax_device_step(backend, n_step):
    over = dict(_BASE, block_backend=backend, n_step=n_step)
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


@pytest.mark.parametrize("over,item", [
    (dict(algo="td3"), "A.1"),
    (dict(replay_backend="host", replay_kernel="xla"), "A.6"),
    (dict(srank_every=3), "A.9"),
    ({"obs.enabled": True}, "A.5"), ({"guard.enabled": True}, "A.4"),
    ({"execution.mesh_shards": 2, "execution.loop": "scan"}, "A.8")])
def test_unported_choices_raise_with_their_roadmap_item(over, item):
    spec = TSpec().override(**dict(_BASE, **over))
    with pytest.raises(UnportedError, match=item):
        Experiment.from_spec(spec, device="cpu")


def test_save_restore_not_ported_and_device_rule():
    spec = TSpec().override(**_BASE)
    exp = Experiment.from_spec(spec, device="cpu")
    with pytest.raises(NotImplementedError, match="A.2"):
        exp.save("x.npz")
    with pytest.raises(NotImplementedError, match="A.2"):
        Experiment.restore("x.npz")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Experiment.from_spec(spec)
