"""The port's acting path, specs and checkpoints against the JAX reference.

* ``mean_action`` / TD3 ``policy`` on the reference's (perturbed) params,
  and ``sample_action`` fed the reference's own ``eps`` draw.
* A JAX ``Experiment`` trains a few steps and saves; the port's
  ``Policy.from_checkpoint`` serves the same actions within 1e-5. The other
  way round, a checkpoint the port writes serves in JAX.
* Presets, env dims and the device rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl import Experiment, Policy as JPolicy, make_env as jmake_env
from repro.rl import presets as jpresets, sac as jsac, td3 as jtd3
from repro.rl.envs import ENVS as JENVS
from repro.rl.experiment import ExperimentSpec as JSpec
from repro.rl.policy import algo_config as jalgo_config
from repro_torch import convert, resolve_device
from repro_torch.rl import presets as tpresets, sac as tsac, td3 as ttd3
from repro_torch.rl.envs import ENVS as TENVS, make_env as tmake_env
from repro_torch.rl.experiment import ExperimentSpec as TSpec, SpecError
from repro_torch.rl.policy import (Policy as TPolicy, algo_config,
                                   load_params, save_params)

_BASE = dict(env="pendulum", num_units=16, num_layers=2, use_ofenet=True,
             ofenet_units=8, ofenet_layers=2, distributed=True, n_core=1,
             n_env=4, total_steps=12, warmup_steps=8, eval_every=6,
             eval_episodes=1, replay_capacity=256, batch_size=16)
TOL = dict(rtol=1e-5, atol=1e-5)


def _specs(algo="sac", backend="fused", **kw):
    over = dict(_BASE, algo=algo, block_backend=backend, **kw)
    return JSpec().override(**over), TSpec().override(**over)


def _params(jspec, seed=7):
    """Reference init with every leaf nudged (biases are zero at init)."""
    env = jmake_env(jspec.env)
    acfg = jalgo_config(jspec, env)
    init = jsac.sac_init if jspec.algo == "sac" else jtd3.td3_init
    params = init(jax.random.key(seed), acfg)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), params)


def _obs(n, dim, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, dim)).astype(np.float32)


@pytest.mark.parametrize("backend", ("jnp", "fused"))
def test_sac_mean_and_sampled_actions_match_jax(backend):
    jspec, tspec = _specs("sac", backend)
    jcfg = jalgo_config(jspec, jmake_env("pendulum"))
    tcfg = algo_config(tspec, tmake_env("pendulum"))
    assert tcfg.actor_block().in_dim == jcfg.actor_block().in_dim
    params = _params(jspec)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = convert.params_from_numpy(params, "cpu")
    s = _obs(6, 3)
    np.testing.assert_allclose(
        tsac.mean_action(tp, tcfg, torch.from_numpy(s)).numpy(),
        np.asarray(jsac.mean_action(jp, jcfg, jnp.asarray(s))), **TOL)
    key = jax.random.key(3)
    ja, jlogp = jsac.sample_action(jp, jcfg, jnp.asarray(s), key)
    eps = np.array(jax.random.normal(key, (6, 1)))   # the reference's draw
    ta, tlogp = tsac.sample_action(tp, tcfg, torch.from_numpy(s),
                                   torch.from_numpy(eps))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), rtol=1e-5,
                               atol=1e-4)


def test_td3_policy_matches_jax():
    jspec, tspec = _specs("td3")
    jcfg = jalgo_config(jspec, jmake_env("pendulum"))
    tcfg = algo_config(tspec, tmake_env("pendulum"))
    params = _params(jspec)
    s = _obs(5, 3, seed=1)
    for which in ("actor", "target_actor"):
        np.testing.assert_allclose(
            ttd3.policy(convert.params_from_numpy(params, "cpu"), tcfg,
                        torch.from_numpy(s), which).numpy(),
            np.asarray(jtd3.policy(jax.tree_util.tree_map(jnp.asarray,
                                                          params),
                                   jcfg, jnp.asarray(s), which)), **TOL)


@pytest.mark.parametrize("algo", ("sac", "td3"))
def test_init_builds_the_reference_tree(algo):
    jspec, tspec = _specs(algo)
    jp = _params(jspec)
    init = tsac.sac_init if algo == "sac" else ttd3.td3_init
    tp = convert.params_to_numpy(init(
        algo_config(tspec, tmake_env("pendulum")),
        torch.Generator().manual_seed(0), device="cpu")["params"])
    assert jax.tree_util.tree_structure(jp) == \
        jax.tree_util.tree_structure(tp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(tp)):
        assert np.shape(a) == b.shape


def test_jax_checkpoint_serves_in_the_port(tmp_path):
    """Train in JAX, save, serve from the port: same actions."""
    jspec, _ = _specs("sac")
    exp = Experiment.from_spec(jspec)
    exp.run(12)
    path = str(tmp_path / "jax.npz")
    exp.save(path)
    live = exp.policy()
    obs = _obs(8, live.obs_dim, seed=2)
    want = np.asarray(live.act_deterministic(obs))
    exp.close()
    pol = TPolicy.from_checkpoint(path, device="cpu")
    assert pol.algo == "sac" and pol.obs_dim == 3 and pol.act_dim == 1
    np.testing.assert_allclose(pol.act_deterministic(obs).numpy(), want,
                               **TOL)
    single = pol.act_deterministic(obs[0])
    assert single.shape == (1,)
    np.testing.assert_allclose(single.numpy(), want[0], **TOL)


def test_port_checkpoint_serves_in_jax(tmp_path):
    jspec, tspec = _specs("sac")
    tcfg = algo_config(tspec, tmake_env("pendulum"))
    params = tsac.sac_init(tcfg, torch.Generator().manual_seed(1),
                           device="cpu")["params"]
    path = str(tmp_path / "port.npz")
    save_params(path, tspec, params)
    spec_back, params_back = load_params(path, device="cpu")
    assert spec_back == tspec
    for a, b in zip(jax.tree_util.tree_leaves(convert.params_to_numpy(
            params)), jax.tree_util.tree_leaves(convert.params_to_numpy(
                params_back))):
        np.testing.assert_array_equal(a, b)
    obs = _obs(8, 3, seed=4)
    got = TPolicy.from_spec(tspec, params, device="cpu").act_deterministic(
        obs).numpy()
    jpol = JPolicy.from_checkpoint(path)
    assert jpol.algo == "sac"
    np.testing.assert_allclose(np.asarray(jpol.act_deterministic(obs)), got,
                               **TOL)


def test_stochastic_act_draws_from_the_generator():
    _, tspec = _specs("sac")
    tcfg = algo_config(tspec, tmake_env("pendulum"))
    params = tsac.sac_init(tcfg, torch.Generator().manual_seed(2),
                           device="cpu")["params"]
    pol = TPolicy.from_spec(tspec, params, device="cpu")
    obs = _obs(4, 3, seed=5)
    a1 = pol.act(obs, torch.Generator().manual_seed(9))
    a2 = pol.act(obs, torch.Generator().manual_seed(9))
    assert a1.shape == (4, 1) and torch.all(a1.abs() <= 1)
    torch.testing.assert_close(a1, a2)
    eps = torch.randn((4, 1), generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(a1, pol.act_fn(params, torch.from_numpy(obs),
                                              eps))
    assert pol.act(obs[0], torch.Generator()).shape == (1,)
    with pytest.raises(ValueError, match="no params bound"):
        pol.with_params(None).act_deterministic(obs)


def test_presets_match_jax():
    assert tpresets.names() == jpresets.names()
    for name in jpresets.names():
        assert tpresets.get(name).to_dict() == jpresets.get(name).to_dict(), \
            name
    with pytest.raises(SpecError, match="unknown preset"):
        tpresets.get("nope")


def test_spec_roundtrips_and_validates_like_jax():
    d = jpresets.get("rl-distributed").override(
        **{"guard.enabled": True, "obs.sinks": "memory"}).to_dict()
    assert TSpec.from_dict(d).to_dict() == d
    for bad in (dict(num_units=0), dict(connectivity="x"),
                dict(block_backend="fused", **{"ofenet.batch_norm": True}),
                dict(replay_kernel="pallas"), {"guard.policy": "x"},
                {"guard.srank_collapse": 1.5}, {"nope": 1}):
        with pytest.raises(ValueError):
            JSpec().override(**bad)
        with pytest.raises(SpecError):
            TSpec().override(**bad)


def test_env_dims_match_jax():
    assert sorted(TENVS) == sorted(JENVS)
    for name, make in JENVS.items():
        j, t = make(), tmake_env(name)
        assert (t.obs_dim, t.act_dim, t.max_episode_steps) == \
            (j.obs_dim, j.act_dim, j.max_episode_steps)


def test_device_rule():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-device default is the card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tsac.sac_init(algo_config(TSpec(), tmake_env("pendulum")),
                      torch.Generator())
