"""The port's batched environments, actor pool and evaluation against the
JAX reference.

* ``reset`` of all five envs fed the reference's own draws (reproduced
  from its key schedule, ``JAX_DRAWS``), and ``step`` from the same
  states and actions: states, observations, rewards and flags.
* ``collect`` with the random policy over a window that crosses the
  pendulum's 200-step time limit, fed the reference's per-step noise and
  reset draws (the same key feeds both, as in ``apex.collect``): the
  transitions with their ``done``/``boundary`` flags and the final states.
* ``eval_returns`` of a small SAC policy, fed the reference's episode
  reset draws (``fold_in(key, i)``).

Tolerance: rtol 1e-5 / atol 1e-5 on one step (float32 transcendental
functions), 1e-4 over collect and 200-step episodes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl import apex as japex, envs as jenvs
from repro_torch.rl import apex as tapex, envs as tenvs

NAMES = sorted(jenvs.ENVS)


def _u(k, shape=()):
    return np.asarray(jax.random.uniform(k, shape)).reshape(-1)


def _n(k, shape):
    return np.asarray(jax.random.normal(k, shape)).reshape(-1)


def _split(key, n):
    return jax.random.split(key, n)


# the standard draws each reference ``reset(key)`` makes, in column order
JAX_DRAWS = {
    "pendulum": lambda k: np.concatenate([_u(_split(k, 3)[0]),
                                          _u(_split(k, 3)[1])]),
    "cartpole_swingup": lambda k: _n(_split(k, 2)[0], (2,)),
    "reacher2": lambda k: np.concatenate([_u(_split(k, 3)[0], (2,)),
                                          _u(_split(k, 3)[1]),
                                          _u(_split(k, 3)[2])]),
    "pointmass": lambda k: _u(_split(k, 2)[0], (2,)),
    "acrobot": lambda k: _n(_split(k, 2)[0], (2,)),
}


def reset_draws(name, keys):
    return torch.from_numpy(np.stack([JAX_DRAWS[name](k) for k in keys])
                            .astype(np.float32))


def _state_close(t, j, tol):
    np.testing.assert_allclose(t.q.numpy(), np.asarray(j.q), **tol)
    np.testing.assert_allclose(t.qd.numpy(), np.asarray(j.qd), **tol)
    np.testing.assert_array_equal(t.t.numpy(), np.asarray(j.t))


@pytest.mark.parametrize("name", NAMES)
def test_reset_and_step_match_jax(name):
    tol = dict(rtol=1e-5, atol=1e-5)
    jenv, tenv = jenvs.make_env(name), tenvs.make_env(name)
    assert (tenv.obs_dim, tenv.act_dim, tenv.max_episode_steps) == \
        (jenv.obs_dim, jenv.act_dim, jenv.max_episode_steps)
    keys = _split(jax.random.key(11), 6)
    js = jax.vmap(jenv.reset)(keys)
    ts = tenv.reset(reset_draws(name, keys))
    _state_close(ts, js, tol)
    rng = np.random.default_rng(0)
    for _ in range(3):
        a = rng.uniform(-1.5, 1.5, (6, jenv.act_dim)).astype(np.float32)
        js, jo, jr, jd = jax.vmap(jenv.step)(js, jnp.asarray(a))
        ts, to, tr, td = tenv.step(ts, torch.from_numpy(a))
        _state_close(ts, js, tol)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **tol)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **tol)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tenv.obs(ts).numpy(),
                               np.asarray(jax.vmap(jenv.obs)(js)), **tol)


def test_pendulum_angle_wraps_with_a_floor_mod():
    """``jnp.mod`` is a floor-mod: the cost of a negative angle."""
    env = tenvs.make_env("pendulum")
    st = tenvs.EnvState(q=torch.tensor([[-4.0], [4.0]]),
                        qd=torch.zeros((2, 1)),
                        t=torch.zeros(2, dtype=torch.int32))
    _, _, r, _ = env.step(st, torch.zeros((2, 1)))
    want = -(2 * np.pi - 4.0) ** 2
    np.testing.assert_allclose(r.numpy(), [want, want], rtol=1e-5)


def test_collect_across_the_time_limit_matches_jax():
    tol = dict(rtol=1e-4, atol=1e-4)
    jenv, tenv = jenvs.make_env("pendulum"), tenvs.make_env("pendulum")
    n, steps = 4, 5
    keys = _split(jax.random.key(5), n)
    js = jax.vmap(jenv.reset)(keys)
    js = js._replace(t=jnp.asarray([196, 197, 198, 10], jnp.int32))
    ts = tenv.reset(reset_draws("pendulum", keys))
    ts = ts._replace(t=torch.tensor([196, 197, 198, 10], dtype=torch.int32))
    key = jax.random.key(9)
    js2, jtr = japex.collect(jenv, japex.random_policy(1), None, js, steps,
                             key)
    # the reference feeds each step's key to the policy AND to the resets
    step_keys = _split(key, steps)
    draws = {"noise": torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(k, (n, 1), minval=0.0, maxval=1.0))
        for k in step_keys]).astype(np.float32)),
        "reset": torch.stack([reset_draws("pendulum", _split(k, n))
                              for k in step_keys])}
    ts2, ttr = tapex.collect(tenv, tapex.random_policy(1), None, ts, draws)
    _state_close(ts2, js2, tol)
    assert sorted(ttr) == sorted(jtr)
    for k in jtr:
        np.testing.assert_allclose(ttr[k].numpy(), np.asarray(jtr[k]),
                                   err_msg=k, **tol)
    # actors 0-2 hit the limit inside the window: boundary set, done not
    assert ttr["boundary"].sum() == 3 and ttr["done"].sum() == 0


def test_collect_draws_shapes_and_kinds():
    env = tenvs.make_env("reacher2")
    gen = torch.Generator().manual_seed(0)
    d = tapex.collect_draws(env, 3, 5, "uniform", gen)
    assert d["noise"].shape == (3, 5, 2) and d["reset"].shape == (3, 5, 4)
    assert float(d["noise"].min()) >= 0.0
    with pytest.raises(ValueError, match="noise"):
        tapex.collect_draws(env, 1, 1, "gauss", gen)


def test_eval_returns_match_jax():
    from repro.rl import Policy as JPolicy
    from repro.rl.experiment import ExperimentSpec as JSpec
    from repro_torch import convert
    from repro_torch.rl.experiment import ExperimentSpec as TSpec
    from repro_torch.rl.policy import Policy as TPolicy
    over = dict(env="pendulum", num_units=16, num_layers=2, use_ofenet=True,
                ofenet_units=8, ofenet_layers=2, block_backend="fused")
    jspec, tspec = JSpec().override(**over), TSpec().override(**over)
    jpol = JPolicy.from_spec(jspec)
    from repro.rl import sac as jsac
    params = jsac.sac_init(jax.random.key(2), jpol.acfg)["params"]
    key, episodes = jax.random.key(4), 3
    want = jenvs.eval_returns(jenvs.make_env("pendulum"),
                              jpol.with_params(params), key, episodes)
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tpol = TPolicy.from_spec(tspec, tparams, device="cpu")
    draws = reset_draws("pendulum", [jax.random.fold_in(key, i)
                                     for i in range(episodes)])
    got = tenvs.eval_returns(tenvs.make_env("pendulum"), tpol, episodes,
                             draws=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


def test_make_env_rejects_unknown():
    with pytest.raises(ValueError, match="unknown env"):
        tenvs.make_env("hopper")
