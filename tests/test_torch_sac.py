"""One ``sac_update`` of the port against the reference's.

The same state (the reference's ``sac_init`` with every leaf nudged, its
AdamW states included, carried across by ``convert.params_from_numpy``),
the same seeded batch and the reference's own two Gaussian draws (``k1,
k2 = split(key)``; ``normal(k, (B, act_dim))``) go through both. Compared:
the new params, every AdamW ``mu``/``nu`` and ``count``, every scalar
metric, ``priorities`` and ``q_features``; for both block backends (the
fused stack, whose CPU path is the plain version) with and without PER
``weight`` and n-step ``disc`` (four cases that hold every pair of these
options' values), OFENet on. Tolerances: the repo's bar,
rtol 1e-3 / atol 1e-3 * max|want| on gradients (``mu``, ``nu``) and 1e-4
on forward values; params move by at most ``lr`` per step, so they are
held at atol 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from repro.rl import make_env as jmake_env, sac as jsac
from repro.rl.experiment import ExperimentSpec as JSpec
from repro.rl.policy import algo_config as jalgo_config
from repro_torch import convert
from repro_torch.common import tree_leaves
from repro_torch.rl import sac as tsac
from repro_torch.rl.experiment import ExperimentSpec as TSpec
from repro_torch.rl.policy import algo_config as talgo_config
from repro_torch.rl.envs import make_env as tmake_env

B = 16
_BASE = dict(env="reacher2", num_units=16, num_layers=2, use_ofenet=True,
             ofenet_units=8, ofenet_layers=2)


def _close(a, b, rtol, atol_frac, what):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=atol_frac * max(np.abs(b).max(), 1e-12),
                               err_msg=what)


def _setup(backend, seed=0):
    over = dict(_BASE, block_backend=backend)
    jspec, tspec = JSpec().override(**over), TSpec().override(**over)
    jcfg = jalgo_config(jspec, jmake_env(jspec.env))
    tcfg = talgo_config(tspec, tmake_env(tspec.env))
    state = jsac.sac_init(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    nudge = lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
        np.shape(a)).astype(np.float32)).astype(np.asarray(a).dtype)
    state = {**state, "params": jax.tree_util.tree_map(nudge,
                                                       state["params"])}
    return jcfg, tcfg, state


def _batch(env, rng, weight, disc):
    o, a = env.obs_dim, env.act_dim
    b = {"obs": rng.standard_normal((B, o)), "act": rng.uniform(-1, 1, (B, a)),
         "rew": rng.standard_normal(B), "next_obs": rng.standard_normal((B, o)),
         "done": (rng.uniform(size=B) < 0.2).astype(np.float64)}
    if weight:
        b["weight"] = rng.uniform(0.1, 1.0, B)
    if disc:
        b["disc"] = 0.99 ** 3 * (1 - b["done"])
    return {k: np.asarray(v, np.float32) for k, v in b.items()}


def jax_eps(key, act_dim):
    """The two draws the reference's ``sac_update(..., key)`` makes."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.normal(k1, (B, act_dim))),
            np.array(jax.random.normal(k2, (B, act_dim))))


# every value of each option, and every pair of two options' values, once
@pytest.mark.parametrize("backend,weight,disc", [
    ("jnp", False, False), ("jnp", True, True),
    ("fused", False, True), ("fused", True, False)],
    ids=["jnp-uniform-1step", "jnp-per-disc", "fused-uniform-disc",
         "fused-per-1step"])
def test_sac_update_matches_jax(backend, weight, disc):
    jcfg, tcfg, state = _setup(backend)
    env = tmake_env(_BASE["env"])
    batch = _batch(env, np.random.default_rng(1), weight, disc)
    key = jax.random.key(3)
    jstate, jm = jax.jit(lambda st, b, k: jsac.sac_update(st, jcfg, b, k))(
        state, batch, key)
    eps1, eps2 = jax_eps(key, env.act_dim)
    tstate = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, state), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, tm = tsac.sac_update(tstate, tcfg, tb, torch.from_numpy(eps1),
                              torch.from_numpy(eps2))
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    for name in sorted(jstate["opt"]):
        for part in ("mu", "nu"):
            for a, b in zip(tree_leaves(got["opt"][name][part]),
                            tree_leaves(jstate["opt"][name][part])):
                _close(a.numpy(), b, 1e-3, 1e-3, f"opt/{name}/{part}")
        assert int(got["opt"][name]["count"]) == 1
    for a, b in zip(tree_leaves(got["params"]),
                    tree_leaves(jstate["params"])):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    assert int(got["step"]) == int(jstate["step"]) == 1
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k].numpy(), jm[k], 1e-4, 1e-4, k)


def test_q_values_and_state_tree_match_jax():
    jcfg, tcfg, state = _setup("fused")
    tstate = tsac.sac_init(tcfg, torch.Generator(), device="cpu")
    shapes = lambda t: [tuple(np.shape(x)) for x in tree_leaves(t)]
    assert shapes(tstate) == shapes(jax.tree_util.tree_map(np.asarray,
                                                           state))
    rng = np.random.default_rng(2)
    s = rng.standard_normal((5, 10)).astype(np.float32)
    a = rng.uniform(-1, 1, (5, 2)).astype(np.float32)
    params = state["params"]
    jq = jsac.q_values(params["critics"], params, jcfg, s, a)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu")
    tq = tsac.q_values(tp["critics"], tp, tcfg, torch.from_numpy(s),
                       torch.from_numpy(a))
    for x, y in zip(tq, jq):
        _close(x.numpy(), y, 1e-4, 1e-4, "q_values")
