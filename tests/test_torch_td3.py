"""One ``td3_update`` of the port against the reference's.

The same state (the reference's ``td3_init`` with every parameter nudged
and its AdamW states made non-trivial: moments nudged, every ``count`` 3,
carried across by ``convert.params_from_numpy``), the same seeded batch
and the reference's own smoothing draw (``normal(key, (B, act_dim))``) go
through both, at ``step`` 0 (the policy step: ``0 % policy_delay == 0``)
and 1 (delayed). Compared: the new params, every AdamW ``mu``/``nu`` and
``count``, every scalar metric, ``priorities`` and ``q_features``; for
both block backends with and without PER ``weight`` and n-step ``disc``
(four cases that hold every pair of these options' values), OFENet on.
At step 1 the port's actor, its AdamW state and the target actor must
come back bitwise as they went in. Tolerances: ``test_torch_sac.py``'s
(params atol 1e-6; opt moments rtol 1e-3 / atol 1e-3 * max|want|;
metrics 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl import make_env as jmake_env, td3 as jtd3
from repro.rl.experiment import ExperimentSpec as JSpec
from repro.rl.policy import algo_config as jalgo_config
from repro_torch import convert
from repro_torch.checkpoint.ckpt import _leaves
from repro_torch.common import tree_leaves
from repro_torch.rl import td3 as ttd3
from repro_torch.rl.experiment import ExperimentSpec as TSpec
from repro_torch.rl.policy import algo_config as talgo_config
from repro_torch.rl.envs import make_env as tmake_env

B = 16
_BASE = dict(env="reacher2", algo="td3", num_units=16, num_layers=2,
             use_ofenet=True, ofenet_units=8, ofenet_layers=2)


def _close(a, b, rtol, atol_frac, what):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=atol_frac * max(np.abs(b).max(), 1e-12),
                               err_msg=what)


def _setup(backend, step, seed=0):
    over = dict(_BASE, block_backend=backend)
    jspec, tspec = JSpec().override(**over), TSpec().override(**over)
    jcfg = jalgo_config(jspec, jmake_env(jspec.env))
    tcfg = talgo_config(tspec, tmake_env(tspec.env))
    state = jtd3.td3_init(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    noise = lambda a, scale: scale * rng.standard_normal(
        np.shape(a)).astype(np.float32)
    tm = jax.tree_util.tree_map
    opt = {name: {"mu": tm(lambda a: np.asarray(a) + noise(a, 0.01),
                           o["mu"]),
                  "nu": tm(lambda a: np.abs(noise(a, 0.01)), o["nu"]),
                  "count": jnp.int32(3)}
           for name, o in state["opt"].items()}
    state = {"params": tm(lambda a: np.asarray(a) + noise(a, 0.05),
                          state["params"]),
             "opt": opt, "step": jnp.int32(step)}
    return jcfg, tcfg, tm(jnp.asarray, state)


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


# every value of each option, and every pair of two options' values, once;
# each at the policy step and the delayed one
@pytest.mark.parametrize("step", [0, 1], ids=["policy-step", "delayed-step"])
@pytest.mark.parametrize("backend,weight,disc", [
    ("jnp", False, False), ("jnp", True, True),
    ("fused", False, True), ("fused", True, False)],
    ids=["jnp-uniform-1step", "jnp-per-disc", "fused-uniform-disc",
         "fused-per-1step"])
def test_td3_update_matches_jax(backend, weight, disc, step):
    jcfg, tcfg, state = _setup(backend, step)
    env = tmake_env(_BASE["env"])
    batch = _batch(env, np.random.default_rng(1), weight, disc)
    key = jax.random.key(3)
    jstate, jm = jax.jit(lambda st, b, k: jtd3.td3_update(st, jcfg, b, k))(
        state, batch, key)
    noise = np.array(jax.random.normal(key, (B, env.act_dim)))
    tstate = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, state), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, tm = ttd3.td3_update(tstate, tcfg, tb, torch.from_numpy(noise))
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    assert sorted(got["opt"]) == sorted(jstate["opt"]) == [
        "actor", "critics", "ofenet"]
    for name in sorted(jstate["opt"]):
        for part in ("mu", "nu"):
            for a, b in zip(tree_leaves(got["opt"][name][part]),
                            tree_leaves(jstate["opt"][name][part])):
                _close(a.numpy(), b, 1e-3, 1e-3, f"opt/{name}/{part}")
        moved = step == 0 or name != "actor"
        assert int(got["opt"][name]["count"]) == \
            int(jstate["opt"][name]["count"]) == (4 if moved else 3), name
    for a, b in zip(tree_leaves(got["params"]),
                    tree_leaves(jstate["params"])):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    assert int(got["step"]) == int(jstate["step"]) == step + 1
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k].numpy(), jm[k], 1e-4, 1e-4, k)
    kept = [(tree_leaves(got["params"][k]), tree_leaves(tstate["params"][k]))
            for k in ("actor", "target_actor")]
    kept.append((tree_leaves(got["opt"]["actor"]),
                 tree_leaves(tstate["opt"]["actor"])))
    same = all(torch.equal(x, y) for new, old in kept
               for x, y in zip(new, old))
    assert same == (step == 1), "the delayed step keeps the actor, its " \
        "AdamW state and the target actor bitwise; the policy step moves them"


def test_state_tree_and_q_values_match_jax():
    jcfg, tcfg, state = _setup("fused", 0)
    tstate = ttd3.td3_init(tcfg, torch.Generator(), device="cpu")
    jnp_state = jax.tree_util.tree_map(np.asarray,
                                       jtd3.td3_init(jax.random.key(0), jcfg))
    names = lambda t: [(k, tuple(np.shape(v)), str(np.asarray(v).dtype)
                        if not isinstance(v, torch.Tensor)
                        else str(v.numpy().dtype)) for k, v in _leaves(t)]
    assert names(tstate) == names(jnp_state)
    assert sorted(tstate["opt"]) == ["actor", "critics", "ofenet"]
    rng = np.random.default_rng(2)
    s = rng.standard_normal((5, 10)).astype(np.float32)
    a = rng.uniform(-1, 1, (5, 2)).astype(np.float32)
    params = state["params"]
    jq = jtd3.q_values(params["critics"], params, jcfg, s, a)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu")
    tq = ttd3.q_values(tp["critics"], tp, tcfg, torch.from_numpy(s),
                       torch.from_numpy(a))
    for x, y in zip(tq, jq):
        _close(x.numpy(), y, 1e-4, 1e-4, "q_values")
    q1, feat = ttd3._q1(tp["critics"], tp, tcfg, torch.from_numpy(s),
                        torch.from_numpy(a))
    assert torch.equal(q1, tq[0]) and torch.equal(feat, tq[2])
