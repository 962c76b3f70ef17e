"""``repro_torch.core.loss_landscape`` against ``repro.core.loss_landscape``.

* ``_filter_normalize`` of the same directions, and ``random_direction``
  fed the reference's own draws (``split(key, n_leaves)`` in
  ``tree_flatten`` order, then ``normal(k, shape, float32)``, keyed here by
  leaf path), within 1e-6; the per-filter norms equal the parameter's
  (the port of ``tests/test_core_paper.py``'s check).
* ``loss_surface`` of a quadratic and of a small SAC critic's J_Q (the
  reference's params carried across by ``convert.params_from_numpy``, the
  same batch, frozen targets from each package's target critics, the
  directions of the reference's ``k1, k2 = split(key)``) against the
  reference's surface at rtol 1e-4 (the forward's bar).
* ``sharpness`` equal to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import loss_landscape as jll
from repro.rl import make_env as jmake_env, sac as jsac
from repro.rl.experiment import ExperimentSpec as JSpec
from repro.rl.policy import algo_config as jalgo_config
from repro_torch import convert
from repro_torch.common import tree_leaves
from repro_torch.core import loss_landscape as tll
from repro_torch.rl import sac as tsac
from repro_torch.rl.envs import make_env as tmake_env
from repro_torch.rl.experiment import ExperimentSpec as TSpec
from repro_torch.rl.policy import algo_config as talgo_config


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in kp)


def _ref_draws(key, params):
    """The reference's Gaussian draws of ``random_direction(key, params)``,
    keyed by leaf path."""
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    keys = jax.random.split(key, len(flat))
    return {_path(kp): np.asarray(jax.random.normal(k, leaf.shape,
                                                    jnp.float32))
            for k, (kp, leaf) in zip(keys, flat)}


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(got, want, rtol, atol=0.0):
    want_flat, _ = jax.tree_util.tree_flatten_with_path(_to_np(want))
    got_leaves = dict(zip(tll.leaf_paths(got),
                          (t.numpy() for t in tree_leaves(got))))
    assert sorted(got_leaves) == sorted(_path(kp) for kp, _ in want_flat)
    for kp, w in want_flat:
        np.testing.assert_allclose(got_leaves[_path(kp)], w, rtol=rtol,
                                   atol=atol, err_msg=_path(kp))


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense": {"w": rng.standard_normal((5, 7)).astype(np.float32),
                      "b": rng.standard_normal(7).astype(np.float32)},
            "conv": [rng.standard_normal((2, 3, 4)).astype(np.float32)],
            "scale": np.float32(1.5) * np.ones((), np.float32)}


def test_leaf_paths_follow_tree_leaves_order():
    p = convert.params_from_numpy(_params(), device="cpu")
    assert tll.leaf_paths(p) == ["conv/0", "dense/b", "dense/w", "scale"]


def test_filter_normalize_matches_reference():
    params = _params(0)
    rng = np.random.default_rng(1)
    d = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
        params)
    want = jll._filter_normalize(d, params)
    got = tll._filter_normalize(convert.params_from_numpy(d, device="cpu"),
                                convert.params_from_numpy(params,
                                                          device="cpu"))
    _assert_trees_close(got, want, rtol=1e-6, atol=1e-7)


def test_random_direction_with_reference_draws_matches():
    params = _params(2)
    key = jax.random.key(3)
    want = jll.random_direction(key, params)
    got = tll.random_direction(
        convert.params_from_numpy(params, device="cpu"),
        draws=_ref_draws(key, params))
    _assert_trees_close(got, want, rtol=1e-6, atol=1e-7)


def test_random_direction_filter_normalized():
    params = {"w": 3.0 * torch.ones((4, 5)), "b": torch.ones((5,))}
    d = tll.random_direction(params, generator=torch.Generator()
                             .manual_seed(0))
    dn = np.linalg.norm(d["w"].numpy(), axis=0)
    pn = np.linalg.norm(params["w"].numpy(), axis=0)
    np.testing.assert_allclose(dn, pn, rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(d["b"].numpy()),
                               np.linalg.norm(params["b"].numpy()),
                               rtol=1e-4)


def test_random_direction_needs_draws_or_generator():
    with pytest.raises(ValueError, match="draws or a generator"):
        tll.random_direction({"w": torch.ones(2, 2)})
    with pytest.raises(ValueError, match="shape"):
        tll.random_direction({"w": torch.ones(2, 2)},
                             draws={"w": np.zeros((3, 2))})


def _port_dirs(key, params_np, params_t):
    """The port's d1, d2 from the reference's ``k1, k2 = split(key)``."""
    k1, k2 = jax.random.split(key)
    return (tll.random_direction(params_t, draws=_ref_draws(k1, params_np)),
            tll.random_direction(params_t, draws=_ref_draws(k2, params_np)))


def test_loss_surface_of_a_quadratic_matches_reference():
    params = {"w": np.arange(1.0, 7.0, dtype=np.float32).reshape(2, 3),
              "b": np.asarray([0.5, -1.0, 2.0], np.float32)}
    key = jax.random.key(0)
    ja, jb, jsurf = jll.loss_surface(
        lambda p: jnp.sum(p["w"] ** 2) + 0.5 * jnp.sum(p["b"] ** 2),
        params, key, span=0.5, resolution=7)
    pt = convert.params_from_numpy(params, device="cpu")
    d1, d2 = _port_dirs(key, params, pt)
    a, b, surf = tll.loss_surface(
        lambda p: torch.sum(p["w"] ** 2) + 0.5 * torch.sum(p["b"] ** 2),
        pt, d1, d2, span=0.5, resolution=7)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    assert surf.shape == (7, 7) and surf.dtype == np.float64
    np.testing.assert_allclose(surf, jsurf, rtol=1e-4)


def _critic_setup(seed=0, b=32):
    over = dict(env="pendulum", num_units=16, num_layers=2, use_ofenet=True,
                ofenet_units=8, ofenet_layers=2)
    jspec, tspec = JSpec().override(**over), TSpec().override(**over)
    jenv, tenv = jmake_env(jspec.env), tmake_env(tspec.env)
    jcfg, tcfg = jalgo_config(jspec, jenv), talgo_config(tspec, tenv)
    params = jsac.sac_init(jax.random.key(seed), jcfg)["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a))).astype(np.float32), params)
    o, a = jenv.obs_dim, jenv.act_dim
    batch = {"obs": rng.standard_normal((b, o)),
             "act": rng.uniform(-1, 1, (b, a)),
             "rew": rng.standard_normal(b),
             "next_obs": rng.standard_normal((b, o)),
             "done": (rng.uniform(size=b) < 0.1)}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    return jcfg, tcfg, params, batch


def test_loss_surface_of_sac_critic_j_q_matches_reference():
    jcfg, tcfg, params, batch = _critic_setup()
    key = jax.random.key(7)

    q1_t, q2_t, _ = jsac.q_values(params["target_critics"], params, jcfg,
                                  batch["next_obs"], batch["act"])
    q_hat = batch["rew"] + jcfg.gamma * (1 - batch["done"]) * \
        jnp.minimum(q1_t, q2_t)

    def jj_q(critics):
        q1, q2, _ = jsac.q_values(critics, params, jcfg, batch["obs"],
                                  batch["act"])
        return 0.5 * jnp.mean((q1 - q_hat) ** 2)

    _, _, jsurf = jll.loss_surface(jj_q, params["critics"], key, span=1.0,
                                   resolution=5)

    tp = convert.params_from_numpy(params, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tq1, tq2, _ = tsac.q_values(tp["target_critics"], tp, tcfg,
                                tb["next_obs"], tb["act"])
    tq_hat = tb["rew"] + tcfg.gamma * (1 - tb["done"]) * \
        torch.minimum(tq1, tq2)

    def tj_q(critics):
        q1, q2, _ = tsac.q_values(critics, tp, tcfg, tb["obs"], tb["act"])
        return 0.5 * torch.mean((q1 - tq_hat) ** 2)

    d1, d2 = _port_dirs(key, params["critics"], tp["critics"])
    _, _, surf = tll.loss_surface(tj_q, tp["critics"], d1, d2, span=1.0,
                                  resolution=5)
    np.testing.assert_allclose(surf, jsurf, rtol=1e-4)
    assert tll.sharpness(surf) == pytest.approx(jll.sharpness(jsurf),
                                                rel=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_sharpness_equals_reference(seed):
    rng = np.random.default_rng(seed)
    surf = rng.uniform(1e-3, 5.0, (9, 9))
    surf[0, 0] = 0.0                       # the log's floor
    assert tll.sharpness(surf) == jll.sharpness(surf)
