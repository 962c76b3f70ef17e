"""The port's AdamW and tree helpers against the JAX reference.

``adamw_update`` from the same params, grads and state (seeded numpy) must
give the reference's params, ``mu``, ``nu`` and ``count``, with and without
global-norm clipping and weight decay, over two steps (so bias correction
at count 1 and 2 is exercised); ``huber``, ``ema_update``,
``tree_l2_norm``, ``tree_update_ratio`` and ``tree_size`` likewise.
Tolerance rtol = atol = 1e-6 (float32 elementwise arithmetic, pow).
"""
import numpy as np
import pytest
import torch

from repro_torch import common as tcommon, optim as toptim

TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(rng, scale=1.0):
    return {"a": {"w": (scale * rng.standard_normal((4, 3))).astype(
        np.float32), "b": (scale * rng.standard_normal((3,))).astype(
            np.float32)},
        "c": [(scale * rng.standard_normal((2,))).astype(np.float32)],
        "s": np.float32(scale * rng.standard_normal())}


def _t(tree):
    return tcommon.tree_map(lambda a: torch.as_tensor(np.asarray(a)), tree)


def _close(got, want):
    import jax
    for a, b in zip(tcommon.tree_leaves(got),
                    tcommon.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                               want))):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


@pytest.mark.parametrize("clip,wd", [(None, 0.0), (0.5, 0.0), (None, 0.01),
                                     (0.5, 0.01)])
def test_adamw_update_matches_jax(clip, wd):
    import jax.numpy as jnp
    from repro import optim as joptim
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jcfg = joptim.AdamWConfig(lr=1e-2, weight_decay=wd, grad_clip_norm=clip)
    tcfg = toptim.AdamWConfig(lr=1e-2, weight_decay=wd, grad_clip_norm=clip)
    jp, tp = params, _t(params)
    js = joptim.adamw_init(jp)
    ts = toptim.adamw_init(tp)
    for _ in range(2):
        g = _tree(rng, scale=3.0)
        jp, js = joptim.adamw_update(jcfg, g, js, jp)
        tp, ts = toptim.adamw_update(tcfg, _t(g), ts, tp)
        _close(tp, jp)
        _close(ts["mu"], js["mu"])
        _close(ts["nu"], js["nu"])
        assert int(ts["count"]) == int(js["count"])
        assert ts["count"].dtype == torch.int32
    del jnp


def test_global_norm_clip_and_schedule_match_jax():
    import jax.numpy as jnp
    from repro import optim as joptim
    g = _tree(np.random.default_rng(1), scale=2.0)
    jc, jn = joptim.clip_by_global_norm(g, 1.0)
    tc, tn = toptim.clip_by_global_norm(_t(g), 1.0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)
    _close(tc, jc)
    js, ts = joptim.warmup_cosine(10, 100), toptim.warmup_cosine(10, 100)
    for c in (0, 5, 10, 50, 100, 150):
        np.testing.assert_allclose(
            ts(torch.tensor(c, dtype=torch.int32)).numpy(),
            np.asarray(js(jnp.int32(c))), **TOL)


def test_tree_helpers_match_jax():
    from repro import common as jcommon
    rng = np.random.default_rng(2)
    a, b = _tree(rng), _tree(rng)
    x = rng.standard_normal(64).astype(np.float32) * 3
    np.testing.assert_allclose(tcommon.huber(torch.from_numpy(x)).numpy(),
                               np.asarray(jcommon.huber(x)), **TOL)
    _close(tcommon.ema_update(_t(a), _t(b), 0.005),
           jcommon.ema_update(a, b, 0.005))
    np.testing.assert_allclose(tcommon.tree_l2_norm(_t(a)).numpy(),
                               np.asarray(jcommon.tree_l2_norm(a)), **TOL)
    np.testing.assert_allclose(
        tcommon.tree_update_ratio(_t(a), _t(b)).numpy(),
        np.asarray(jcommon.tree_update_ratio(a, b)), **TOL)
    assert tcommon.tree_size(_t(a)) == jcommon.tree_size(a)


def test_value_and_grad_differentiates_one_tree_only():
    w = {"w": torch.ones(3), "v": [torch.full((2,), 2.0)]}
    other = torch.ones(3, requires_grad=False)
    (val, aux), g = tcommon.value_and_grad(
        lambda p: ((p["w"] * other).sum() * p["v"][0][0], p["w"] * 2),
        w, has_aux=True)
    assert float(val) == 6.0 and torch.equal(aux, torch.full((3,), 2.0))
    assert torch.equal(g["w"], torch.full((3,), 2.0))
    assert torch.equal(g["v"][0], torch.tensor([3.0, 0.0]))
    assert not w["w"].requires_grad and g["w"].grad_fn is None
