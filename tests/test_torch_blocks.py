"""The port's MLP blocks and OFENet features against the JAX reference.

Weights come from the reference's own init, perturbed with seeded numpy
(biases and BN statistics are otherwise zero/one and would hide faults),
and cross over with ``convert.params_from_numpy``. Tolerance: float32
reassociation between XLA:CPU and PyTorch's CPU kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as jblocks, ofenet as jofe
from repro_torch import convert
from repro_torch.core import blocks as tblocks, ofenet as tofe

RTOL, ATOL = 1e-5, 1e-5


def _perturbed(params, seed):
    """Reference params as numpy, every leaf nudged (BN variances kept
    positive)."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    out = []
    for path, leaf in flat:
        a = np.asarray(leaf, np.float32)
        a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if getattr(path[-1], "key", None) == "var":
            a = np.abs(a) + 0.5
        out.append(a)
    return jax.tree_util.tree_unflatten(treedef, out)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("backend", ("jnp", "fused"))
@pytest.mark.parametrize("out_dim", (None, 3))
@pytest.mark.parametrize("bn", ("off", "train", "eval"))
@pytest.mark.parametrize("conn", ("mlp", "resnet", "densenet", "d2rl"))
def test_mlp_block_apply_matches_jax(conn, bn, out_dim, backend):
    cfg_kw = dict(in_dim=5, num_layers=3, num_units=16, connectivity=conn,
                  batch_norm=bn != "off", out_dim=out_dim, backend=backend)
    jcfg = jblocks.MLPBlockConfig(**cfg_kw)
    tcfg = tblocks.MLPBlockConfig(**cfg_kw)
    assert tcfg.fused_supported == jcfg.fused_supported
    assert tcfg.layer_in_dims() == jcfg.layer_in_dims()
    assert tcfg.feature_dim == jcfg.feature_dim
    params = _perturbed(jblocks.mlp_block_init(jax.random.key(1), jcfg), 2)
    x = np.random.default_rng(3).standard_normal((7, 5)).astype(np.float32)
    train = bn == "train"
    jout, jfeat, jnew = jblocks.mlp_block_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg, jnp.asarray(x),
        train=train)
    tparams = convert.params_from_numpy(params, "cpu")
    tout, tfeat, tnew = tblocks.mlp_block_apply(tparams, tcfg,
                                                torch.from_numpy(x),
                                                train=train)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), RTOL, ATOL)
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), RTOL, ATOL)
    # refreshed BN running stats (and the same params when BN is off)
    for a, b in zip(jax.tree_util.tree_leaves(_np_tree(jnew)),
                    jax.tree_util.tree_leaves(
                        convert.params_to_numpy(tnew))):
        np.testing.assert_allclose(b, a, RTOL, ATOL)
    if bn == "off":
        assert tnew is tparams


def test_mlp_block_init_layout_matches_jax():
    """Same tree, same shapes, zero biases, U(+-1/sqrt(fan_in)) weights."""
    cfg_kw = dict(in_dim=6, num_layers=2, num_units=32, connectivity="d2rl",
                  batch_norm=True, out_dim=4)
    jp = _np_tree(jblocks.mlp_block_init(jax.random.key(0),
                                         jblocks.MLPBlockConfig(**cfg_kw)))
    tp = convert.params_to_numpy(tblocks.mlp_block_init(
        torch.Generator().manual_seed(0), tblocks.MLPBlockConfig(**cfg_kw),
        torch.device("cpu")))
    assert jax.tree_util.tree_structure(jp) == \
        jax.tree_util.tree_structure(tp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(tp)):
        assert a.shape == b.shape and b.dtype == np.float32
    w = tp["layers"][1]["dense"]["w"]
    assert np.abs(w).max() <= 1 / np.sqrt(w.shape[0])
    assert not tp["layers"][0]["dense"]["b"].any()


def test_gelu_is_the_tanh_approximation():
    from repro.common import get_activation as jget
    from repro_torch.common import get_activation as tget
    x = np.linspace(-4, 4, 33).astype(np.float32)
    np.testing.assert_allclose(tget("gelu")(torch.from_numpy(x)).numpy(),
                               np.asarray(jget("gelu")(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend", ("jnp", "fused"))
@pytest.mark.parametrize("with_action", (False, True))
def test_ofenet_features_match_jax(with_action, backend):
    kw = dict(state_dim=3, action_dim=2, num_layers=3, num_units=16,
              batch_norm=False, block_backend=backend)
    jcfg, tcfg = jofe.OFENetConfig(**kw), tofe.OFENetConfig(**kw)
    assert tcfg.state_feature_dim == jcfg.state_feature_dim == 3 + 3 * 16
    assert tcfg.sa_feature_dim == jcfg.sa_feature_dim
    params = _perturbed(jofe.ofenet_init(jax.random.key(5), jcfg), 6)
    rng = np.random.default_rng(7)
    s = rng.standard_normal((4, 3)).astype(np.float32)
    a = rng.standard_normal((4, 2)).astype(np.float32) if with_action \
        else None
    jz_s, jz_sa, _ = jofe.features(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg, jnp.asarray(s),
        None if a is None else jnp.asarray(a))
    tz_s, tz_sa, _ = tofe.features(
        convert.params_from_numpy(params, "cpu"), tcfg, torch.from_numpy(s),
        None if a is None else torch.from_numpy(a))
    np.testing.assert_allclose(tz_s.numpy(), np.asarray(jz_s), RTOL, ATOL)
    if with_action:
        np.testing.assert_allclose(tz_sa.numpy(), np.asarray(jz_sa), RTOL,
                                   ATOL)
    else:
        assert tz_sa is None and jz_sa is None
