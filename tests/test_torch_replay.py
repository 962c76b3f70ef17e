"""The port's replay (store, n-step ring, sum-tree, PER) against the JAX
reference.

* ``store_add``: wrap-around, and a batch longer than the store (the
  reference keeps its last ``capacity`` rows): data, cursor, count, rows.
* n-step ring at n = 3 with episode boundaries inside the window, via
  ``nstep_emit_flat`` with the warm-up ``drop``.
* Sum-tree: the plain ``sumtree_sample`` equals ``ref.tree_sample_ref``
  and the Pallas ``tree_sample`` (interpret mode) exactly, edge targets 0
  and total included; the plain ``sumtree_set`` is bitwise
  ``ref.tree_set_ref`` for unique indices and keeps the LAST write of a
  repeated index, as the host ``SumTree`` and ``tree_set_onehot``
  (interpret) do (ROADMAP C2: exact leaves; inner sums at rtol 1e-6, the
  host tree sums in float64 and the one-hot kernel adds deltas).
* ``replay_add/sample/update`` fed the reference's stratified uniforms:
  batch, indices, IS weights, tree and max priority (rtol 1e-6).

On the card (skipped without one) the CUDA sum-tree kernels are held
against the plain versions, bitwise: ``pytest tests/test_torch_replay.py
-k cuda``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.replay_tree import ops as tops, ref as tref
from repro_torch.replay import device as tdev, store as tstore


def _batch(rng, n, obs=3, act=2):
    return {"obs": rng.standard_normal((n, obs)).astype(np.float32),
            "act": rng.standard_normal((n, act)).astype(np.float32),
            "rew": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n, obs)).astype(np.float32),
            "done": (rng.uniform(size=n) < 0.3).astype(np.float32)}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("sizes", [(5, 4, 6), (3, 25)],
                         ids=["wrap", "longer-than-capacity"])
def test_store_add_matches_jax(sizes):
    from repro.replay import store as jstore
    rng = np.random.default_rng(0)
    js = jstore.store_init(10, 3, 2)
    ts = tstore.store_init(10, 3, 2)
    for n in sizes:
        b = _batch(rng, n)
        js, jidx = jstore.store_add(js, b)
        ts, tidx = tstore.store_add(ts, _t(b))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        for k in js["data"]:
            np.testing.assert_array_equal(ts["data"][k].numpy(),
                                          np.asarray(js["data"][k]))
        assert int(ts["ptr"]) == int(js["ptr"])
        assert int(ts["count"]) == int(js["count"])
    g = jstore.store_gather(js, np.array([0, 9, 4]))
    tg = tstore.store_gather(ts, torch.tensor([0, 9, 4]))
    for k in g:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(g[k]))


def test_nstep_ring_matches_jax_across_boundaries():
    from repro.replay import store as jstore
    rng = np.random.default_rng(1)
    n, actors, steps, gamma = 3, 4, 7, 0.9
    trs = _batch(rng, steps * actors)
    trs["boundary"] = (rng.uniform(size=steps * actors) < 0.3).astype(
        np.float32)
    jb = jstore.nstep_init(n, actors, 3, 2)
    tb = tstore.nstep_init(n, actors, 3, 2)
    jb, jflat = jstore.nstep_emit_flat(n, gamma, jb, trs, steps, n - 1)
    tb, tflat = tstore.nstep_emit_flat(n, gamma, tb, _t(trs), steps, n - 1)
    assert sorted(tflat) == sorted(jflat)
    for k in jflat:
        np.testing.assert_allclose(tflat[k].numpy(), np.asarray(jflat[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for k in jb:
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                   rtol=0, atol=0, err_msg=k)
    assert float(trs["boundary"].sum()) > 0


def _tree(capacity, seed):
    rng = np.random.default_rng(seed)
    pr = rng.uniform(0.01, 2.0, capacity).astype(np.float32)
    tree = tops.sumtree_init(capacity)
    tops.sumtree_set(tree, torch.arange(capacity), torch.from_numpy(pr))
    return tree


def test_sumtree_sample_matches_ref_and_pallas():
    import jax.numpy as jnp
    from repro.kernels.replay_tree import ref as jref
    from repro.kernels.replay_tree.replay_tree import tree_sample
    capacity = 1000
    tree = _tree(capacity, 0)
    total = float(tree[1])
    rng = np.random.default_rng(1)
    t = (rng.uniform(size=128) * total).astype(np.float32)
    t[0], t[1], t[2] = 0.0, total, np.nextafter(total, np.float32(0))
    leaf, pri = tops.sumtree_sample(tree, torch.from_numpy(t),
                                    capacity=capacity)
    assert leaf.dtype == torch.int32
    jt = jnp.asarray(tree.numpy())
    want = np.asarray(jref.tree_sample_ref(jt, jnp.asarray(t),
                                           capacity=capacity))
    np.testing.assert_array_equal(leaf.numpy(), want)
    pl_leaf, pl_pri = tree_sample(jt, jnp.asarray(t), capacity=capacity,
                                  interpret=True)
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(pl_leaf))
    np.testing.assert_array_equal(pri.numpy(), np.asarray(pl_pri))
    assert int(leaf[1]) <= capacity - 1


def test_sumtree_set_unique_is_bitwise_the_reference():
    import jax.numpy as jnp
    from repro.kernels.replay_tree import ref as jref
    capacity = 1000
    tree = _tree(capacity, 2)
    rng = np.random.default_rng(3)
    idx = rng.permutation(capacity)[:300].astype(np.int32)
    val = rng.uniform(0, 3, 300).astype(np.float32)
    want = jref.tree_set_ref(jnp.asarray(tree.numpy()), jnp.asarray(idx),
                             jnp.asarray(val))
    got = tops.sumtree_set(tree, torch.from_numpy(idx), torch.from_numpy(val))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sumtree_set_keeps_the_last_duplicate():
    import jax.numpy as jnp
    from repro.kernels.replay_tree.replay_tree import tree_set_onehot
    from repro.rl.replay import SumTree
    capacity = 500
    base = _tree(capacity, 4)
    rng = np.random.default_rng(5)
    idx = rng.integers(0, capacity, 200).astype(np.int32)
    idx[100:150] = idx[:50]                      # repeated indices
    idx[150:] = idx[:50] ^ 1                     # and their siblings
    idx = np.minimum(idx, capacity - 1)
    val = rng.uniform(0, 3, 200).astype(np.float32)
    got = tops.sumtree_set(base.clone(), torch.from_numpy(idx),
                           torch.from_numpy(val)).numpy()
    host = SumTree(capacity)
    host.tree[:] = base.numpy()
    host.set(idx, val)
    half = got.shape[0] // 2
    np.testing.assert_array_equal(got[half:], host.tree[half:])
    np.testing.assert_allclose(got, host.tree, rtol=1e-6)
    onehot = np.asarray(tree_set_onehot(jnp.asarray(base.numpy()),
                                        jnp.asarray(idx), jnp.asarray(val),
                                        interpret=True))
    np.testing.assert_allclose(got, onehot, rtol=1e-5, atol=1e-5)
    assert tref.keep_last(torch.tensor([3, 1, 3, 2, 1])).tolist() == \
        [False, False, True, True, True]


@pytest.mark.parametrize("bad", [-1, 512], ids=["negative", "past_leaves"])
def test_sumtree_set_rejects_an_index_outside_the_leaves(bad):
    tree = _tree(500, 4)                    # 512 leaves
    before = tree.clone()
    with pytest.raises(IndexError, match="outside the 512 leaves"):
        tops.sumtree_set(tree, torch.tensor([3, bad]), torch.ones(2))
    assert torch.equal(tree, before)


@pytest.mark.parametrize("prioritized", [True, False], ids=["per", "uniform"])
def test_replay_add_sample_update_match_jax(prioritized):
    import jax
    import jax.numpy as jnp
    from repro.replay import device as jdev
    cap, bsz = 64, 16
    jcfg = jdev.DeviceReplayConfig(capacity=cap, obs_dim=3, act_dim=2,
                                   uniform=not prioritized, backend="xla")
    tcfg = tdev.DeviceReplayConfig(capacity=cap, obs_dim=3, act_dim=2,
                                   uniform=not prioritized)
    js, ts = jdev.replay_init(jcfg), tdev.replay_init(tcfg)
    rng = np.random.default_rng(6)
    for step, n in ((0, 40), (1, 8), (2, 30)):
        b = _batch(rng, n)
        js = jdev.replay_add(jcfg, js, {k: jnp.asarray(v)
                                        for k, v in b.items()},
                             step=jnp.int32(step))
        ts = tdev.replay_add(tcfg, ts, _t(b),
                             step=torch.tensor(step, dtype=torch.int32))
        key = jax.random.key(step)
        jb, jidx, jw = jdev.replay_sample(jcfg, js, key, bsz)
        if prioritized:
            u = np.array(jax.random.uniform(key, (bsz,)))
        else:   # the port draws uniform rows as floor(u * count)
            u = (np.asarray(jidx) + 0.5) / int(ts["store"]["count"])
        tb, tidx, tw = tdev.replay_sample(tcfg, ts, torch.from_numpy(
            u.astype(np.float32)), bsz)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        td = rng.standard_normal(bsz).astype(np.float32)
        js = jdev.replay_update(jcfg, js, jidx, jnp.asarray(td))
        ts = tdev.replay_update(tcfg, ts, tidx, torch.from_numpy(td))
        np.testing.assert_allclose(ts["tree"].numpy(), np.asarray(js["tree"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(ts["max_priority"].numpy(),
                                   np.asarray(js["max_priority"]), rtol=1e-6)
        np.testing.assert_array_equal(ts["add_step"].numpy(),
                                      np.asarray(js["add_step"]))


def test_device_replay_wrapper_threads_the_state():
    rb = tdev.DeviceReplay(tdev.DeviceReplayConfig(capacity=32, obs_dim=3,
                                                   act_dim=2))
    rb.add_batch(_t(_batch(np.random.default_rng(9), 20)))
    assert len(rb) == 20 and rb.total == pytest.approx(20 * (1 + 1e-6) ** 0.6)
    batch, idx, w = rb.sample(8, torch.rand(8, generator=torch.Generator()))
    assert batch["obs"].shape == (8, 3) and float(w.max()) == 1.0
    rb.update_priorities(idx, torch.full((8,), 3.0))
    assert float(rb.state["max_priority"]) == pytest.approx(3.0 + 1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def test_cuda_sumtree_kernels_match_plain(cuda_device):
    capacity = 100_000
    tree = _tree(capacity, 7)
    rng = np.random.default_rng(8)
    t = (rng.uniform(size=256) * float(tree[1])).astype(np.float32)
    t[0], t[1] = 0.0, float(tree[1])
    want_leaf, want_pri = tops.sumtree_sample(tree, torch.from_numpy(t),
                                              capacity=capacity)
    dtree = tree.to(cuda_device)
    before = tops.launch_count("sample")
    leaf, pri = tops.sumtree_sample(dtree, torch.from_numpy(t).to(
        cuda_device), capacity=capacity)
    assert tops.launch_count("sample") - before == 1
    assert torch.equal(leaf.cpu(), want_leaf)
    assert torch.equal(pri.cpu(), want_pri)
    for n in (32, 256, 9984):
        idx = rng.integers(0, capacity, n).astype(np.int32)
        val = rng.uniform(0, 2, n).astype(np.float32)
        want = tops.sumtree_set(tree.clone(), torch.from_numpy(idx),
                                torch.from_numpy(val))
        got = tops.sumtree_set(dtree.clone(), torch.from_numpy(idx).to(
            cuda_device), torch.from_numpy(val).to(cuda_device))
        assert torch.equal(got.cpu(), want), n


def test_cuda_sumtree_set_skips_and_counts_an_index_outside_the_leaves(
        cuda_device):
    tree = _tree(500, 4)                    # 512 leaves
    idx, val = torch.tensor([3, -1, 512, 7]), torch.tensor([5., 6., 7., 8.])
    want = tops.sumtree_set(tree.clone(), idx[[0, 3]], val[[0, 3]])
    before = tops.skipped_writes(cuda_device)
    got = tops.sumtree_set(tree.to(cuda_device), idx.to(cuda_device),
                           val.to(cuda_device))
    assert tops.skipped_writes(cuda_device) - before == 2
    assert torch.equal(got.cpu(), want)
