"""The schedules of the sum-tree kernels (``csrc/replay_tree.cu``),
emulated in plain torch, held bitwise against the plain reference.

The card kernels cannot run here, so their schedules are written out
below as the kernels run them, and held to ``ref.tree_set_ref`` /
``ref.tree_sample_ref`` (and to the JAX reference's ``ref.py``) bit for
bit:

* the write: passes of ``TILE`` entries in order; in each, the keep-last
  winners (the last position of each leaf in the pass) write their
  leaves, then their ancestors are recomputed a level at a time as
  fl(left + right) from the tree's own nodes;
* the sample: the top ``top`` levels from a staged copy, then the whole
  ``k``-level subtree under the current node gathered in one round and
  descended with the reference's comparisons and fp32 subtractions; the
  last round's leaf value is the priority unless the clamp moved it.

At depth 18 (capacity 100,000) and at a small depth, the sample for k in
{3, 4, 5}, the write with n of 32, 256 and 9,984; duplicates, siblings,
leaves in the zero padding at or past the capacity, and the edge targets
0 and total. The card itself runs ``tests/test_torch_replay.py -k
cuda`` and the member-axis tests below (``-k cuda``).

The member axis (a vmapped fleet's ``(E, 2**depth)`` trees): under
``torch.func.vmap`` ``sumtree_set``/``sumtree_sample`` go through their
vmap rules to the member entries, which run the plain versions member by
member here (the index check over the whole ``(E, n)`` tensor) and one
member-axis launch on the card, held there against E solo launches and
the plain versions.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.replay_tree import ops as tops, ref as tref

TILE = 1024          # entries a pass of the write kernel (kSetThreads)


def _tree(capacity, seed, consistent=True):
    """A tree of ``capacity`` priorities in (0, 2); with ``consistent``
    False, every inner node is overwritten with noise (a tree the kernel
    must still update exactly as the reference does)."""
    rng = np.random.default_rng(seed)
    tree = tref.tree_init_ref(capacity)
    pr = torch.from_numpy(rng.uniform(1e-3, 2, capacity).astype(np.float32))
    tref.tree_set_ref(tree, torch.arange(capacity), pr)
    if not consistent:
        half = tree.shape[0] // 2
        tree[1:half] = torch.from_numpy(
            rng.uniform(0, 5, half - 1).astype(np.float32))
    return tree


def emulate_set(tree, idx, val, tile=TILE):
    """The write kernel's schedule; returns ``(tree, levels per pass)``."""
    size = tree.shape[0]
    depth, half = size.bit_length() - 1, size // 2
    idx, levels = idx.long(), []
    for base in range(0, idx.shape[0], tile):
        ii, vv = idx[base:base + tile], val[base:base + tile]
        ok = (ii >= 0) & (ii < half)
        ii, vv = ii[ok], vv[ok]
        pos = torch.full((half,), -1, dtype=torch.long)
        pos.scatter_reduce_(0, ii, torch.arange(ii.shape[0]), "amax")
        win = pos[ii] == torch.arange(ii.shape[0])      # the last of each
        node = ii[win] + half
        tree[node] = vv[win]
        for _ in range(depth - 1):
            node = node >> 1
            tree[node] = tree[2 * node] + tree[2 * node + 1]
        levels.append(depth - 1)
    return tree, levels


def emulate_sample(tree, targets, capacity, k, top=0):
    """The sample kernel's schedule; returns ``(leaf int32, priority,
    dependent global rounds)``."""
    size = tree.shape[0]
    depth, half = size.bit_length() - 1, size // 2
    t = targets.to(torch.float32).clone()
    node = torch.ones(t.shape, dtype=torch.long)
    staged = min(top, depth)
    stage = tree[:1 << staged].clone() if staged else None
    level, rounds, pri = 0, 0, None
    while level < staged - 1:
        lmass = stage[2 * node]
        right = t >= lmass
        t = torch.where(right, t - lmass, t)
        node = torch.where(right, 2 * node + 1, 2 * node)
        level += 1
    if level == depth - 1:
        pri = stage[node]
    while level < depth - 1:
        kk = min(k, depth - 1 - level)
        h = torch.arange(2, 2 << kk)
        lev = torch.floor(torch.log2(h.double())).long()
        sub = tree[(node[:, None] << lev) + h - (1 << lev)]   # one round
        rounds += 1
        hh = torch.ones_like(node)
        for _ in range(kk):
            lmass = sub.gather(1, (2 * hh - 2)[:, None])[:, 0]
            right = t >= lmass
            t = torch.where(right, t - lmass, t)
            hh = torch.where(right, 2 * hh + 1, 2 * hh)
        node = (node << kk) + hh - (1 << kk)
        level += kk
        if level == depth - 1:
            pri = sub.gather(1, (hh - 2)[:, None])[:, 0]
    leaf = node - half
    clamped = (leaf < 0) | (leaf > capacity - 1)
    leaf = leaf.clamp(0, capacity - 1)
    pri = torch.where(clamped, tree[leaf + half], pri)
    return leaf.to(torch.int32), pri, rounds


def _write_batch(capacity, n, seed):
    """``n`` leaves with duplicates, siblings and padding leaves (at or
    past ``capacity``, inside the tree), and values in (0, 2)."""
    rng = np.random.default_rng(seed)
    half = tref.tree_size(capacity) // 2
    idx = rng.integers(0, capacity, n)
    q = max(n // 8, 1)
    idx[:q] = idx[-q:]                                  # repeats
    idx[q:2 * q] = idx[2 * q:3 * q] ^ 1                 # siblings
    if half > capacity:
        idx[3 * q:3 * q + max(q // 4, 1)] = rng.integers(
            capacity, half, max(q // 4, 1))             # zero padding
    idx = np.minimum(idx, half - 1)
    rng.shuffle(idx)
    val = rng.uniform(0, 2, n).astype(np.float32)
    return (torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(val))


@pytest.mark.parametrize("n", [32, 256, 9984])
@pytest.mark.parametrize("capacity", [100_000, 300])
def test_write_schedule_is_bitwise_the_reference(capacity, n):
    tree = _tree(capacity, 11)
    idx, val = _write_batch(capacity, n, 100 + n)
    got, levels = emulate_set(tree.clone(), idx, val)
    want = tref.tree_set_ref(tree.clone(), idx, val)
    assert torch.equal(got, want)
    depth = tref.tree_depth(capacity)
    assert levels == [depth - 1] * -(-n // TILE)


def test_write_schedule_is_exact_on_any_tree():
    """Ancestors are recomputed from the tree's own nodes: inner nodes
    that do not hold the sum of their children stay as the reference
    leaves them."""
    capacity = 100_000
    tree = _tree(capacity, 5, consistent=False)
    idx, val = _write_batch(capacity, 256, 7)
    got, _ = emulate_set(tree.clone(), idx, val)
    assert torch.equal(got, tref.tree_set_ref(tree.clone(), idx, val))


def test_write_schedule_skips_an_index_outside_the_leaves():
    tree = _tree(500, 4)                                # 512 leaves
    idx = torch.tensor([3, -1, 512, 7, 3], dtype=torch.int32)
    val = torch.tensor([5., 6., 7., 8., 9.])
    got, _ = emulate_set(tree.clone(), idx, val)
    keep = torch.tensor([0, 3, 4])
    assert torch.equal(got, tref.tree_set_ref(tree.clone(), idx[keep],
                                              val[keep]))
    assert float(got[512 + 3]) == 9.0                   # the last write


def test_write_schedule_keeps_the_last_write_across_passes():
    """A leaf written in two passes keeps the later pass's value; inside
    a pass, the later position wins."""
    tree = _tree(100_000, 1)
    idx = torch.full((2500,), 17, dtype=torch.int32)
    idx[1:2400] = torch.arange(100, 2499, dtype=torch.int32)
    val = torch.arange(2500, dtype=torch.float32)
    got, levels = emulate_set(tree.clone(), idx, val)
    assert float(got[tree.shape[0] // 2 + 17]) == 2499.0
    assert levels == [17, 17, 17]
    assert torch.equal(got, tref.tree_set_ref(tree.clone(), idx, val))


def test_write_schedule_unique_matches_jax():
    import jax.numpy as jnp
    from repro.kernels.replay_tree import ref as jref
    capacity = 1000
    tree = _tree(capacity, 2)
    rng = np.random.default_rng(3)
    idx = rng.permutation(capacity)[:300].astype(np.int32)
    val = rng.uniform(0, 3, 300).astype(np.float32)
    want = jref.tree_set_ref(jnp.asarray(tree.numpy()), jnp.asarray(idx),
                             jnp.asarray(val))
    got, _ = emulate_set(tree, torch.from_numpy(idx), torch.from_numpy(val),
                         tile=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _targets(tree, b, seed):
    total = float(tree[1])
    rng = np.random.default_rng(seed)
    t = (rng.uniform(size=b) * total).astype(np.float32)
    t[0], t[1], t[2] = 0.0, total, np.nextafter(np.float32(total),
                                                np.float32(0))
    return torch.from_numpy(t)


@pytest.mark.parametrize("top", [0, 11])
@pytest.mark.parametrize("capacity", [100_000, 300])
@pytest.mark.parametrize("k", [3, 4, 5])
def test_sample_schedule_is_bitwise_the_reference(k, capacity, top):
    tree = _tree(capacity, 20 + k)
    t = _targets(tree, 256, k + top)
    leaf, pri, rounds = emulate_sample(tree, t, capacity, k, top)
    want = tref.tree_sample_ref(tree, t, capacity=capacity)
    assert torch.equal(leaf, want)
    assert torch.equal(pri, tref.tree_get_ref(tree, want))
    depth = tref.tree_depth(capacity)
    assert rounds == -(-max(depth - max(top, 1), 0) // k)


def test_sample_schedule_rounds_at_the_replay_depth():
    """Depth 18: 17 descents in 4 dependent rounds at k = 5 (a level a
    round: 17, and one more for the priority); 2 below 11 staged
    levels."""
    tree = _tree(100_000, 3)
    t = _targets(tree, 64, 4)
    assert emulate_sample(tree, t, 100_000, 5)[2] == 4
    assert emulate_sample(tree, t, 100_000, 5, top=11)[2] == 2
    assert emulate_sample(tree, t, 100_000, 6)[2] == 3


def test_sample_schedule_matches_jax_and_the_zero_padding():
    """A tree whose last leaves are zero padding (capacity 1000 of 1024):
    the target at the total walks into it and is clamped, as the JAX
    reference does."""
    import jax.numpy as jnp
    from repro.kernels.replay_tree import ref as jref
    capacity = 1000
    tree = _tree(capacity, 0)
    t = _targets(tree, 128, 1)
    want = np.array(jref.tree_sample_ref(jnp.asarray(tree.numpy()),
                                           jnp.asarray(t.numpy()),
                                           capacity=capacity))
    for k in (3, 4, 5):
        leaf, pri, _ = emulate_sample(tree, t, capacity, k, top=4)
        np.testing.assert_array_equal(leaf.numpy(), want)
        np.testing.assert_array_equal(pri.numpy(),
                                      tree[torch.from_numpy(want).long()
                                           + 1024].numpy())
    assert int(want[1]) == capacity - 1


def test_plans_are_launch_shapes_the_kernels_have():
    """``SAMPLE_PLAN`` is among the shapes the card sweep times, within the
    bounds the kernel source asserts, and ``build_defines`` gives every
    ``-D`` flag the source requires (a missing one stops the build)."""
    from repro_torch.launch import bwd_sweep
    src = tops.SOURCE.read_text()
    required = set(re.findall(r"!defined\((\w+)\)", src))
    given = {d[2:].split("=")[0] for d in tops.build_defines()}
    assert required == given == {"SAMPLE_K", "SAMPLE_LANES", "SAMPLE_TOP",
                                 "TREE_PDL"}
    assert tops.SAMPLE_PLAN in bwd_sweep.SAMPLE_SHAPES
    for k, lanes, top in bwd_sweep.SAMPLE_SHAPES:
        assert 1 <= k <= 6 and lanes in (1, 2, 4, 8, 16, 32)
        assert 0 <= top <= 13


# ------------------------------------------------------------ member axis

def _member_trees(e, capacity, seed):
    rng = np.random.default_rng(seed)
    trees = torch.stack([tref.tree_init_ref(capacity) for _ in range(e)])
    for m in range(e):
        tref.tree_set_ref(trees[m], torch.arange(capacity), torch.from_numpy(
            rng.uniform(1e-3, 2, capacity).astype(np.float32)))
    return trees, rng


@pytest.mark.parametrize("n", [8, 40])
def test_vmapped_set_is_each_members_solo_write(n):
    """``sumtree_set`` under vmap takes its vmap rule: every member's
    keep-last write into its own tree, as the solo write would."""
    trees, rng = _member_trees(3, 100, 1)
    idx = torch.from_numpy(rng.integers(0, 100, (3, n)).astype(np.int64))
    val = torch.from_numpy(rng.uniform(0, 2, (3, n)).astype(np.float32))
    want = trees.clone()
    for m in range(3):
        tops.sumtree_set(want[m], idx[m], val[m])

    def write(t, i, v):
        tops.sumtree_set(t, i, v)
        return t.sum()
    torch.func.vmap(write)(trees, idx, val)
    assert torch.equal(trees, want)
    assert torch.equal(tops.sumtree_set_members(want.clone(), idx, val),
                       want)


def test_vmapped_sample_is_each_members_solo_sample():
    trees, rng = _member_trees(4, 1000, 2)
    t = torch.from_numpy(rng.uniform(size=(4, 64)).astype(np.float32)) \
        * trees[:, 1:2]
    t[:, 0], t[:, 1] = 0.0, trees[:, 1]
    leaf, pri = torch.func.vmap(lambda tr, x: tops.sumtree_sample(
        tr, x, capacity=1000))(trees, t)
    for m in range(4):
        want_leaf, want_pri = tops.sumtree_sample(trees[m], t[m],
                                                  capacity=1000)
        assert torch.equal(leaf[m], want_leaf)
        assert torch.equal(pri[m], want_pri)


def test_vmapped_set_checks_every_members_indices():
    trees, _ = _member_trees(2, 16, 3)
    idx = torch.tensor([[0, 1], [2, 16]])
    with pytest.raises(IndexError, match="outside the 16 leaves"):
        torch.func.vmap(lambda t, i, v: tops.sumtree_set(t, i, v).sum())(
            trees, idx, torch.ones(2, 2))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def test_cuda_member_sample_is_solo_launches_and_plain(cuda_device):
    trees, rng = _member_trees(5, 100_000, 4)
    trees = trees.to(cuda_device)
    t = torch.from_numpy(rng.uniform(size=(5, 256)).astype(
        np.float32)).to(cuda_device) * trees[:, 1:2]
    before = tops.launch_count("sample")
    leaf, pri = tops.sumtree_sample_members(trees, t, capacity=100_000)
    assert tops.launch_count("sample") - before == 1
    for m in range(5):
        sl, sp = tops.sumtree_sample(trees[m], t[m], capacity=100_000)
        assert torch.equal(leaf[m], sl) and torch.equal(pri[m], sp)
    want = tref.tree_sample_members_ref(trees, t, capacity=100_000)
    assert torch.equal(leaf, want)
    assert torch.equal(pri, tref.tree_get_members_ref(trees, want))


@pytest.mark.parametrize("n", [32, 256, 2500])
def test_cuda_member_set_is_solo_launches_and_plain(cuda_device, n):
    trees, rng = _member_trees(5, 100_000, 5)
    trees = trees.to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, 100_000, (5, n)).astype(
        np.int32)).to(cuda_device)
    idx[:, n // 2:] = idx[:, :n - n // 2]            # repeats: keep-last
    val = torch.from_numpy(rng.uniform(0, 2, (5, n)).astype(
        np.float32)).to(cuda_device)
    before = tops.launch_count("set")
    got = tops.sumtree_set_members(trees.clone(), idx, val)
    assert tops.launch_count("set") - before == 1
    solo = trees.clone()
    for m in range(5):
        tops.sumtree_set(solo[m], idx[m], val[m])
    assert torch.equal(got, solo)
    assert torch.equal(got, tref.tree_set_members_ref(trees.clone(), idx,
                                                      val))
