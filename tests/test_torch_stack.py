"""The port's fused DenseNet stack against the JAX reference.

On the CPU the port's ``dense_stack`` runs its plain PyTorch version; it
must match the reference's Pallas kernel (interpret mode) and its XLA
streaming twin on the same seeded inputs, for every fused connectivity and
activation, with lane-unaligned (d0=5, U=24) and 128-aligned dims, at the
bar of ``tests/test_dense_stack.py`` (rtol = atol = 1e-5: float32
reassociation only). The CUDA kernel is held against the plain version on
the card (skipped without one); those tests import no JAX, so they run on
a machine with a card and no JAX:

    python -m pytest tests/test_torch_stack.py -k cuda
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.dense_block import stack as tstack

CONNS = ("densenet", "d2rl", "mlp")
ACTS = ("swish", "silu", "relu", "tanh", "identity")


def _make(conn, L, d0, u, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d0)).astype(np.float32)
    # fan-in scaled, so activations stay O(1) through identity layers
    ws = [(rng.standard_normal((k, u)) / np.sqrt(k)).astype(np.float32)
          for k in (tstack.in_dim(conn, i, d0, u) for i in range(L))]
    bs = [(rng.standard_normal((u,)) * 0.3).astype(np.float32)
          for _ in range(L)]
    return x, ws, bs


def _torch(x, ws, bs, device="cpu"):
    t = lambda a: torch.from_numpy(a).to(device)
    return t(x), [t(w) for w in ws], [t(b) for b in bs]


@pytest.mark.parametrize("dims", [(5, 24), (128, 128)],
                         ids=["ragged", "aligned"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("conn", CONNS)
def test_plain_stack_matches_jax_pallas_and_xla(conn, act, dims):
    import jax.numpy as jnp
    from repro.kernels.dense_block import stack as jstack
    d0, u = dims
    x, ws, bs = _make(conn, L=3, d0=d0, u=u, m=9,
                      seed=10 * CONNS.index(conn) + ACTS.index(act))
    tx, tws, tbs = _torch(x, ws, bs)
    got = tstack.dense_stack(tx, tws, tbs, connectivity=conn,
                             activation=act).numpy()
    jx = jnp.asarray(x)
    jws = tuple(jnp.asarray(w) for w in ws)
    jbs = tuple(jnp.asarray(b) for b in bs)
    for impl, kw in (("pallas", dict(interpret=True, block_m=8)),
                     ("xla", {})):
        want = jstack.dense_stack(jx, jws, jbs, connectivity=conn,
                                  activation=act, impl=impl, **kw)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=impl)
    assert got.shape == (9, tstack.feature_dim(conn, 3, d0, u))


def test_plain_stack_grads_match_jax():
    """On the CPU the plain version differentiates through autograd; its
    gradients match the reference's XLA twin and its Pallas backward
    kernel (``_bwd_kernel``, interpret mode)."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.dense_block import stack as jstack
    conn = "d2rl"
    x, ws, bs = _make(conn, L=3, d0=5, u=24, m=9, seed=3)
    v = np.random.default_rng(4).standard_normal((9, 24)).astype(np.float32)
    tx, tws, tbs = _torch(x, ws, bs)
    for t in [tx, *tws, *tbs]:
        t.requires_grad_(True)
    loss = torch.mean(tstack.dense_stack(tx, tws, tbs, connectivity=conn)
                      * torch.from_numpy(v))
    loss.backward()
    got = [tx.grad] + [w.grad for w in tws] + [b.grad for b in tbs]
    for impl, kw in (("xla", {}),
                     ("pallas", dict(interpret=True, block_m=8))):
        def jloss(x, ws, bs):
            return jnp.mean(jstack.dense_stack(
                x, ws, bs, connectivity=conn, impl=impl, **kw) * v)
        jg = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(x), tuple(map(jnp.asarray, ws)),
            tuple(map(jnp.asarray, bs)))
        want = [jg[0], *jg[1], *jg[2]]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                       atol=2e-5, err_msg=impl)


def test_stack_rejects_bad_config():
    x, ws, bs = _torch(*_make("mlp", L=1, d0=4, u=8, m=2, seed=0))
    with pytest.raises(ValueError, match="not fused"):
        tstack.dense_stack(x, ws, bs, connectivity="resnet")
    with pytest.raises(ValueError, match="not fused"):
        tstack.dense_stack(x, ws, bs, activation="gelu")
    with pytest.raises(ValueError, match="at least one layer"):
        tstack.dense_stack(x, [], [])


def test_stream_caches_raise_on_a_miss_during_capture(monkeypatch):
    """The split counters and the backward's side stream are cached per
    stream; under CUDA graph capture a miss raises (a warm-up call on the
    capture stream fills them) and a hit returns the cached object."""
    dev, key = torch.device("cpu"), -12345
    monkeypatch.setattr(tstack, "_counter_bufs", {})
    monkeypatch.setattr(tstack, "_side_streams", {})
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    buf = tstack._tile_counters(10, dev, key)        # filled, not capturing
    capturing[0] = True
    assert tstack._tile_counters(10, dev, key) is buf
    for call in (lambda: tstack._tile_counters(10, dev, key + 1),
                 lambda: tstack._tile_counters(buf.numel() + 1, dev, key),
                 lambda: tstack._side_stream(
                     dev, type("S", (), {"cuda_stream": key})())):
        with pytest.raises(RuntimeError, match="capture"):
            call()


def test_launch_plan_fills_the_card_at_serving_slots():
    """Serving slots of 1-32 rows get their parallelism from the columns
    and a split of K: the actor's wide layer launches one wave of about 2
    blocks per SM of the weight-streaming kernel (128-column strips, K
    split by rows), and so does the register tile at the batch of 256
    (every connectivity's, over its transposed input); dense_tile.cuh,
    which mlp and d2rl took there before (``transposed=False``), >= 2
    blocks per SM."""
    for m in (1, 8, 32):
        config, tiles, splits, rows = tstack.plan_fwd(m, 2048, 2307, 132)
        assert config == tstack._STREAM_CONFIG
        assert tiles == 2048 // tstack._STREAM_COLS
        assert 2 * 132 - tiles < tiles * splits <= 2 * 132
        assert (splits - 1) * rows < 2307 <= splits * rows
    config, tiles, splits, per_split = tstack.plan_fwd(256, 2048, 2307, 132)
    bm, bn, bk = tstack._RT_CONFIGS[config]
    assert tiles == (256 // bm) * (2048 // bn)
    assert 2 * 132 - tiles < tiles * splits <= 2 * 132
    assert (splits - 1) * per_split < -(-2307 // bk) <= splits * per_split
    config, tiles, splits, per_split = tstack.plan(256, 2048, 2307, 132)
    assert tstack.plan_fwd(256, 2048, 2307, 132, transposed=False) \
        == (config, tiles, splits, per_split)
    assert tiles * splits >= 2 * 132
    assert tstack.plan(4, 8, 3, 132)[2] == 1          # tiny K: no split
    assert tstack.plan_fwd(4, 8, 3, 132)[2] == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("act", ("swish", "relu", "tanh", "identity"))
@pytest.mark.parametrize("conn", CONNS)
def test_cuda_kernel_matches_plain(cuda_device, conn, act):
    """Every forward kernel against the plain version: the streaming kernel
    (1, 2, 4, 5, 16 and 32 rows: each of its row-count cases, 1 to 32;
    densenet at U >= 128 only), the whole-stack kernel (densenet at U < 128:
    5, 4 and 256 rows, U = 61 at 37 rows (4-byte W copies) and U = 100 at
    7 (128-column ring rows); one launch a stack), dense_tile.cuh (mlp and
    d2rl at 37 rows or more below U=128 or M=128), the register tile over
    a transposed input (the actor's widths at 256 rows and a ragged shape
    of 201 rows: densenet over stream^T, mlp and d2rl over h^T); within
    1e-4, one launch per layer (per stack on the whole-stack kernel), and
    two calls bitwise equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for L, d0, u, m in ((3, 7, 40, 5), (2, 259, 2048, 1), (2, 259, 2048, 2),
                        (4, 3, 64, 4), (2, 259, 2048, 16), (2, 259, 2048, 32),
                        (4, 3, 64, 256), (2, 259, 2048, 256),
                        (3, 37, 301, 201), (3, 5, 61, 37), (2, 9, 100, 7)):
        x, ws, bs = _make(conn, L=L, d0=d0, u=u, m=m, seed=L)
        want = tstack.dense_stack(*_torch(x, ws, bs), connectivity=conn,
                                  activation=act).numpy()
        before = tstack.launch_count()
        inputs = _torch(x, ws, bs, cuda_device)
        got = tstack.dense_stack(*inputs, connectivity=conn, activation=act)
        again = tstack.dense_stack(*inputs, connectivity=conn,
                                   activation=act)
        torch.cuda.synchronize()
        plan = tstack.plan_fwd(m, u, d0, 132,
                               stack=(d0, L) if conn == "densenet" else None)
        whole = tstack.fwd_kernel_of(plan[0]) == "whole"
        assert tstack.launch_count() - before == 2 * (1 if whole else L)
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
        assert torch.equal(got, again)
