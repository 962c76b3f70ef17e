"""The port's stack backward against the reference's Pallas backward.

On the CPU, ``dense_stack`` differentiates its plain version through
autograd (``dense_stack_grads_ref``); dx, every dW_i and every db_i must
match ``jax.vjp`` of the reference's ``dense_stack(impl="pallas",
interpret=True)``, whose backward is the TPU kernel ``_bwd_kernel``, on the
same seeded inputs and cotangent: every fused connectivity x activation at
a ragged shape, and each connectivity at a narrow ``phi_sa``-like shape
(the training path's OFENet stack, swish). Tolerance: the repo's gradient
bar, rtol 1e-3 and atol 1e-3 * max|want| (float32 reassociation).

The backward's planner (``plan_bwd``: tile shape and split of K), its
choice between the 16-byte and the scalar loads (``vec_aligned``) and its
reusable tile counters are plain Python, tested here on the CPU.

On the card (skipped without one; no JAX imported there) the backward
kernels (``csrc/dense_stack_bwd.cu``) are held against the plain version
at the ragged and narrow shapes, the critic's and the actor's (whose
stream of row stride 4355 takes the scalar loads) and two ragged shapes
of at least 128 rows, must be bitwise equal across two calls, and must
compute only the gradients autograd asks for:

    python -m pytest tests/test_torch_stack_backward.py -k cuda
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.dense_block import stack as tstack

CONNS = ("densenet", "d2rl", "mlp")
ACTS = ("swish", "relu", "tanh", "identity")
# (M, d0, U, L): ragged, and phi_sa-like (wide input, narrow U, 4 layers)
RAGGED, PHI_SA = (9, 5, 24, 3), (16, 20, 16, 4)
# the training path's critic and actor stacks at batch 256
CRITIC, ACTOR = (256, 516, 2048, 2), (256, 259, 2048, 2)
# ragged and large enough for the register tile: no size a multiple of 4
# (scalar loads), and one whose strides allow the 16-byte loads
RAGGED_RT, RAGGED_RT_VEC = (201, 37, 301, 3), (203, 36, 300, 3)


def _make(conn, m, d0, u, L, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d0)).astype(np.float32)
    ws = [(rng.standard_normal((k, u)) / np.sqrt(k)).astype(np.float32)
          for k in (tstack.in_dim(conn, i, d0, u) for i in range(L))]
    bs = [(rng.standard_normal((u,)) * 0.3).astype(np.float32)
          for _ in range(L)]
    g = rng.standard_normal(
        (m, tstack.feature_dim(conn, L, d0, u))).astype(np.float32)
    return x, ws, bs, g


def _assert_grads(got, want, what):
    for name, a, b in zip(("dx",) + tuple(f"d{i}" for i in
                                          range(len(got) - 1)), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-3,
                                   atol=1e-3 * np.abs(b).max(),
                                   err_msg=f"{what} {name}")


def _flat(dx, dws, dbs):
    return [dx, *dws, *dbs]


@pytest.mark.parametrize(
    "conn,act,shape",
    [(c, a, RAGGED) for c in CONNS for a in ACTS]
    + [(c, "swish", PHI_SA) for c in CONNS],
    ids=[f"{c}-{a}-ragged" for c in CONNS for a in ACTS]
    + [f"{c}-swish-phi_sa" for c in CONNS])
def test_plain_backward_matches_jax_pallas_backward(conn, act, shape):
    import jax
    import jax.numpy as jnp
    from repro.kernels.dense_block import stack as jstack
    m, d0, u, L = shape
    x, ws, bs, g = _make(conn, m, d0, u, L, seed=7 * len(conn) + L)
    got = tstack.dense_stack_grads_ref(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(b) for b in bs], torch.from_numpy(g),
        connectivity=conn, activation=act)
    _, vjp = jax.vjp(lambda x, ws, bs: jstack.dense_stack(
        x, ws, bs, connectivity=conn, activation=act, impl="pallas",
        interpret=True, block_m=8), jnp.asarray(x),
        tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    jdx, jdws, jdbs = vjp(jnp.asarray(g))
    _assert_grads([t.numpy() for t in _flat(*got)],
                  _flat(jdx, jdws, jdbs), f"{conn}/{act}")


def test_dense_stack_autograd_is_the_plain_backward_on_cpu():
    """``dense_stack`` on CPU tensors differentiates the plain version."""
    x, ws, bs, g = _make("densenet", *RAGGED, seed=0)
    var = [torch.from_numpy(a).requires_grad_(True) for a in (x, *ws, *bs)]
    out = tstack.dense_stack(var[0], var[1:4], var[4:])
    got = torch.autograd.grad(out, var, torch.from_numpy(g))
    want = tstack.dense_stack_grads_ref(var[0], var[1:4], var[4:],
                                        torch.from_numpy(g))
    for a, b in zip(got, _flat(*want)):
        assert torch.equal(a, b)
    assert tstack.bwd_launch_count() == 0


# (m, n, k, dx) of every product of the critic and actor backwards at
# M=256: dW_i is (in_i, U) over the batch, dx_i is (M, in_i) over U
MAIN_PRODUCTS = [(k, 2048, 256, False) for k in (516, 2564, 259, 2307)] \
    + [(256, k, 2048, True) for k in (516, 2564, 259, 2307)]
# products of the narrow OFENet stacks (U=64) and of small shapes
NARROW_PRODUCTS = [(3 + 64 * i, 64, 256) for i in range(4)] \
    + [(256, 260 + 64 * i, 64) for i in range(4)] \
    + [(9, 24, 40), (40, 24, 9), (127, 2048, 2048), (2048, 127, 2048),
       (2048, 2048, 127)]


@pytest.mark.parametrize("m,n,k,dx", MAIN_PRODUCTS + [
    (m, n, k, dx) for m, n, k in NARROW_PRODUCTS for dx in (False, True)]
    + [(201, 338, 301, True), (640, 301, 201, False)])
def test_plan_bwd_splits_cover_k_exactly(m, n, k, dx):
    config, tiles, splits, per_split = tstack.plan_bwd(m, n, k, 132, dx=dx)
    bm, bn, bk = {**dict(enumerate(tstack._CONFIGS)),
                  **tstack._RT_CONFIGS}[config]
    chunks = -(-k // bk)
    assert tiles == -(-m // bm) * -(-n // bn)
    # every split gets at least one chunk, and the splits cover K
    assert splits >= 1 and per_split >= 1
    assert (splits - 1) * per_split < chunks <= splits * per_split
    if config in tstack._RT_CONFIGS and splits > 1:
        assert per_split >= tstack._RT_MIN_CHUNKS_PER_SPLIT


@pytest.mark.parametrize("m,n,k,dx", MAIN_PRODUCTS)
def test_plan_bwd_takes_the_register_tile_at_the_main_path(m, n, k, dx):
    config, tiles, splits, _ = tstack.plan_bwd(m, n, k, 132, dx=dx)
    assert config in tstack._RT_CONFIGS
    # dW reduces over the batch unsplit; dx splits its long reduction
    assert (splits > 1) == dx
    for forced in tstack._RT_CONFIGS:
        assert tstack.plan_bwd(m, n, k, 132, forced, dx=dx)[0] == forced


@pytest.mark.parametrize("m,n,k", NARROW_PRODUCTS)
def test_plan_bwd_keeps_the_old_configs_below_128(m, n, k):
    for dx in (False, True):
        assert tstack.plan_bwd(m, n, k, 132, dx=dx) \
            == tstack.plan(m, n, k, 132)
    with pytest.raises(ValueError, match="below the register tile"):
        tstack.plan_bwd(m, n, k, 132, 3)


def test_plan_bwd_counts_waves():
    """dW: 128x128 tiles where they are a wave or more and the stream takes
    16-byte copies (the critic's layer 1: 336 tiles), else 128x64 (the
    actor's stream, row stride 4355). dx: one block per SM, so the critic's
    layer-1 dx (82 tiles of 128x64) splits K 3 ways (246 blocks, two
    waves) rather than 4 (328, three waves)."""
    assert tstack.plan_bwd(2564, 2048, 256, 132)[:3] == (3, 336, 1)
    assert tstack.plan_bwd(2307, 2048, 256, 132, vec=False)[:3] \
        == (4, 608, 1)
    assert tstack.plan_bwd(256, 2564, 2048, 132, dx=True)[:3] == (4, 82, 3)
    # a split costs: the actor's layer-0 dx (10 tiles) stops at 6 splits,
    # not at the 13 that one wave would hold
    assert tstack.plan_bwd(256, 259, 2048, 132, dx=True)[:3] == (4, 10, 6)
    with pytest.raises(ValueError, match="not a register-tiled config"):
        tstack.plan_bwd(2564, 2048, 256, 132, 2)


def test_plain_backward_takes_relu_slope_at_the_given_preactivations():
    """``zs`` moves only relu's slope: with the plain forward's own
    pre-activations nothing changes, and flipping one sign changes the
    gradients only through that element."""
    conn, (m, d0, u, L) = "densenet", RAGGED
    x, ws, bs, g = _make(conn, m, d0, u, L, seed=3)
    tx, tws, tbs, tg = (torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                        [torch.from_numpy(b) for b in bs], torch.from_numpy(g))
    plain = tstack.dense_stack_grads_ref(tx, tws, tbs, tg, connectivity=conn,
                                         activation="relu")
    relu_zs, stream = [], tx            # the relu stack's pre-activations
    for w, b in zip(tws, tbs):
        z = stream @ w + b
        relu_zs.append(z)
        stream = torch.cat([stream, torch.relu(z)], 1)
    relu_zs = torch.cat(relu_zs, 1)
    same = tstack.dense_stack_grads_ref(tx, tws, tbs, tg, connectivity=conn,
                                        activation="relu", zs=relu_zs)
    for a, b in zip(_flat(*plain), _flat(*same)):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)
    flipped = relu_zs.clone()
    r, c = 2, (L - 1) * u + 5           # last layer, row 2, unit 5
    flipped[r, c] = -flipped[r, c]
    moved = tstack.dense_stack_grads_ref(tx, tws, tbs, tg, connectivity=conn,
                                         activation="relu", zs=flipped)
    db_last = moved[2][-1] - same[2][-1]
    assert torch.allclose(db_last[5], (1 if relu_zs[r, c] <= 0 else -1)
                          * tg[r, d0 + (L - 1) * u + 5], atol=1e-6)
    assert torch.count_nonzero(db_last) == 1


@pytest.mark.parametrize("m,n,k,dx", MAIN_PRODUCTS)
def test_bwd_sweep_candidates_hold_the_plan(m, n, k, dx):
    """The card sweep (``launch/bwd_sweep.py``) times every plan the
    planner may pick, at both tile shapes."""
    from repro_torch.launch import bwd_sweep
    cands = bwd_sweep.candidates(m, n, k, 132, dx)
    assert {c for c, _, _, _ in cands} == set(tstack._RT_CONFIGS)
    for vec in (True, False):
        assert tstack.plan_bwd(m, n, k, 132, dx=dx, vec=vec) in cands
    for config, tiles, splits, per in cands:
        chunks = -(-k // tstack._RT_CONFIGS[config][2])
        assert (splits - 1) * per < chunks <= splits * per


def test_bwd_sweep_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the sweep would run")
    from repro_torch.launch import bwd_sweep
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bwd_sweep.sweep()


def test_vec_aligned_follows_the_pointer_and_the_strides():
    assert tstack.vec_aligned((4096, 2048), (1024, 4612))
    assert tstack.vec_aligned()
    assert not tstack.vec_aligned((4096, 2048), (1028, 4612))   # address
    assert not tstack.vec_aligned((4096, 4355))                 # stride
    assert not tstack.vec_aligned((4100, 2048))
    # the actor's output stream: (256, 259 + 2 * 2048), row stride 4355
    stream = torch.empty((256, 4355), dtype=torch.float32)
    assert stream.data_ptr() % 16 == 0
    view = stream[:, :2307]
    assert tstack.operand(view) == (stream.data_ptr(), 4355)
    assert not tstack.vec_aligned(tstack.operand(view))
    # the critic's (row stride 516 + 4096 = 4612) takes 16-byte loads,
    # from column 0 but not from a column off a multiple of 4
    critic = torch.empty((256, 4612), dtype=torch.float32)
    assert tstack.vec_aligned(tstack.operand(critic[:, :2564]))
    assert tstack.vec_aligned(tstack.operand(critic, 516))
    assert not tstack.vec_aligned(tstack.operand(critic, 259))


def test_tile_counters_are_one_zeroed_buffer_per_stream_grown_on_demand():
    dev = torch.device("cpu")
    first = tstack._tile_counters(10, dev, stream=12345)
    assert first.dtype == torch.int32 and first.numel() >= 10
    assert int(first.abs().sum()) == 0
    assert tstack._tile_counters(5, dev, stream=12345) is first
    assert tstack._tile_counters(first.numel(), dev, stream=12345) is first
    other = tstack._tile_counters(10, dev, stream=54321)
    assert other is not first
    grown = tstack._tile_counters(first.numel() + 1, dev, stream=12345)
    assert grown.numel() > first.numel() and int(grown.abs().sum()) == 0
    assert tstack._tile_counters(1, dev, stream=12345) is grown


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_grads(dev, x, ws, bs, g, conn, act, need=None):
    var = [torch.from_numpy(a).to(dev) for a in (x, *ws, *bs)]
    need = need or [True] * len(var)
    for t, n in zip(var, need):
        t.requires_grad_(n)
    out = tstack.dense_stack(var[0], var[1:1 + len(ws)], var[1 + len(ws):],
                             connectivity=conn, activation=act)
    wanted = [t for t in var if t.requires_grad]
    grads = torch.autograd.grad(out, wanted, torch.from_numpy(g).to(dev))
    return [gr.cpu().numpy() for gr in grads]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("conn", CONNS)
def test_cuda_backward_matches_plain_and_repeats_bitwise(cuda_device, conn,
                                                         act):
    torch.backends.cuda.matmul.allow_tf32 = False
    for m, d0, u, L in (RAGGED, PHI_SA, CRITIC, ACTOR, RAGGED_RT,
                        RAGGED_RT_VEC):
        x, ws, bs, g = _make(conn, m, d0, u, L, seed=L)
        # relu's slope at the kernel forward's own pre-activations
        zs = torch.empty((m, L * u), device=cuda_device)
        tstack._kernel_forward(
            torch.from_numpy(x).to(cuda_device),
            [torch.from_numpy(w).to(cuda_device) for w in ws],
            [torch.from_numpy(b).to(cuda_device) for b in bs], conn, act, zs)
        want = tstack.dense_stack_grads_ref(
            torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(b) for b in bs], torch.from_numpy(g),
            connectivity=conn, activation=act, zs=zs.cpu())
        before = tstack.bwd_launch_count()
        got = _kernel_grads(cuda_device, x, ws, bs, g, conn, act)
        again = _kernel_grads(cuda_device, x, ws, bs, g, conn, act)
        torch.cuda.synchronize()
        assert tstack.bwd_launch_count() - before == 2
        _assert_grads(got, [t.numpy() for t in _flat(*want)],
                      f"{conn}/{act} M={m}")
        for a, b in zip(got, again):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("conn", CONNS)
def test_cuda_backward_computes_only_what_is_asked(cuda_device, conn):
    """dx alone (the actor loss through the critics), and the weights
    alone (the critic loss)."""
    x, ws, bs, g = _make(conn, *PHI_SA, seed=1)
    want = _flat(*tstack.dense_stack_grads_ref(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(b) for b in bs], torch.from_numpy(g),
        connectivity=conn))
    n = len(ws)
    only_dx = _kernel_grads(cuda_device, x, ws, bs, g, conn, "swish",
                            need=[True] + [False] * 2 * n)
    _assert_grads(only_dx, [want[0].numpy()], f"{conn} dx only")
    only_w = _kernel_grads(cuda_device, x, ws, bs, g, conn, "swish",
                           need=[False] + [True] * 2 * n)
    _assert_grads([np.zeros(1)] + only_w,
                  [np.zeros(1)] + [t.numpy() for t in want[1:]],
                  f"{conn} weights only")
