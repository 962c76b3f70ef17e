"""The port's stack backward against the reference's Pallas backward.

On the CPU, ``dense_stack`` differentiates its plain version through
autograd (``dense_stack_grads_ref``); dx, every dW_i and every db_i must
match ``jax.vjp`` of the reference's ``dense_stack(impl="pallas",
interpret=True)``, whose backward is the TPU kernel ``_bwd_kernel``, on the
same seeded inputs and cotangent: every fused connectivity x activation at
a ragged shape, and each connectivity at a narrow ``phi_sa``-like shape
(the training path's OFENet stack, swish). Tolerance: the repo's gradient
bar, rtol 1e-3 and atol 1e-3 * max|want| (float32 reassociation).

The plain backward is also held to the reference's at the OFENet stacks'
own shapes (``phi_s`` d0=3 and ``phi_sa`` d0=260, U=64, L=4, M=256) and
at mlp and d2rl stacks of U=128 at M=256 (the register tile's forward).

The backward's planner (``plan_bwd``: tile shape and split of K), its
choice between the 16-byte and the scalar loads (``vec_aligned``), its
reusable tile counters, the whole-stack kernel's shared-memory budget
(``whole_bwd_smem``) and the launches of ``_kernel_backward`` are plain
Python, tested here on the CPU: against a recording stand-in for the CUDA
library (a narrow densenet stack in ONE launch of the whole-stack kernel,
the rest on the per-layer kernels) and against an emulating one, which
runs the whole-stack kernel's contract on the CPU memory the wrapper hands
it, so its arguments (which dW, db and dx, from which layer) are held to
the plain backward here.

On the card (skipped without one; no JAX imported there) the backward
kernels (``csrc/dense_stack_bwd.cu``) are held against the plain version
at the ragged and narrow shapes, the OFENet stacks at M=256 (the
whole-stack kernel, at each of its row tiles and against the per-layer
kernels), the critic's and the actor's (whose stream of row stride 4355
takes the scalar loads) and two ragged shapes of at least 128 rows, must
be bitwise equal across two calls, and must compute only the gradients
autograd asks for:

    python -m pytest tests/test_torch_stack_backward.py -k cuda
"""
import contextlib
import ctypes

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
# the OFENet stacks at the batch (the whole-stack kernel), and mlp/d2rl
# stacks at the register tile's forward
PHI_S, PHI_SA_FULL = (256, 3, 64, 4), (256, 260, 64, 4)
WIDE_MLP = (256, 3, 128, 3)


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
    + [(c, "swish", PHI_SA) for c in CONNS]
    + [("densenet", "swish", PHI_S), ("densenet", "swish", PHI_SA_FULL),
       ("mlp", "swish", WIDE_MLP), ("d2rl", "swish", WIDE_MLP)],
    ids=[f"{c}-{a}-ragged" for c in CONNS for a in ACTS]
    + [f"{c}-swish-phi_sa" for c in CONNS]
    + ["densenet-swish-ofenet_phi_s", "densenet-swish-ofenet_phi_sa",
       "mlp-swish-wide", "d2rl-swish-wide"])
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
    # the batch in row tiles of 8 (of 128 at the full batch: fewer
    # interpreted grid steps)
    jout, vjp = jax.vjp(lambda x, ws, bs: jstack.dense_stack(
        x, ws, bs, connectivity=conn, activation=act, impl="pallas",
        interpret=True, block_m=8 if m < 128 else 128), jnp.asarray(x),
        tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    jdx, jdws, jdbs = vjp(jnp.asarray(g))
    _assert_grads([t.numpy() for t in _flat(*got)],
                  _flat(jdx, jdws, jdbs), f"{conn}/{act}")
    # the forward the gradients are of, at the forward's bar (1e-5)
    out = tstack.dense_stack_ref(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
        [torch.from_numpy(b) for b in bs], connectivity=conn,
        activation=act).numpy()
    want = np.asarray(jout)
    np.testing.assert_allclose(out, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


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
# a wide stack's thin products: only the layer's input width (dW's rows,
# dx's columns) under 128, from 32 wide. The presets' first layers: the
# actor and the critic of fig10-ablation and table1-ours (d0 35 and 68,
# U=128, batch 128), rl-distributed's actor (67); and the edges
THIN_PRODUCTS = [(d0, u, m, False) for m, d0, u in (
    (128, 35, 128), (128, 68, 128), (128, 67, 128))] + [
        (m, d0, u, True) for m, d0, u in (
            (128, 35, 128), (128, 68, 128), (128, 67, 128))] + [
    (127, 2048, 2048, False), (2048, 127, 2048, True), (32, 128, 128, False),
    (128, 32, 128, True)]
# thinner ones keep dense_tile.cuh, the faster there: fig3-width's first
# layer at 2048 units (d0 3 and 4, batch 256)
TOO_THIN = [(d0, 2048, 256, False) for d0 in (3, 4)] \
    + [(256, d0, 2048, True) for d0 in (3, 4)] \
    + [(31, 128, 128, False), (128, 31, 128, True)]


def _thin(m, n, k, dx):
    """Whether only the layer's input width (dW's rows, dx's columns) is
    under 128, and it is at least 32."""
    return min(m, n) < 128 and k >= 128 and (m if dx else n) >= 128 \
        and (n if dx else m) >= 32


@pytest.mark.parametrize("m,n,k,dx", MAIN_PRODUCTS + [
    (m, n, k, dx) for m, n, k in NARROW_PRODUCTS for dx in (False, True)]
    + [(201, 338, 301, True), (640, 301, 201, False)] + THIN_PRODUCTS
    + TOO_THIN)
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
    """Below 128 on a side other than the layer's input width (a narrow
    stack's U, a batch under 128) the forward's ``plan`` (dense_tile.cuh);
    a thin product (``THIN_PRODUCTS``) takes the register tile."""
    for dx in (False, True):
        if _thin(m, n, k, dx):
            assert tstack.plan_bwd(m, n, k, 132, dx=dx)[0] \
                in tstack._RT_CONFIGS
            continue
        assert tstack.plan_bwd(m, n, k, 132, dx=dx) \
            == tstack.plan(m, n, k, 132)
        with pytest.raises(ValueError, match="below the register tile"):
            tstack.plan_bwd(m, n, k, 132, 3, dx=dx)


@pytest.mark.parametrize("m,n,k,dx", THIN_PRODUCTS)
def test_plan_bwd_takes_the_register_tile_for_thin_products(m, n, k, dx):
    """A wide stack's thin products run the register tile (its 128x64
    tile, the ragged edge masked): one row tile of dW, one column tile of
    dx; dx unsplit below 256 of reduction (U=128), split over a long U as
    a wide dx is."""
    assert _thin(m, n, k, dx)
    config, tiles, splits, _ = tstack.plan_bwd(m, n, k, 132, dx=dx)
    assert config == 4
    thin = m if not dx else n
    assert tiles == -(-thin // (128 if not dx else 64)) * -(
        -(n if not dx else m) // (64 if not dx else 128))
    if dx:
        assert (splits > 1) == (k >= 256)
    for forced in tstack._RT_CONFIGS:
        assert tstack.plan_bwd(m, n, k, 132, forced, dx=dx)[0] == forced


@pytest.mark.parametrize("m,n,k,dx", TOO_THIN)
def test_plan_bwd_keeps_dense_tile_for_the_thinnest_products(m, n, k, dx):
    """Under 32 wide (fig3-width's 3- and 4-wide first layer) a thin
    product keeps the forward's ``plan``: ``dense_tile.cuh`` ran it faster
    than the register tile on the card."""
    assert not _thin(m, n, k, dx)
    assert tstack.plan_bwd(m, n, k, 132, dx=dx) == tstack.plan(m, n, k, 132)


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


# (name, d0, U, L) of the OFENet stacks
OFENET = {"phi_s": (3, 64, 4), "phi_sa": (260, 64, 4)}


@pytest.mark.parametrize("name", sorted(OFENET))
@pytest.mark.parametrize("rows", (4, 8, 16))
def test_whole_bwd_smem_takes_the_ofenet_stacks(name, rows):
    """The backward's whole-stack kernel at phi_s and phi_sa: the larger of
    a sweep block's shared memory (its rows of the gradient stream, rows
    of d0 + 4 U rounded up to 4 floats; its rows of gz, 64 floats; the W
    ring, 6 stages of 32 rows of 64 + 4 floats) and a reduction task's (4
    stages of 32 batch rows of a 32-column stream tile and of gz), within
    the card's 227 KB a block."""
    d0, u, n_layers = OFENET[name]
    width = d0 + n_layers * u
    sweep = rows * (width + -width % 4) + rows * 64 + 6 * 32 * 68
    want = 4 * max(sweep, 4 * 32 * (32 + 64))
    assert tstack.whole_bwd_smem(d0, u, n_layers, rows) == want
    assert want <= tstack._SMEM_MAX
    assert tstack._WHOLE_BWD_ROWS in tstack._WHOLE_BWD_ROW_TILES


@pytest.mark.parametrize("d0,u,n_layers,rows,fits", [
    (3, 64, 4, 4, True), (260, 64, 4, 16, True), (3, 127, 16, 8, True),
    (3, 100, 4, 16, False),             # 16 rows x 128 columns of gz
    (3, 64, 4, 2, False), (3, 64, 4, 32, False),    # no such row tile
    (10000, 64, 4, 4, True), (12000, 64, 4, 4, False),
    (3, 64, 17, 4, False), (3, 128, 4, 4, False), (40, 100, 200, 4, False)])
def test_whole_bwd_smem_refuses_what_does_not_fit(d0, u, n_layers, rows,
                                                  fits):
    """A densenet stack too wide for 227 KB of shared memory, one of more
    than 16 layers, one of U >= 128 (the register tile's) or a row tile
    the kernel lacks is refused: ``_kernel_backward`` keeps it on the
    per-layer kernels."""
    assert (tstack.whole_bwd_smem(d0, u, n_layers, rows) is not None) \
        == fits


def test_whole_bwd_blocks_count_sweeps_and_tasks():
    """``(sweeps, tasks)``. phi_sa at M=256: 64 sweeps of 4 rows; dW_i in
    tiles of 32 rows (9, 11, 13, 15 of K = 260 .. 452), a task each, each
    summed over the whole batch; phi_s 1, 3, 5, 7 of K = 3 .. 195; a layer
    with db alone one tile; none below the lowest layer asked for."""
    d0, u, n_layers = OFENET["phi_sa"]
    assert tstack.whole_bwd_blocks(256, d0, u, n_layers, [True] * 4,
                                   [True] * 4) == (64, 48)
    d0s, us, ls = OFENET["phi_s"]
    assert tstack.whole_bwd_blocks(256, d0s, us, ls, [True] * 4,
                                   [True] * 4) == (64, 16)
    assert tstack.whole_bwd_blocks(257, d0, u, n_layers, [False] * 4,
                                   [False, True, False, True],
                                   lowest=1) == (65, 2)
    assert tstack.whole_bwd_blocks(256, d0, u, n_layers, [True] * 4,
                                   [True] * 4, lowest=2, rows=8) == (32, 28)
    # the rows a sweep block own: 40 rows in 10 sweeps, 9 in 3
    assert tstack.whole_bwd_blocks(40, d0, u, n_layers, [True] * 4,
                                   [True] * 4) == (10, 48)
    assert tstack.whole_bwd_blocks(9, d0, u, n_layers, [True] * 4,
                                   [True] * 4) == (3, 48)


class _RecordingLib:
    """Stands in for the backward's CUDA library: records every call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("dense_"):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


class _Stream:
    def __init__(self, handle):
        self.cuda_stream = handle

    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        pass


@pytest.fixture
def recorded(monkeypatch):
    """``_kernel_backward`` on CPU tensors against a recording library,
    every counter request recorded (``(n, stream)``)."""
    lib = _RecordingLib()
    asked = []

    def tile_counters(n, dev, stream):
        asked.append((n, stream))
        return torch.zeros((max(n, 1024),), dtype=torch.int32)
    monkeypatch.setattr(tstack, "_bwd_library", lambda: lib)
    monkeypatch.setattr(tstack, "_device_info", lambda dev: (132, 77))
    monkeypatch.setattr(tstack, "_tile_counters", tile_counters)
    monkeypatch.setattr(tstack, "_side_stream",
                        lambda dev, main: _Stream(78))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: _Stream(77))
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda: type("E", (), {"record": lambda s, t: 0})())
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, s: None)
    tstack.reset_launch_count()
    yield lib, asked
    tstack.reset_launch_count()


def _saved(conn, m, d0, u, n_layers, seed=0):
    """The plain forward's saved tensors: (feature or x, zs), ws, g."""
    x, ws, bs, g = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                    else [torch.from_numpy(v) for v in a]
                    for a in _make(conn, m, d0, u, n_layers, seed))
    out = tstack.dense_stack_ref(x, ws, bs, connectivity=conn)
    zs, h, stream = [], x, x
    for i, (w, b) in enumerate(zip(ws, bs)):
        if conn == "densenet":
            inp = stream
        elif conn == "d2rl" and i > 0:
            inp = torch.cat([h, x], 1)
        else:
            inp = h
        zs.append(inp @ w + b)
        h = torch.nn.functional.silu(zs[-1])
        stream = torch.cat([stream, h], 1)
    keep = out if conn == "densenet" else x
    return x, bs, (keep, torch.cat(zs, 1)), ws, g


# (need_dx, dW and db asked for) of the training path's calls: everything
# (the aux loss), dx alone (the actor loss through phi_sa), the weights
# alone, and the top layers' weights alone (a lowest layer above 0)
NEEDS = {"all": (True, [True] * 4, [True] * 4),
         "dx": (True, [False] * 4, [False] * 4),
         "weights": (False, [True] * 4, [True] * 4),
         "top": (False, [False, False, True, True], [False, True, True,
                                                      True])}


@pytest.mark.parametrize("need", sorted(NEEDS))
@pytest.mark.parametrize("name", sorted(OFENET))
def test_narrow_densenet_backward_is_one_launch(recorded, name, need):
    """phi_s and phi_sa at M=256: ONE launch of the whole-stack backward
    kernel a stack backward, its arguments those of the call (every W_i;
    dW_i and db_i where asked, of layers from the lowest one asked; dx
    where asked; the gz scratch where any dW or db is; a 128-byte line of
    counters for the ticket and done counts and for each layer's ready
    count, on the launch's stream), counted as ``"whole"``; with
    ``whole=False`` the
    per-layer kernels as before."""
    lib, asked = recorded
    d0, u, n_layers = OFENET[name]
    m = 256
    _, _, saved, ws, g = _saved("densenet", m, d0, u, n_layers)
    need_dx, need_dw, need_db = NEEDS[need]
    dx, dws, dbs = tstack._kernel_backward(saved, ws, g, "densenet",
                                           "swish", need_dx, need_dw,
                                           need_db)
    assert [n for n, _ in lib.calls] == ["dense_bwd_whole"]
    (rows, vec_w, layers, w_ptrs, dw_ptrs, db_ptrs, out_ptr, lds, zs_ptr,
     ldz, g_ptr, ldg, dx_ptr, lddx, gz_ptr, ctr, m_, d0_, u_, lowest, act,
     stream) = lib.calls[0][1]
    wanted = [i for i in range(n_layers) if need_dw[i] or need_db[i]]
    assert (rows, vec_w, layers, m_, d0_, u_, act, stream) == (
        tstack._WHOLE_BWD_ROWS, 1, n_layers, m, d0, u,
        tstack._ACT_CODE["swish"], 77)
    assert lowest == (0 if need_dx else min(wanted))
    assert list(w_ptrs) == [w.data_ptr() for w in ws]
    assert list(dw_ptrs) == [0 if t is None else t.data_ptr() for t in dws]
    assert list(db_ptrs) == [0 if t is None else t.data_ptr() for t in dbs]
    assert [t is not None for t in dws] == need_dw
    assert [t is not None for t in dbs] == need_db
    assert (dx is not None) == need_dx
    assert (dx_ptr, lddx) == ((dx.data_ptr(), d0) if need_dx else (None, 0))
    assert (out_ptr, lds) == (saved[0].data_ptr(), d0 + n_layers * u)
    assert (zs_ptr, ldz) == (saved[1].data_ptr(), n_layers * u)
    assert (g_ptr, ldg) == (g.data_ptr(), d0 + n_layers * u)
    assert (gz_ptr is not None) == bool(wanted)
    # the ticket, done and every layer's ready counter a 128-byte line
    # apart
    assert asked == [(32 * (n_layers + 1), 77)]
    assert tstack.bwd_launch_count() == tstack.bwd_launch_count("whole") \
        == 1
    lib.calls.clear()
    tstack._kernel_backward(saved, ws, g, "densenet", "swish", need_dx,
                            need_dw, need_db, whole=False)
    names = {n for n, _ in lib.calls}
    assert "dense_bwd_whole" not in names and "dense_bwd_gemm" in names
    assert tstack.bwd_launch_count("layers") == 1


@pytest.mark.parametrize("conn,shape", [
    ("densenet", CRITIC), ("densenet", (256, 3, 128, 4)),
    ("mlp", PHI_S), ("d2rl", PHI_SA_FULL), ("mlp", WIDE_MLP)])
def test_backward_keeps_the_per_layer_kernels_elsewhere(recorded, conn,
                                                        shape):
    """A densenet stack of U >= 128 and every mlp or d2rl stack keep the
    per-layer kernels: no whole-stack launch."""
    lib, _ = recorded
    m, d0, u, n_layers = shape
    _, _, saved, ws, g = _saved(conn, m, d0, u, n_layers)
    tstack._kernel_backward(saved, ws, g, conn, "swish", True,
                            [True] * n_layers, [True] * n_layers)
    names = {n for n, _ in lib.calls}
    assert names and "dense_bwd_whole" not in names
    assert tstack.bwd_launch_count("layers") == 1
    assert tstack.bwd_launch_count("whole") == 0


def floats(ptr, rows, cols, ld):
    """A numpy view of ``rows`` x ``cols`` float32 at the CPU address
    ``ptr``, rows ``ld`` floats apart (what a kernel reads or writes)."""
    n = (rows - 1) * ld + cols
    base = np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))
    return np.lib.stride_tricks.as_strided(base, (rows, cols), (4 * ld, 4))


DACT_NP = {"swish": lambda z: (s := 1 / (1 + np.exp(-z))) * (1 + z * (1 - s)),
           "relu": lambda z: (z > 0).astype(np.float64),
           "tanh": lambda z: 1 - np.tanh(z) ** 2,
           "identity": np.ones_like}


class _EmulatingLib(_RecordingLib):
    """Records every call, and runs the whole-stack backward's contract
    (``dense_bwd_whole``, dense_stack_bwd.cu) in float64 on the CPU memory
    it is handed."""

    def __init__(self, activation):
        super().__init__()
        self.dact = DACT_NP[activation]

    def dense_bwd_whole(self, rows, vec_w, layers, w_ptrs, dw_ptrs, db_ptrs,
                        out, lds, zs, ldz, g, ldg, dx, lddx, gz, counters,
                        m, d0, u, lowest, act, stream):
        self.calls.append(("dense_bwd_whole", ()))
        width = d0 + layers * u
        stream_ = floats(out, m, width, lds).astype(np.float64)
        z = floats(zs, m, layers * u, ldz)
        gs = floats(g, m, width, ldg).astype(np.float64)
        assert (gz is not None) == any(dw_ptrs[i] or db_ptrs[i]
                                       for i in range(layers))
        assert dx is None or lowest == 0
        for i in reversed(range(lowest, layers)):
            k = d0 + i * u
            gzi = gs[:, k:k + u] * self.dact(z[:, i * u:(i + 1) * u])
            if dw_ptrs[i]:
                floats(dw_ptrs[i], k, u, u)[:] = stream_[:, :k].T @ gzi
            if db_ptrs[i]:
                floats(db_ptrs[i], 1, u, u)[0] = gzi.sum(0)
            if i > lowest or dx is not None:
                gs[:, :k] += gzi @ floats(w_ptrs[i], k, u, u).T
        for i in range(lowest):
            assert not dw_ptrs[i] and not db_ptrs[i]
        if dx is not None:
            floats(dx, m, d0, lddx)[:] = gs[:, :d0]
        return 0


@pytest.mark.parametrize("need", sorted(NEEDS))
@pytest.mark.parametrize("name,m", [("phi_s", 256), ("phi_sa", 256),
                                    ("phi_sa", 37)])
def test_whole_backward_wrapper_holds_the_plain_gradients(
        recorded, monkeypatch, name, m, need):
    """The whole-stack backward emulated on the wrapper's own arguments:
    what it returns is the plain backward's gradients, each where asked
    for and None elsewhere (the arguments name the right tensors, layers
    and strides)."""
    lib = _EmulatingLib("swish")
    monkeypatch.setattr(tstack, "_bwd_library", lambda: lib)
    d0, u, n_layers = OFENET[name]
    x, bs, saved, ws, g = _saved("densenet", m, d0, u, n_layers, seed=3)
    need_dx, need_dw, need_db = NEEDS[need]
    got = tstack._kernel_backward(saved, ws, g, "densenet", "swish",
                                  need_dx, need_dw, need_db)
    assert len(lib.calls) == 1
    want = tstack.dense_stack_grads_ref(x, ws, bs, g)
    for a, b, asked in zip(_flat(*got), _flat(*want),
                           [need_dx] + need_dw + need_db):
        assert (a is not None) == asked
        if asked:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(b.abs().max()))


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
                        RAGGED_RT_VEC, PHI_S, PHI_SA_FULL, WIDE_MLP):
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
        whole = tstack.bwd_launch_count("whole")
        got = _kernel_grads(cuda_device, x, ws, bs, g, conn, act)
        again = _kernel_grads(cuda_device, x, ws, bs, g, conn, act)
        torch.cuda.synchronize()
        assert tstack.bwd_launch_count() - before == 2
        narrow = conn == "densenet" and \
            tstack.whole_bwd_smem(d0, u, L) is not None
        assert tstack.bwd_launch_count("whole") - whole == 2 * narrow
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


@pytest.mark.parametrize("act", ACTS)
def test_cuda_whole_backward_at_every_row_tile(cuda_device, act):
    """The whole-stack backward at each of its row tiles (and 128-column
    rows at U=100) against the plain version and the per-layer kernels,
    bitwise across two calls; dx alone, the weights alone and the top
    layers' alone (a lowest layer above 0) too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for m, d0, u, L in (PHI_S, PHI_SA_FULL, (37, 5, 61, 3), (9, 7, 100, 2),
                        (257, 260, 64, 4)):
        x, ws, bs, g = _make("densenet", m, d0, u, L, seed=5)
        x, g = (torch.from_numpy(a).to(cuda_device) for a in (x, g))
        ws = [torch.from_numpy(w).to(cuda_device) for w in ws]
        bs = [torch.from_numpy(b).to(cuda_device) for b in bs]
        zs = torch.empty((m, L * u), device=cuda_device)
        out = tstack._kernel_forward(x, ws, bs, "densenet", act, zs)
        want = _flat(*tstack.dense_stack_grads_ref(x, ws, bs, g,
                                                   activation=act, zs=zs))
        layers = _flat(*tstack._kernel_backward(
            (out, zs), ws, g, "densenet", act, True, [True] * L, [True] * L,
            whole=False))
        _assert_grads([t.cpu().numpy() for t in layers],
                      [t.cpu().numpy() for t in want], f"per-layer M={m}")
        tiles = [r for r in tstack._WHOLE_BWD_ROW_TILES
                 if tstack.whole_bwd_smem(d0, u, L, r) is not None]
        assert tiles
        for rows in tiles:
            for need in NEEDS.values():
                need_dx, need_dw, need_db = (need[0], need[1][-L:],
                                             need[2][-L:])
                lowest = 0 if need_dx else min(
                    i for i in range(L) if need_dw[i] or need_db[i])
                run = [_flat(*tstack._launch_whole_bwd(
                    out, zs, ws, g, tstack._ACT_CODE[act], need_dx, need_dw,
                    need_db, lowest, rows)) for _ in range(2)]
                torch.cuda.synchronize()
                asked = [need_dx] + need_dw + need_db
                for a, b, w, k in zip(run[0], run[1], want, asked):
                    assert (a is not None) == k
                    if k:
                        assert torch.equal(a, b)
                        _assert_grads([a.cpu().numpy()], [w.cpu().numpy()],
                                      f"{act} M={m} rows={rows}")


def _stack_widths(blk):
    """``(layer, K)`` of every layer of a stack: its input width."""
    d0, u = blk.in_dim, blk.num_units
    if blk.connectivity == "densenet":
        return [(i, d0 + i * u) for i in range(blk.num_layers)]
    extra = d0 if blk.connectivity == "d2rl" else 0
    return [(i, d0 if i == 0 else u + extra) for i in range(blk.num_layers)]


@pytest.mark.parametrize("algo", ["sac", "td3"])
@pytest.mark.parametrize("preset,over", [
    ("rl-distributed", {}), ("fig10-ablation", {}), ("table1-ours", {}),
    ("fig10-ablation", dict(num_units=2048, ofenet_units=64,
                            ofenet_layers=4, batch_size=256)),
    ("fig3-width", dict(num_units=2048, batch_size=256))])
def test_presets_reach_no_narrow_per_layer_backward_product(preset, over,
                                                           algo):
    """Every stack a training superstep differentiates (the actor, the
    critic, OFENet's phi_s and phi_sa), at the preset's batch, as shipped
    and at the card's training and fused-fleet cells (fig10-ablation and
    fig3-width at 2048 units): a narrow densenet stack runs whole, and
    every product of the others (each layer's dW and dx, the first
    layer's thin ones included) plans the register tile, but a first
    layer under 32 wide (fig3's observations, 3 or 4), where
    dense_tile.cuh is the faster. The host and sharded replays and fleets
    run the same stacks at the same batch."""
    from repro_torch.rl import presets
    from repro_torch.rl.envs import make_env
    from repro_torch.rl.policy import algo_config
    spec = presets.get(preset).override(algo=algo, **over)
    acfg = algo_config(spec, make_env("pendulum"))
    blocks = [acfg.actor_block(), acfg.critic_block()]
    if acfg.ofenet:
        blocks += [acfg.ofenet.state_block, acfg.ofenet.sa_block]
    m = spec.execution.batch_size
    for blk in blocks:
        u = blk.num_units
        if blk.connectivity == "densenet" and tstack.whole_bwd_smem(
                blk.in_dim, u, blk.num_layers) is not None:
            continue
        assert u >= 128, f"{preset}: a narrow {blk.connectivity} stack"
        for i, k in _stack_widths(blk):
            want = k >= 32 or i > 0
            assert (tstack.plan_bwd(k, u, m, 132)[0]
                    in tstack._RT_CONFIGS) == want
            assert (tstack.plan_bwd(m, k, u, 132, dx=True)[0]
                    in tstack._RT_CONFIGS) == want
