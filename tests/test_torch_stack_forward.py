"""The port's stack forward: its planner and launch plan on the CPU, and
the plain version against the reference's Pallas forward at a ragged shape
large enough for the register tile.

``plan_fwd`` picks one of four kernels of ``csrc/dense_stack_fwd.cu`` by
the width and the rows of the call: the whole-stack kernel for a densenet
stack with U < 128 whose shared memory fits (the narrow OFENet stacks, at
every row count: one launch a stack), the weight-streaming kernel up to 32
rows (the serving slots), the register tile over a transposed input from
128 rows where U is at least 128 too (densenet's ``stream^T``: the actor
and critic stacks at the batch of 256; mlp's and d2rl's ping-pong
buffers of h^T: fig3's and the other mlp presets' stacks), and
``dense_tile.cuh`` otherwise (mlp and d2rl past 32 rows with U < 128).
The launch sequence of ``_kernel_forward`` is plain Python: it runs here
against a recording stand-in for the CUDA library, which shows one launch
per layer by the planned kernel (one per stack on the whole-stack kernel),
one transposed init per register-tiled call, and split counters taken
from ``_tile_counters`` with no zeroed buffer per launch; and against an
emulating stand-in, which runs the register tile's launches on the CPU
memory the wrapper hands it, so the mlp/d2rl buffers' layout (which rows
each layer reads and writes) is held to the plain version here. The
kernels themselves are held against the plain version on the card
(``tests/test_torch_stack.py -k cuda``, ``chip_smoke.py``).
"""
import ctypes
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.dense_block import stack as tstack

# (m, n, k) of the four wide forward products at the training batch: the
# actor's (d0 = 259) and the critic's (d0 = 516) layers 0 and 1, U = 2048
WIDE = [(256, 2048, 259), (256, 2048, 2307), (256, 2048, 516),
        (256, 2048, 2564)]
# the narrow OFENet products at the batch: phi_s (d0 = 3) and phi_sa
# (d0 = 260), U = 64, four layers
NARROW = [(256, 64, 3 + 64 * i) for i in range(4)] \
    + [(256, 64, 260 + 64 * i) for i in range(4)]
# the OFENet stacks (d0, U, L)
OFENET = {"phi_s": (3, 64, 4), "phi_sa": (260, 64, 4)}
SLOTS = (1, 2, 4, 8, 16, 32)
# ragged and large enough for the register tile (cf. the backward's)
RAGGED_RT = (201, 37, 301, 3)


@pytest.mark.parametrize("m,n,k", WIDE)
def test_plan_fwd_takes_the_register_tile_at_the_wide_products(m, n, k):
    config, tiles, splits, _ = tstack.plan_fwd(m, n, k, 132)
    assert config == tstack._RT_FWD_CONFIG
    assert tstack._RT_CONFIGS[config][:2] == (128, 64)
    assert tstack.fwd_kernel_of(config) == "rt"
    # the small (256, 2048) output splits K into up to two blocks per SM
    assert splits > 1 and tiles * splits <= 2 * 132


@pytest.mark.parametrize("transposed", (True, False))
@pytest.mark.parametrize("m", (1, 2, 5, 16, 32, 33, 64, 127, 128, 201, 256,
                               1024))
def test_plan_fwd_takes_only_the_forward_librarys_configs(m, transposed):
    """``dense_stack_fwd.cu`` has the streaming kernel, the register tile's
    128x64 case and ``dense_tile.cuh``'s config 2; the thin configs 0 and 1
    (the backward's products of up to 32 rows) and 128x128 are not in
    it."""
    for n, k in [(64, 3), (64, 451), (301, 37), (2048, 259), (2048, 4612)]:
        config = tstack.plan_fwd(m, n, k, 132, transposed=transposed)[0]
        assert config in (tstack._STREAM_CONFIG, tstack._RT_FWD_CONFIG, 2)
        if m > tstack._STREAM_MAX_ROWS:
            assert config != tstack._STREAM_CONFIG


@pytest.mark.parametrize("m", SLOTS)
@pytest.mark.parametrize("n,k", [(2048, 259), (2048, 2307), (2048, 2564),
                                 (64, 3), (64, 195), (301, 639)])
def test_plan_fwd_streams_the_weights_at_serving_slots(m, n, k):
    config, strips, splits, rows = tstack.plan_fwd(m, n, k, 132)
    assert config == tstack._STREAM_CONFIG
    assert tstack.fwd_kernel_of(config) == "stream"
    assert strips == -(-n // tstack._STREAM_COLS)
    # a block holds at most _STREAM_MAX_K rows of A; splits cover K
    assert rows <= tstack._STREAM_MAX_K
    assert (splits - 1) * rows < k <= splits * rows
    # connectivity does not matter here: every slot streams
    assert tstack.plan_fwd(m, n, k, 132, transposed=False)[0] == config


@pytest.mark.parametrize("m,n,k", NARROW)
def test_plan_fwd_keeps_the_old_configs_for_the_narrow_stacks(m, n, k):
    """A narrow OFENet layer at the batch runs whole with its stack (one
    launch of the whole-stack kernel, blocks of ``_WHOLE_ROWS`` rows, no
    split); asked about the layer alone (no ``stack``: the mlp/d2rl case
    and a stack the kernel refuses), the plan stays ``dense_tile.cuh``'s."""
    d0 = 3 if k < 260 else 260
    whole = tstack.plan_fwd(m, n, k, 132, stack=(d0, 4))
    assert whole == (tstack._WHOLE_CONFIG, -(-m // tstack._WHOLE_ROWS), 1,
                     tstack._WHOLE_ROWS)
    assert tstack.fwd_kernel_of(whole[0]) == "whole"
    assert tstack.plan_fwd(m, n, k, 132) == tstack.plan(m, n, k, 132)
    assert tstack.fwd_kernel_of(tstack.plan_fwd(m, n, k, 132)[0]) == "tile"


@pytest.mark.parametrize("name", sorted(OFENET))
@pytest.mark.parametrize("rows", (4, 8, 16))
def test_whole_smem_takes_the_ofenet_stacks(name, rows):
    """The whole-stack kernel's shared memory at phi_s and phi_sa: the
    stream below the last layer (rows x (d0 + 3 U) floats), the W ring (6
    stages of 32 rows of 64 floats) and one sum per row for each of the 256
    threads, within the card's 227 KB a block."""
    d0, u, n_layers = OFENET[name]
    want = 4 * ((d0 + (n_layers - 1) * u) * rows + 6 * 32 * 64 + 256 * rows)
    assert tstack.whole_smem(d0, u, n_layers, rows) == want
    assert want <= tstack._SMEM_MAX


@pytest.mark.parametrize("d0,u,n_layers,fits", [
    (3, 64, 4, True), (260, 64, 4, True), (3, 127, 16, True),
    (10000, 64, 4, True), (12000, 64, 4, False), (3, 64, 17, False),
    (3, 128, 4, False), (40, 100, 200, False)])
def test_whole_smem_refuses_what_does_not_fit(d0, u, n_layers, fits):
    """A densenet stack too wide for 227 KB of shared memory, one of more
    than 16 layers, or one of U >= 128 (the register tile's) is refused,
    and ``plan_fwd`` keeps it on the per-layer kernels."""
    assert (tstack.whole_smem(d0, u, n_layers) is not None) == fits
    plan = tstack.plan_fwd(256, u, d0, 132, stack=(d0, n_layers))
    assert (tstack.fwd_kernel_of(plan[0]) == "whole") == fits


@pytest.mark.parametrize("m", (1, 8, 32, 33, 100, 128, 256, 257, 1024))
@pytest.mark.parametrize("name", sorted(OFENET))
def test_plan_fwd_runs_the_narrow_densenet_stacks_whole(m, name):
    """A narrow densenet stack runs whole at every row count, the serving
    slots too (one launch, blocks of ``_WHOLE_ROWS`` rows: the card sweep
    found it faster than the streaming kernel at 1, 8 and 32 rows); mlp
    and d2rl (no ``transposed`` stream) never run whole, and stream at the
    slots."""
    d0, u, n_layers = OFENET[name]
    for i in range(n_layers):
        k = d0 + i * u
        plan = tstack.plan_fwd(m, u, k, 132, stack=(d0, n_layers))
        assert tstack.fwd_kernel_of(plan[0]) == "whole"
        assert plan[1:] == (-(-m // tstack._WHOLE_ROWS), 1,
                            tstack._WHOLE_ROWS)
        other = tstack.fwd_kernel_of(tstack.plan_fwd(
            m, u, k, 132, transposed=False, stack=(d0, n_layers))[0])
        assert other == ("stream" if m <= tstack._STREAM_MAX_ROWS
                         else "tile")
    assert tstack._WHOLE_ROWS in tstack._WHOLE_ROW_TILES


@pytest.mark.parametrize(
    "m,n,k", WIDE + NARROW + [(m, 2048, 2307) for m in SLOTS]
    + [(64, 2048, 2307), (201, 301, 37), (201, 301, 639), (128, 128, 1),
       (1, 64, 1), (32, 2048, 193)])
def test_plan_fwd_splits_cover_k_exactly(m, n, k):
    for transposed in (True, False):
        config, tiles, splits, per = tstack.plan_fwd(m, n, k, 132,
                                                     transposed=transposed)
        if config == tstack._STREAM_CONFIG:
            bm, bn, bk = 32, tstack._STREAM_COLS, 1     # per counts rows
        else:
            bm, bn, bk = {**dict(enumerate(tstack._CONFIGS)),
                          **tstack._RT_CONFIGS}[config]
        chunks = -(-k // bk)
        assert tiles == -(-m // bm) * -(-n // bn)
        assert splits >= 1 and per >= 1
        assert (splits - 1) * per < chunks <= splits * per


def test_plan_fwd_follows_the_sweep_at_the_wide_products():
    """The card sweep (``launch/bwd_sweep.py``, H100) put the best plan of
    each wide product at 128x64 tiles and: the actor's layer 0 (33 chunks)
    2 splits, the critic's (65) 2 (4 within 1 us), both layers 1 four
    splits, two blocks per SM."""
    assert [tstack.plan_fwd(m, n, k, 132)[:3] for m, n, k in WIDE] \
        == [(4, 64, 2), (4, 64, 4), (4, 64, 4), (4, 64, 4)]


def test_plan_fwd_register_tile_needs_the_transposed_stream():
    """Without a transposed input (``transposed=False``: mlp and d2rl on
    the path before the register tile took them, ``_kernel_forward(...,
    mlp_rt=False)``) a wide layer takes dense_tile.cuh at 256 rows; with
    it (every connectivity's default) the register tile, whatever its
    K."""
    for m, n, k in WIDE + [(201, 301, 37)]:
        assert tstack.plan_fwd(m, n, k, 132, transposed=False) \
            == tstack.plan(m, n, k, 132)
    assert tstack.plan_fwd(201, 301, 37, 132)[0] in tstack._RT_CONFIGS
    assert tstack.plan_fwd(64, 2048, 2307, 132)[0] == 2


@pytest.mark.parametrize("m,n,k", WIDE + [(m, 2048, k) for m in (1, 8, 32)
                                   for k in (259, 2307)])
def test_fwd_sweep_candidates_hold_the_plan(m, n, k):
    """The card sweep (``launch/bwd_sweep.py``) times every plan
    ``plan_fwd`` may pick at the wide products and the serving slots."""
    from repro_torch.launch import bwd_sweep
    pick = tstack.plan_fwd(m, n, k, 132)
    if pick[0] == tstack._STREAM_CONFIG:
        cands = bwd_sweep.stream_candidates(m, n, k)
        assert len(cands) > 1
        for _, strips, splits, rows in cands:
            assert rows <= tstack._STREAM_MAX_K
            assert (splits - 1) * rows < k <= splits * rows
    else:
        cands = bwd_sweep.candidates(m, n, k, 132, True)
    assert pick in cands


class _RecordingLib:
    """Stands in for the forward's CUDA library: records every call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("dense_"):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


# where each entry point takes its counters, m, n and splits
_ARGS = {"dense_layer_fwd": dict(counters=14, m=15, n=16, splits=18),
         "dense_layer_fwd_rt": dict(counters=14, m=15, n=16, splits=19),
         "dense_layer_fwd_stream": dict(counters=17, m=18, n=19, splits=21)}
_KIND = {"dense_layer_fwd": "tile", "dense_layer_fwd_rt": "rt",
         "dense_layer_fwd_stream": "stream",
         "dense_stack_fwd_whole": "whole"}


@pytest.fixture
def recorded(monkeypatch):
    """``_kernel_forward`` on CPU tensors against the recording library,
    with every counter request and every ``torch.zeros`` recorded."""
    lib = _RecordingLib()
    counters = torch.zeros((4096,), dtype=torch.int32)
    asked, zeros = [], []
    real_zeros = torch.zeros

    def tile_counters(n, dev, stream):
        asked.append((n, stream))
        return counters

    def no_zeros(*args, **kw):
        zeros.append(args)
        return real_zeros(*args, **kw)
    monkeypatch.setattr(tstack, "_library", lambda: lib)
    monkeypatch.setattr(tstack, "_device_info", lambda dev: (132, 77))
    monkeypatch.setattr(tstack, "_tile_counters", tile_counters)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch, "zeros", no_zeros)
    tstack.reset_launch_count()
    yield lib, counters, asked, zeros
    tstack.reset_launch_count()


def _stack(conn, m, d0, u, n_layers, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, d0)).astype(np.float32))
    ws = [torch.from_numpy(rng.standard_normal((k, u)).astype(np.float32))
          for k in (tstack.in_dim(conn, i, d0, u) for i in range(n_layers))]
    bs = [torch.from_numpy(rng.standard_normal((u,)).astype(np.float32))
          for _ in range(n_layers)]
    return x, ws, bs


@pytest.mark.parametrize("conn,m,d0,u,n_layers", [
    ("densenet", 128, 300, 128, 2),     # register tile, split K
    ("densenet", 201, 37, 301, 3),      # register tile, ragged
    ("densenet", 8, 40, 64, 2),         # narrow: the whole-stack kernel
    ("densenet", 8, 40, 128, 2),        # streaming, split K at layer 1
    ("densenet", 1, 259, 512, 2),       # streaming, a serving slot
    ("densenet", 256, 260, 64, 4),      # phi_sa: the whole-stack kernel
    ("mlp", 128, 130, 128, 2),          # register tile over h^T
    ("mlp", 201, 3, 301, 4),            # register tile, ragged, K = 3
    ("d2rl", 256, 4, 128, 3),           # register tile over [h | x]^T
    ("d2rl", 8, 40, 64, 3),             # streaming, two segments
    ("d2rl", 256, 20, 64, 3)])          # U < 128: dense_tile.cuh
def test_forward_launch_plan(recorded, conn, m, d0, u, n_layers):
    """One launch per layer by the kernel ``plan_fwd`` gives it (one per
    stack on the whole-stack kernel), one transposed init per
    register-tiled call (densenet: x into the stream and stream^T; mlp:
    x^T; d2rl: x^T into both ping-pong slabs), and every split's counters
    from ``_tile_counters`` on the launch's stream: no zeroed buffer per
    launch. On the register tile mlp's and d2rl's layers below the last
    write only h_i^T (no row-major output), which the next layer reads:
    for d2rl with x^T right after it, its input ``[h | x]`` one operand."""
    lib, counters, asked, zeros = recorded
    x, ws, bs = _stack(conn, m, d0, u, n_layers)
    zs = torch.empty((m, n_layers * u))
    with torch.no_grad():
        out = tstack._kernel_forward(x, ws, bs, conn, "swish", zs)
    assert not zeros
    stack = (d0, n_layers) if conn == "densenet" else None
    if tstack.fwd_kernel_of(tstack.plan_fwd(m, u, d0, 132,
                                            stack=stack)[0]) == "whole":
        _check_whole_launch(lib, asked, x, ws, bs, out, zs)
        return
    layers = [(n, a) for n, a in lib.calls if n in _ARGS]
    inits = [a for n, a in lib.calls if n == "dense_fwd_stream_init"]
    assert len(layers) == n_layers
    kinds = []
    split_launches = 0
    for i, (name, args) in enumerate(layers):
        pos = _ARGS[name]
        plan = tstack.plan_fwd(m, u, ws[i].shape[0], 132)
        kinds.append(_KIND[name])
        assert _KIND[name] == tstack.fwd_kernel_of(plan[0])
        assert (args[pos["m"]], args[pos["n"]], args[pos["splits"]]) \
            == (m, u, plan[2])
        assert args[-1] == 77                       # the current stream
        if plan[2] > 1:
            split_launches += 1
            assert args[pos["counters"]] == counters.data_ptr()
        else:
            assert args[pos["counters"]] is None
        if name == "dense_layer_fwd_stream":
            # layer 0 reads x; densenet's also writes it into the stream
            # (no copy kernel), which its later layers read
            if i == 0:
                assert args[1] == x.data_ptr()
            elif conn == "densenet":
                assert args[1] == out.data_ptr()
            assert (args[14] is not None) == (conn == "densenet" and i == 0)
            if args[14] is not None:
                assert (args[14], args[15]) == (out.data_ptr(),
                                                d0 + n_layers * u)
        if name == "dense_layer_fwd_rt":
            # the transposed input: rows of m rounded up to 4; the last
            # layer's output is read by no later layer, so it is not
            # transposed, and only densenet's others write the row-major
            # stream
            ldt = args[3]
            assert ldt == m + -m % 4 and args[12] in (0, ldt)
            assert args[17] == ws[i].shape[0]       # K: the whole input
            assert (args[11] is None) == (i == n_layers - 1)
            assert (args[7] is None) == (conn != "densenet"
                                         and i < n_layers - 1)
    assert asked == [(tstack.plan_fwd(m, u, w.shape[0], 132)[1], 77)
                     for w in ws if tstack.plan_fwd(
                         m, u, w.shape[0], 132)[2] > 1]
    assert len(asked) == split_launches
    wide = kinds[0] == "rt"
    assert len(inits) == int(wide)
    assert set(kinds) == {kinds[0]}                 # one kernel a stack
    if wide:
        src, lds, dst, ldd, dst_t, ldt, dup, rows, cols, stream = inits[0]
        assert (src, lds, rows, cols, stream) == (x.data_ptr(), d0, m, d0,
                                                  77)
        assert ldt == m + -m % 4
        if conn == "densenet":
            assert (dst, ldd, dup) == (out.data_ptr(), d0 + n_layers * u, 0)
        else:
            assert (dst, ldd) == (None, 0)
            # d2rl: x^T into both slabs [h^T | x^T] of U + d0 rows
            assert dup == ((u + d0) * ldt if conn == "d2rl" else 0)
        if conn != "densenet":
            rt = [a for _, a in layers]
            # layer 0 reads x^T; layer i reads what layer i-1 wrote
            assert rt[0][2] == dst_t
            for i in range(1, n_layers):
                assert rt[i][2] == rt[i - 1][11]
                if conn == "d2rl":              # x^T right after h^T
                    assert rt[i][2] + 4 * u * ldt \
                        == dst_t + 4 * (i % 2) * dup
            assert rt[-1][7] == out.data_ptr()
    assert tstack.launch_count() == n_layers
    assert tstack.launch_count(kinds[0]) == n_layers
    assert tstack.transpose_count() == int(wide)


def floats(ptr, rows, cols, ld):
    """A numpy view of ``rows`` x ``cols`` float32 at the CPU address
    ``ptr``, rows ``ld`` floats apart (what a kernel reads or writes)."""
    n = (rows - 1) * ld + cols
    base = np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))
    return np.lib.stride_tricks.as_strided(base, (rows, cols), (4 * ld, 4))


ACT_NP = {"swish": lambda z: z / (1 + np.exp(-z)), "relu":
          lambda z: np.maximum(z, 0), "tanh": np.tanh,
          "identity": lambda z: z}


class _EmulatingLib(_RecordingLib):
    """Records every call, and runs the transposed init and the register
    tile's layer (solo entries) in float64 on the CPU memory it is handed,
    as the kernels' C interface describes them."""

    def __init__(self, activation):
        super().__init__()
        self.act = ACT_NP[activation]

    def dense_fwd_stream_init(self, src, lds, dst, ldd, dst_t, ldt, dup,
                              rows, cols, stream):
        self.calls.append(("dense_fwd_stream_init", (
            src, lds, dst, ldd, dst_t, ldt, dup, rows, cols, stream)))
        x = floats(src, rows, cols, lds)
        floats(dst_t, cols, rows, ldt)[:] = x.T
        if dup:
            floats(dst_t + 4 * dup, cols, rows, ldt)[:] = x.T
        if dst is not None:
            floats(dst, rows, cols, ldd)[:] = x
        return 0

    def dense_layer_fwd_rt(self, config, vec_w, at, ldat, w, ldw, b, y, ldy,
                           z, ldz, yt, ldt, ws, counters, m, n, k, act,
                           splits, per_split, stream):
        self.calls.append(("dense_layer_fwd_rt", (
            config, vec_w, at, ldat, w, ldw, b, y, ldy, z, ldz, yt, ldt, ws,
            counters, m, n, k, act, splits, per_split, stream)))
        zz = floats(at, k, m, ldat).T.astype(np.float64) \
            @ floats(w, k, n, ldw) + floats(b, 1, n, n)[0]
        if z is not None:
            floats(z, m, n, ldz)[:] = zz
        yy = self.act(zz)
        if y is not None:
            floats(y, m, n, ldy)[:] = yy
        if yt is not None:
            floats(yt, n, m, ldt)[:] = yy.T
        return 0


@pytest.mark.parametrize("act", ("swish", "relu"))
@pytest.mark.parametrize("conn,m,d0,u,n_layers", [
    ("mlp", 128, 130, 128, 1), ("mlp", 128, 3, 128, 2),
    ("mlp", 201, 3, 301, 4), ("mlp", 256, 4, 256, 3),
    ("d2rl", 128, 4, 128, 2), ("d2rl", 203, 5, 300, 4),
    ("densenet", 201, 37, 301, 3)])
def test_register_tile_buffers_hold_the_plain_stack(recorded, monkeypatch,
                                                    conn, m, d0, u,
                                                    n_layers, act):
    """The register tile's launches emulated on the wrapper's own buffers
    (``_EmulatingLib``): the feature and every layer's pre-activation are
    the plain version's, so each layer read the input the stack defines
    (mlp: h_{i-1}^T; d2rl: [h_{i-1} | x]^T; densenet: the stream prefix^T)
    and wrote where the next reads, for 1 to 4 layers, ragged rows and
    K = 3 to 5 at layer 0 (the pendulum's observation)."""
    lib = _EmulatingLib(act)
    monkeypatch.setattr(tstack, "_library", lambda: lib)
    x, ws, bs = _stack(conn, m, d0, u, n_layers, seed=n_layers)
    ws = [w / np.sqrt(w.shape[0]) for w in ws]
    zs = torch.full((m, n_layers * u), float("nan"))
    with torch.no_grad():
        out = tstack._kernel_forward(x, ws, bs, conn, act, zs)
    assert {n for n, _ in lib.calls} == {"dense_fwd_stream_init",
                                         "dense_layer_fwd_rt"}
    want = tstack.dense_stack_ref(x, ws, bs, connectivity=conn,
                                  activation=act)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    stream = x if conn != "densenet" else None
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        if conn == "densenet":
            inp = want[:, :w.shape[0]]
        elif conn == "d2rl" and i > 0:
            inp = torch.cat([h, stream], 1)
        else:
            inp = h
        z = inp @ w + b
        np.testing.assert_allclose(zs[:, i * u:(i + 1) * u].numpy(),
                                   z.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(z.abs().max()))
        h = tstack.get_activation(act)(z)


def _check_whole_launch(lib, asked, x, ws, bs, out, zs):
    """The whole-stack kernel's one launch: x, every layer's W and b, the
    output stream and ``zs`` passed through, ``_WHOLE_ROWS`` rows a block,
    16-byte W copies (U = 64), no counters."""
    (m, d0), n_layers, u = x.shape, len(ws), ws[0].shape[1]
    assert [n for n, _ in lib.calls] == ["dense_stack_fwd_whole"]
    (rows, vec_w, x_ptr, ldx, layers, w_ptrs, b_ptrs, d0_, u_, out_ptr, ldo,
     z_ptr, ldz, m_, act, stream) = lib.calls[0][1]
    assert (rows, vec_w, x_ptr, ldx, layers) == (
        tstack._WHOLE_ROWS, 1, x.data_ptr(), d0, n_layers)
    assert list(w_ptrs) == [w.data_ptr() for w in ws]
    assert list(b_ptrs) == [b.data_ptr() for b in bs]
    assert (d0_, u_, out_ptr, ldo, m_) == (d0, u, out.data_ptr(),
                                           d0 + n_layers * u, m)
    assert zs is None or (z_ptr, ldz) == (zs.data_ptr(), n_layers * u)
    assert zs is not None or (z_ptr, ldz) == (None, 0)
    assert (act, stream) == (tstack._ACT_CODE["swish"], 77)
    assert not asked
    assert tstack.launch_count() == tstack.launch_count("whole") == 1
    assert tstack.transpose_count() == 0


@pytest.mark.parametrize("with_zs", (True, False))
@pytest.mark.parametrize("m", (1, 8, 32, 33, 100, 256, 257))
@pytest.mark.parametrize("name", sorted(OFENET))
def test_whole_stack_launch_plan(recorded, name, m, with_zs):
    """phi_s and phi_sa at the serving slots and past them, with autograd's
    ``zs`` and without:
    one launch of the whole-stack kernel a stack call, ``zs`` passed
    through, no counters asked for and no ``torch.zeros``."""
    lib, counters, asked, zeros = recorded
    d0, u, n_layers = OFENET[name]
    x, ws, bs = _stack("densenet", m, d0, u, n_layers)
    zs = torch.empty((m, n_layers * u)) if with_zs else None
    with torch.no_grad():
        out = tstack._kernel_forward(x, ws, bs, "densenet", "swish", zs)
    assert out.shape == (m, d0 + n_layers * u)
    assert not zeros
    _check_whole_launch(lib, asked, x, ws, bs, out, zs)


def test_forward_takes_every_kernel_on_the_training_shapes():
    """At the training path's shapes the wide stacks stream at the actor
    pool's 32 rows and take the register tile at the batch, the OFENet
    stacks take the whole-stack kernel at both; ``dense_tile.cuh`` is left
    to mlp and d2rl past 32 rows."""
    kinds = {tstack.fwd_kernel_of(tstack.plan_fwd(m, u, d0, 132,
                                                  stack=(d0, n))[0])
             for m, d0, u, n in [(32, 3, 64, 4), (32, 259, 2048, 2),
                                 (256, 3, 64, 4), (256, 260, 64, 4),
                                 (256, 259, 2048, 2), (256, 516, 2048, 2)]}
    assert kinds == set(tstack.FWD_KERNELS) - {"tile"}
    assert tstack.fwd_kernel_of(tstack.plan_fwd(
        256, 64, 3, 132, transposed=False)[0]) == "tile"


@pytest.mark.parametrize("conn", ("densenet", "d2rl", "mlp"))
def test_plain_stack_matches_jax_pallas_at_a_register_tile_shape(conn):
    """The plain forward (the CPU path and the kernels' reference on the
    card) against the reference's Pallas forward in interpret mode at a
    ragged shape the register tile takes on the card (201 rows, U = 301,
    d0 = 37), within float32 reassociation (rtol = atol = 1e-5, the bar of
    ``tests/test_dense_stack.py``, with atol scaled by max|want|)."""
    import jax.numpy as jnp
    from repro.kernels.dense_block import stack as jstack
    m, d0, u, n_layers = RAGGED_RT
    rng = np.random.default_rng(len(conn))
    x = rng.standard_normal((m, d0)).astype(np.float32)
    ws = [(rng.standard_normal((k, u)) / np.sqrt(k)).astype(np.float32)
          for k in (tstack.in_dim(conn, i, d0, u) for i in range(n_layers))]
    bs = [(rng.standard_normal((u,)) * 0.3).astype(np.float32)
          for _ in range(n_layers)]
    got = tstack.dense_stack(torch.from_numpy(x),
                             [torch.from_numpy(w) for w in ws],
                             [torch.from_numpy(b) for b in bs],
                             connectivity=conn).numpy()
    want = np.asarray(jstack.dense_stack(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, bs)), connectivity=conn, impl="pallas",
        interpret=True, block_m=128))
    assert got.shape == want.shape == (m, tstack.feature_dim(conn, n_layers,
                                                             d0, u))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
