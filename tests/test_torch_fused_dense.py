"""The port's fused dense layer and DenseNet concat-matmul against the JAX
reference.

On the CPU the port's ``fused_dense``/``dense_concat_matmul`` run their
plain PyTorch versions; they must match the reference's Pallas kernel
(interpret mode) and its jnp oracle on the same seeded numpy inputs, at the
reference tests' tolerances (2e-4 float32, 2e-2 bfloat16). In bfloat16 the
reference's ``dense_concat_matmul`` rounds each part's product before the
sum and the port rounds once (ROADMAP C5): both are held to the bf16 bar.
The CUDA kernel is held against the plain version on the card (skipped
without one); those tests import no JAX:

    python -m pytest tests/test_torch_fused_dense.py -k cuda
"""
import numpy as np
import pytest
import torch

from repro_torch.common import ACTIVATIONS
from repro_torch.kernels.dense_block import dense_block as tdb
from repro_torch.kernels.dense_block import ops as tops
from repro_torch.kernels.dense_block import ref as tref

SHAPES = [(16, 32, 16), (64, 128, 32), (128, 256, 128), (32, 96, 48)]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * 0.1).astype(np.float32),
            rng.standard_normal((n,)).astype(np.float32))


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("activation", ["swish", "identity", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_fused_dense_matches_jax(m, k, n, dtype, activation):
    import jax.numpy as jnp
    from repro.kernels.dense_block.ops import fused_dense_padded
    from repro.kernels.dense_block.ref import fused_dense_ref
    x, w, b = _inputs(m, k, n, seed=m + k + n)
    jd = getattr(jnp, dtype)
    jx, jw, jb = (jnp.asarray(a).astype(jd) for a in (x, w, b))
    tx, tw, tb = (_to_torch(a, dtype) for a in (x, w, b))
    got = tdb.fused_dense(tx, tw, tb, activation=activation)
    padded = tops.fused_dense_padded(tx, tw, tb, activation=activation)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    np.testing.assert_array_equal(_np(got), _np(padded))
    for want in (fused_dense_padded(jx, jw, jb, activation=activation,
                                    bm=32, bn=32, bk=32),
                 fused_dense_ref(jx, jw, jb, activation)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("widths", [(8, 16), (24, 16, 40), (128,)])
def test_dense_concat_matmul_matches_jax(widths, dtype):
    """One launch over the parts on the card; on the CPU the concat ref.
    Held against both JAX functions (the per-part kernel loop and the
    concat oracle)."""
    import jax.numpy as jnp
    from repro.kernels.dense_block.ops import dense_concat_matmul
    from repro.kernels.dense_block.ref import dense_concat_matmul_ref
    rng = np.random.default_rng(sum(widths))
    parts = [rng.standard_normal((32, wd)).astype(np.float32)
             for wd in widths]
    w = (rng.standard_normal((sum(widths), 48)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((48,)) * 0.1).astype(np.float32)
    jd = getattr(jnp, dtype)
    got = tops.dense_concat_matmul([_to_torch(p, dtype) for p in parts],
                                   _to_torch(w, dtype), _to_torch(b, dtype),
                                   activation="swish")
    jparts = [jnp.asarray(p).astype(jd) for p in parts]
    jw, jb = jnp.asarray(w).astype(jd), jnp.asarray(b).astype(jd)
    for want in (dense_concat_matmul(jparts, jw, jb, activation="swish"),
                 dense_concat_matmul_ref(jparts, jw, jb, "swish")):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **_tol(dtype))


@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
def test_dense_concat_matmul_every_activation_matches_jax_ref(activation):
    """Every name ``get_activation`` knows (the reference's concat wrapper
    takes them all; gelu is the tanh approximation in both)."""
    import jax.numpy as jnp
    from repro.kernels.dense_block.ref import dense_concat_matmul_ref
    rng = np.random.default_rng(7)
    parts = [rng.standard_normal((9, wd)).astype(np.float32)
             for wd in (5, 11)]
    w = (rng.standard_normal((16, 12)) * 0.5).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    got = tops.dense_concat_matmul([torch.from_numpy(p) for p in parts],
                                   torch.from_numpy(w), torch.from_numpy(b),
                                   activation=activation)
    want = dense_concat_matmul_ref([jnp.asarray(p) for p in parts],
                                   jnp.asarray(w), jnp.asarray(b), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_fused_dense_exact_blocks_no_bias_matches_jax():
    import jax.numpy as jnp
    from repro.kernels.dense_block.dense_block import fused_dense
    x, w, _ = _inputs(128, 384, 128, seed=2)
    got = tdb.fused_dense(torch.from_numpy(x), torch.from_numpy(w), None,
                          activation="swish")
    want = fused_dense(jnp.asarray(x), jnp.asarray(w), None,
                       activation="swish", bm=64, bn=64, bk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_fused_dense_rejects_bad_shapes_and_activations():
    x, w = torch.zeros((4, 6)), torch.zeros((6, 3))
    with pytest.raises(ValueError, match="K=5"):
        tdb.fused_dense(x[:, :5], w)
    with pytest.raises(ValueError, match="unknown activation"):
        tdb.fused_dense(x, w, activation="softplus")
    with pytest.raises(ValueError, match="rows"):
        tops.dense_concat_matmul([x, torch.zeros((5, 2))], torch.zeros((8, 3)))
    with pytest.raises(ValueError, match="b"):
        tdb.fused_dense(x, w, torch.zeros((4,)))


def test_plan_fills_the_card_and_covers_every_chunk():
    for m, n, k in ((64, 256, 2159), (256, 2048, 4207), (5, 40, 37)):
        chunks = -(-k // tdb.BK)
        config, tiles, splits, per = tdb.plan(m, n, chunks, 132)
        bm, bn = tdb.TILES[config]
        assert tiles == -(-m // bm) * -(-n // bn)
        assert (splits - 1) * per < chunks <= splits * per
        # split until the grid fills the card or the splits get short
        assert splits == 1 or tiles * splits >= 132 - tiles \
            or per < 2 * tdb._MIN_CHUNKS_PER_SPLIT
    # the Ant layer 3: 128 tiles of 64x64, three splits of 44 chunks
    assert tdb.plan(256, 2048, 132, 132) == (0, 128, 3, 44)


@pytest.mark.parametrize("widths", [(111, 2048, 2048), (111, 2048), (13,),
                                    (7, 30), (5, 11, 21), (32, 1, 64, 33),
                                    (4207,)])
@pytest.mark.parametrize("m,n", [(256, 2048), (64, 256), (33, 70)])
def test_plan_splits_cover_every_segments_chunks_once(widths, m, n):
    """The kernel walks K in BK-chunks part by part (``chunks_of``): each
    chunk lies inside one part, the chunks tile every part exactly, and
    the plan's splits (contiguous runs of ``per`` chunks) take each chunk
    once."""
    walk = tdb.chunks_of(widths)
    for part, k0, cols in walk:
        assert 0 < cols <= tdb.BK and k0 % tdb.BK == 0
        assert k0 + cols <= widths[part]
    for part, k in enumerate(widths):
        cover = sorted((k0, cols) for p, k0, cols in walk if p == part)
        assert sum(cols for _, cols in cover) == k
        assert [k0 for k0, _ in cover] == list(range(0, k, tdb.BK))
    config, tiles, splits, per = tdb.plan(m, n, len(walk), 132)
    taken = [c for s in range(splits)
             for c in range(s * per, min(len(walk), (s + 1) * per))]
    assert taken == list(range(len(walk)))
    assert tiles * splits <= tdb._BLOCKS_PER_SM * 132 or splits == 1


def _tf32(x: torch.Tensor, nearest: bool = True) -> torch.Tensor:
    """x in TF32 (10 mantissa bits): rounded to nearest with ties away from
    zero (cvt.rna.tf32.f32), or truncated toward zero, as the tensor core
    reads an fp32 register."""
    bits = x.view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def test_3xtf32_emulation_meets_the_fp32_bar():
    """Split-precision TF32 as the kernel computes it, emulated on the CPU:
    each fp32 operand as hi = tf32(x) (to nearest, ties away) plus its
    residual x - hi (exact in fp32), which the MMA truncates to TF32, and
    the products lo.hi + hi.lo + hi.hi summed in fp32 (lo.lo dropped), at
    M=64, K=4207 as the three parts [111 | 2048 | 2048], N=256, against
    the float64 product. It sits inside the card's 1e-4 bar (rtol, and
    atol 1e-4 * max|exact|), and its error is at least 10x smaller than one
    TF32 product's: what the kernel's agreement on the card should be
    (the card's fp32 accumulation adds its own rounding, PERF.md)."""
    rng = np.random.default_rng(17)
    widths, m, n = (111, 2048, 2048), 64, 256
    k = sum(widths)
    parts = [rng.standard_normal((m, w)).astype(np.float32) for w in widths]
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    x = torch.from_numpy(np.concatenate(parts, 1))
    wt = torch.from_numpy(w)
    exact = x.double() @ wt.double()
    xh, wh = _tf32(x), _tf32(wt)
    xl, wl = _tf32(x - xh, nearest=False), _tf32(wt - wh, nearest=False)
    # each piece is a TF32 value: 11 significant bits or fewer
    for t in (xh, wh, xl, wl):
        assert torch.equal(t, _tf32(t, nearest=False))
    three = (xl @ wh + xh @ wl) + xh @ wh
    one = xh @ wh
    err3 = (three.double() - exact).abs()
    err1 = (one.double() - exact).abs()
    bar = 1e-4 * exact.abs() + 1e-4 * exact.abs().max()
    assert bool(torch.all(err3 <= bar))
    assert float(err3.max()) * 10 <= float(err1.max())


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_dense_kernel_matches_plain(cuda_device, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    rtol = 2e-2 if dtype == "bfloat16" else 1e-4
    rng = np.random.default_rng(3)
    for widths, m, n in (((37,), 5, 40), ((24, 16, 40), 33, 70),
                         ((111, 2048), 64, 256)):
        parts = [rng.standard_normal((m, k)).astype(np.float32)
                 for k in widths]
        w = (rng.standard_normal((sum(widths), n))
             / np.sqrt(sum(widths))).astype(np.float32)
        b = (rng.standard_normal((n,)) * 0.1).astype(np.float32)
        for act in sorted(tdb.ACT_CODE):
            for bias in (b, None):
                cpu = [_to_torch(p, dtype) for p in parts]
                tb = None if bias is None else _to_torch(bias, dtype)
                want = tref.dense_concat_matmul_ref(cpu, _to_torch(w, dtype),
                                                    tb, act)
                before = tdb.launch_count()
                got = tops.dense_concat_matmul(
                    [p.to(cuda_device) for p in cpu],
                    _to_torch(w, dtype).to(cuda_device),
                    None if tb is None else tb.to(cuda_device),
                    activation=act)
                torch.cuda.synchronize()
                assert tdb.launch_count() - before == 1
                err = np.abs(_np(got.cpu()) - _np(want))
                assert np.all(err <= rtol * np.abs(_np(want))
                              + rtol * np.abs(_np(want)).max()), (widths, act)


def test_cuda_tensor_never_reaches_the_plain_version(cuda_device,
                                                     monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(tref, "dense_concat_matmul_ref", boom)
    monkeypatch.setattr(tref, "fused_dense_ref", boom)
    x = torch.randn((8, 24), device=cuda_device)
    w = torch.randn((24, 16), device=cuda_device)
    before = tdb.launch_count()
    tdb.fused_dense(x, w)
    tops.dense_concat_matmul([x[:, :10], x[:, 10:]], w)
    torch.cuda.synchronize()
    assert tdb.launch_count() - before == 2
