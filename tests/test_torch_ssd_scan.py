"""The port's SSD chunk kernel and chunked scan against the JAX reference.

On the CPU the port's ``ssd_chunk_dual`` runs its plain float32 PyTorch
version; it must match the reference's Pallas kernel (interpret mode) and
its float64 numpy oracle on the same seeded numpy inputs (2e-4 float32,
2e-2 bfloat16). ``ssd_chunked_kernel`` (the plain recurrence around the
chunk kernel) must match the reference's ``ssd_chunked_kernel`` and its
jnp ``ssd_chunked`` + D x, with the final state, within 1e-4, at 1 to 64
chunks and with decays whose cumulative sums pass 1e3, in a number of
torch ops that does not grow with the chunks. The CUDA kernel's 3xTF32
arithmetic is emulated on the CPU (``ref.emulated_ssd_chunk``) against
the float64 oracle, and its launch plan and block decode are checked
against Python copies of the kernel's formulas. The CUDA kernel is held
against the plain version on the card (skipped without one); those tests
import no JAX:

    python -m pytest tests/test_torch_ssd_scan.py -k cuda
"""
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.ssd_scan import ops as tops
from repro_torch.kernels.ssd_scan import ref as tref
from repro_torch.kernels.ssd_scan import ssd_scan as tss


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


def _softplus(a):
    return np.log1p(np.exp(a))


def _chunk_inputs(g, h, q, n, p, seed):
    """c, b, x (to be cast), cum, dt, state, d_skip (float32)."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((g, q, n)).astype(np.float32)
    b = rng.standard_normal((g, q, n)).astype(np.float32)
    x = rng.standard_normal((g, h, q, p)).astype(np.float32)
    cum = np.cumsum(-_softplus(rng.standard_normal((g, h, q))),
                    axis=-1).astype(np.float32)
    dt = _softplus(rng.standard_normal((g, h, q))).astype(np.float32)
    state = rng.standard_normal((g, h, p, n)).astype(np.float32)
    d_skip = rng.standard_normal((h,)).astype(np.float32)
    return c, b, x, cum, dt, state, d_skip


def _seq_inputs(bsz, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bsz, s, h, p)).astype(np.float32),
            rng.standard_normal((bsz, s, n)).astype(np.float32),
            rng.standard_normal((bsz, s, n)).astype(np.float32),
            _softplus(rng.standard_normal((bsz, s, h))).astype(np.float32),
            (rng.standard_normal((h,)) * 0.3).astype(np.float32),
            rng.standard_normal((h,)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,h,q,n,p", [(2, 2, 16, 8, 8), (1, 3, 32, 16, 8),
                                       (4, 1, 8, 4, 16)])
def test_ssd_chunk_dual_matches_jax(g, h, q, n, p, dtype):
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.ref import ssd_chunk_dual_ref
    from repro.kernels.ssd_scan.ssd_scan import ssd_chunk_dual
    c, b, x, cum, dt, state, d_skip = _chunk_inputs(g, h, q, n, p, g + q)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    t = torch.from_numpy
    got = tss.ssd_chunk_dual(t(c).to(td), t(b).to(td), t(x).to(td), t(cum),
                             t(dt), t(state), t(d_skip))
    assert got.dtype == td and got.shape == (g, h, q, p)
    jc, jb, jx = (jnp.asarray(a).astype(jd) for a in (c, b, x))
    kernel = ssd_chunk_dual(jc, jb, jx, jnp.asarray(cum), jnp.asarray(dt),
                            jnp.asarray(state), jnp.asarray(d_skip))
    oracle = ssd_chunk_dual_ref(jc, jb, jx, cum, dt, state, d_skip)
    for want in (np.asarray(kernel, np.float32), oracle):
        np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunked_kernel_matches_jax(chunk):
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.ops import ssd_chunked_kernel
    from repro.kernels.ssd_scan.ref import ssd_chunked
    arrays = _seq_inputs(2, 32, 2, 8, 4, chunk)
    x, b, c, dt, log_a, d_skip = arrays
    y, final = tops.ssd_chunked_kernel(*map(torch.from_numpy, arrays),
                                       chunk=chunk)
    ja = [jnp.asarray(a) for a in arrays]
    y_k, f_k = ssd_chunked_kernel(*ja, chunk=chunk)
    y_m, f_m = ssd_chunked(*ja[:5], chunk=chunk)
    y_m = y_m + ja[5][None, None, :, None] * ja[0]
    for want_y, want_f in ((y_k, f_k), (y_m, f_m)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(final.numpy(), np.asarray(want_f),
                                   rtol=1e-4, atol=1e-4)


def test_plain_ssd_chunked_matches_jax_with_an_initial_state():
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.ref import ssd_chunked
    x, b, c, dt, log_a, _ = _seq_inputs(1, 24, 3, 4, 5, 3)
    init = np.random.default_rng(4).standard_normal(
        (1, 3, 4, 5)).astype(np.float32)
    y, final = tref.ssd_chunked(*map(torch.from_numpy, (x, b, c, dt, log_a)),
                                chunk=8, init_state=torch.from_numpy(init))
    y_j, f_j = ssd_chunked(*map(jnp.asarray, (x, b, c, dt, log_a)), chunk=8,
                           init_state=jnp.asarray(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(final.numpy(), np.asarray(f_j), rtol=1e-4,
                               atol=1e-4)


def test_plain_chunk_is_finite_where_the_masked_exponent_is_huge():
    """Mask before exp: above the diagonal exp(cum_t - cum_s) would be
    exp(+1e4); the plain version must give exactly 0 there, not inf*0."""
    c, b, x, _, dt, state, d_skip = _chunk_inputs(1, 1, 8, 4, 4, 0)
    cum = -1e4 * np.arange(8, dtype=np.float32)[None, None]
    y = tss.ssd_chunk_dual(*map(torch.from_numpy,
                                (c, b, x, cum, dt, state, d_skip)))
    assert torch.all(torch.isfinite(y))


def test_ssd_rejects_bad_shapes():
    c, b, x, cum, dt, state, d_skip = map(
        torch.from_numpy, _chunk_inputs(1, 2, 8, 4, 4, 0))
    with pytest.raises(ValueError, match="state_in"):
        tss.ssd_chunk_dual(c, b, x, cum, dt, state[:, :1], d_skip)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tops.ssd_chunked_kernel(*map(torch.from_numpy,
                                     _seq_inputs(1, 12, 2, 4, 4, 0)),
                                chunk=8)


@pytest.mark.parametrize("route", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,h,q,n,p", [(1, 3, 256, 64, 64),
                                       (2, 2, 100, 24, 40)])
def test_3xtf32_ssd_emulation_meets_the_fp32_bar(g, h, q, n, p, route):
    """The kernel's split-precision TF32 route with its plan's s-tile and
    exp (``ref.emulated_ssd_chunk``: S per s-tile, M from S, the state
    product last), its sums rounded to nearest and as the MMA rounds them
    (toward zero, a k8 slice at a time), against the float64 oracle on the
    same inputs, at one full-width cell and a ragged one: inside the 1e-4
    bar (rtol, and atol 1e-4 * max|exact|) with a 10x margin, and at least
    10x under the error of one TF32 product a pair. The bf16 route (c, b
    and x exact in TF32: C B^T one product, M x and C state^T two) is held
    to the same bar on bf16-valued inputs; the emulation returns the fp32
    sums the kernel rounds to bf16 as it stores them."""
    from repro.kernels.ssd_scan.ref import ssd_chunk_dual_ref
    arrays = [torch.from_numpy(a) for a in _chunk_inputs(g, h, q, n, p, q)]
    if route == "bfloat16":
        arrays[:3] = [a.to(torch.bfloat16) for a in arrays[:3]]
    exact = torch.from_numpy(ssd_chunk_dual_ref(
        *(a.float().numpy() for a in arrays)))
    bar = 1e-4 * exact.abs() + 1e-4 * exact.abs().max()
    kw = dict(fast_exp=bool(tss.PLAN[3]), s_tile=tss.PLAN[2])
    err3, err_rz, err1 = (
        (tref.emulated_ssd_chunk(*arrays, split=split, mma_rz=rz,
                                 **kw).double() - exact).abs()
        for split, rz in ((True, False), (True, True), (False, False)))
    for err in (err3, err_rz):
        assert bool(torch.all(err * 10 <= bar))
        assert float(err.max()) * 10 <= float(err1.max())


def test_ssd_plans_are_launch_shapes_the_kernel_has():
    """``PLAN`` is among the builds the card sweep times; ``build_defines``
    gives every ``-D`` flag the source requires (a missing one stops the
    build); every swept plan is a shape the kernel asserts (heads a block
    1-8, 4 or 8 warps, 32- or 64-wide s-tiles) and fits the
    227 KB a block may have at N=64 and every P up to 128, in either dtype
    (``smem_bytes``, the kernel's ``layout``); the wrapper refuses what
    does not fit, before any launch."""
    from repro_torch.launch import bwd_sweep
    src = tss.SOURCE.read_text()
    required = set(re.findall(r"!defined\((\w+)\)", src))
    given = {d[2:].split("=")[0] for d in tss.build_defines()}
    assert required == given == {"SSD_HG", "SSD_WARPS", "SSD_BS",
                                 "SSD_FAST_EXP"}
    assert tss.PLAN in bwd_sweep.SSD_PLANS
    assert bwd_sweep.FIRST_SSD_SOURCE.exists()
    for heads, warps, bs, fast_exp in bwd_sweep.SSD_PLANS:
        assert 1 <= heads <= 8 and warps in (4, 8) and bs in (32, 64)
        assert fast_exp in (0, 1)
        for elem in (4, 2):
            for p in (8, 16, 40, 64, 100, 128):
                assert tss.smem_bytes(64, p, elem, elem, bs) <= tss.MAX_SMEM
    # the main shape keeps three blocks an SM (228 KB of shared memory)
    assert 3 * (tss.smem_bytes(64, 64, 4, 4) + 1024) <= 233472
    assert [tss.p_width(p) for p in (1, 32, 33, 64, 65, 128)] == \
        [32, 32, 64, 64, 128, 128]
    with pytest.raises(ValueError, match="shared memory"):
        tss._launch(*(torch.zeros(s) for s in
                      ((1, 8, 512), (1, 8, 512), (1, 1, 8, 8), (1, 1, 8),
                       (1, 1, 8), (1, 1, 8, 512), (1,), (1, 1, 8, 8))))


def _blocks(cells, heads, q, hg):
    """The kernel's decode of blockIdx.x, in Python: (t-tile, cell, first
    head, heads of the group) of every block in launch order."""
    groups, t_tiles = -(-heads // hg), -(-q // 64)
    per_tile = cells * groups
    out = []
    for bid in range(cells * groups * t_tiles):
        tt = t_tiles - 1 - bid // per_tile
        g, h0 = divmod(bid % per_tile, groups)
        h0 *= hg
        out.append((tt, g, h0, min(hg, heads - h0)))
    return out


@pytest.mark.parametrize("cells,heads,q,hg", [(3, 16, 256, 2), (2, 3, 100, 2),
                                              (2, 5, 1024, 4), (4, 1, 8, 4),
                                              (1, 7, 300, 1)])
def test_every_cell_head_and_tile_has_one_block(cells, heads, q, hg):
    """Every (cell, head, 64-row t-tile) is owned by exactly one block,
    including the last group of a head count that is not a multiple of
    the heads a block (its extra heads are idle), and the launch order
    puts the heaviest causal t-tiles (the most s-tiles) first."""
    blocks = _blocks(cells, heads, q, hg)
    owned = [(g, h, tt) for tt, g, h0, n in blocks for h in range(h0, h0 + n)]
    assert sorted(owned) == sorted(
        (g, h, tt) for g in range(cells) for h in range(heads)
        for tt in range(-(-q // 64)))
    assert all(1 <= n <= hg for *_, n in blocks)
    tiles = [tt for tt, *_ in blocks]
    assert tiles == sorted(tiles, reverse=True)


def _decay_inputs(nc, chunk, seed):
    """A sequence whose per-head decays reach cumulative sums past 1e3
    (head 0: a = e^2.5, about 12 a step) beside a slow head (a = e^-3)."""
    x, b, c, dt, _, d_skip = _seq_inputs(1, nc * chunk, 2, 4, 3, seed)
    log_a = np.array([2.5, -3.0], np.float32)
    return x, b, c, dt, log_a, d_skip


@pytest.mark.parametrize("nc", [1, 4, 64])
def test_state_pass_matches_jax_at_any_number_of_chunks(nc):
    """``ops.ssd_chunked_kernel``'s state pass (one product with the
    segment-sum decay matrix, no loop over chunks) against the reference's
    ``ssd_chunked_kernel`` (a ``lax.scan``) and jnp ``ssd_chunked`` + D x,
    y and the final state within 1e-4, at 1, 4 and 64 chunks, with a head
    whose cumulative decay passes 1e3."""
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.ops import ssd_chunked_kernel
    from repro.kernels.ssd_scan.ref import ssd_chunked
    chunk = 4
    arrays = _decay_inputs(nc, chunk, nc)
    a = np.exp(arrays[4].astype(np.float64))
    if nc == 64:
        assert float((arrays[3][..., 0] * a[0]).sum()) > 1e3
    y, final = tops.ssd_chunked_kernel(*map(torch.from_numpy, arrays),
                                       chunk=chunk)
    ja = [jnp.asarray(v) for v in arrays]
    y_k, f_k = ssd_chunked_kernel(*ja, chunk=chunk)
    y_m, f_m = ssd_chunked(*ja[:5], chunk=chunk)
    y_m = y_m + ja[5][None, None, :, None] * ja[0]
    for want_y, want_f in ((y_k, f_k), (y_m, f_m)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(final.numpy(), np.asarray(want_f),
                                   rtol=1e-4, atol=1e-4)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def test_state_pass_ops_do_not_grow_with_chunks():
    """The aten ops ``ssd_chunked_kernel`` issues (plain chunk version on
    the CPU) are as many at 64 chunks as at 4: no loop over chunks."""
    counts = []
    for nc in (4, 64):
        arrays = [torch.from_numpy(a) for a in _decay_inputs(nc, 4, 0)]
        with _CountOps() as mode:
            tops.ssd_chunked_kernel(*arrays, chunk=4)
        counts.append(mode.ops)
    assert counts[0] == counts[1] > 0


def test_chunk_decays_are_segment_sums():
    """``ops.chunk_decays``: row n, column m holds exp of the sum of the
    totals strictly between chunks m and n (0 where m >= n; row 0 empty),
    against a float64 double loop, with totals whose running sum passes
    1e3."""
    total = torch.from_numpy(np.random.default_rng(3).uniform(
        -60.0, 0.0, (2, 40)).astype(np.float32))
    got = tops.chunk_decays(total).double()
    t64 = total.double()
    want = torch.zeros((2, 41, 40), dtype=torch.float64)
    for n in range(41):
        for m in range(min(n, 40)):
            want[:, n, m] = torch.exp(t64[:, m + 1:n].sum(-1))
    assert float(t64.sum(-1).min()) < -1e3
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-30)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _close(got, want, rtol):
    got, want = got.cpu().float().numpy(), want.float().numpy()
    return np.all(np.abs(got - want) <= rtol * np.abs(want)
                  + rtol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_kernel_matches_plain(cuda_device, dtype):
    """Ragged and full chunks, Q=1024 (longer than the t-tile), H=3 (not a
    multiple of the heads a block), N=4 with P=8 (padding), P=100 and 128:
    within 1e-4 (fp32) and 2e-2 (bf16) of the plain version, one launch a
    call; the chunked scan within 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rtol = 2e-2 if dtype == "bfloat16" else 1e-4
    td = getattr(torch, dtype)
    for i, shape in enumerate(((2, 2, 16, 8, 8), (3, 2, 100, 24, 40),
                               (2, 4, 256, 64, 64), (1, 2, 1024, 64, 64),
                               (2, 3, 100, 16, 32), (3, 2, 70, 4, 8),
                               (2, 3, 130, 32, 100), (1, 2, 200, 64, 128))):
        arrays = [torch.from_numpy(a) for a in _chunk_inputs(*shape, i)]
        arrays[:3] = [a.to(td) for a in arrays[:3]]
        want = tref.ssd_chunk_dual_ref(*arrays)
        before = tss.launch_count()
        got = tss.ssd_chunk_dual(*(a.to(cuda_device) for a in arrays))
        torch.cuda.synchronize()
        assert tss.launch_count() - before == 1
        assert _close(got, want, rtol), shape
    arrays = [torch.from_numpy(a) for a in _seq_inputs(2, 64, 4, 16, 8, 1)]
    y, final = tops.ssd_chunked_kernel(*arrays, chunk=16)
    yc, fc = tops.ssd_chunked_kernel(*(a.to(cuda_device) for a in arrays),
                                     chunk=16)
    assert _close(yc, y, 1e-4) and _close(fc, final, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_views_without_16_byte_rows(cuda_device, dtype):
    """x (and the output) as views of rows P + pad wide, whose strides rule
    out 16-byte copies (8, 4 or, bf16, 2 bytes a copy), and two calls
    bitwise equal."""
    rtol = 2e-2 if dtype == "bfloat16" else 1e-4
    td = getattr(torch, dtype)
    for i, (shape, pad) in enumerate((((3, 3, 200, 64, 64), 3),
                                      ((2, 4, 96, 16, 40), 2),
                                      ((2, 2, 64, 8, 16), 1))):
        arrays = [torch.from_numpy(a) for a in _chunk_inputs(*shape, i)]
        g, h, q, n, p = shape
        wide = torch.zeros((g, h, q, p + pad))
        wide[..., :p] = arrays[2]
        arrays[:3] = [arrays[0].to(td), arrays[1].to(td),
                      wide.to(td)[..., :p]]
        want = tref.ssd_chunk_dual_ref(*arrays)
        dev = [a.to(cuda_device) for a in arrays]
        dev[2] = wide.to(td).to(cuda_device)[..., :p]
        out = torch.empty((g, h, q, p + pad), dtype=td,
                          device=cuda_device)[..., :p]
        before = tss.launch_count()
        got = tss.ssd_chunk_dual(*dev, out=out)
        again = tss.ssd_chunk_dual(*dev)
        torch.cuda.synchronize()
        assert tss.launch_count() - before == 2
        assert _close(got, want, rtol), (shape, pad)
        assert torch.equal(got, again)


def test_cuda_tensor_never_reaches_the_plain_version(cuda_device,
                                                     monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(tref, "ssd_chunk_dual_ref", boom)
    arrays = [torch.from_numpy(a).to(cuda_device)
              for a in _seq_inputs(1, 32, 2, 8, 4, 2)]
    before = tss.launch_count()
    tops.ssd_chunked_kernel(*arrays, chunk=8)
    torch.cuda.synchronize()
    assert tss.launch_count() - before == 1
