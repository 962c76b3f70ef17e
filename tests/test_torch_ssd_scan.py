"""The port's SSD chunk kernel and chunked scan against the JAX reference.

On the CPU the port's ``ssd_chunk_dual`` runs its plain float32 PyTorch
version; it must match the reference's Pallas kernel (interpret mode) and
its float64 numpy oracle on the same seeded numpy inputs (2e-4 float32,
2e-2 bfloat16). ``ssd_chunked_kernel`` (the plain recurrence around the
chunk kernel) must match the reference's ``ssd_chunked_kernel`` and its
jnp ``ssd_chunked`` + D x, with the final state, within 1e-4. The CUDA
kernel is held against the plain version on the card (skipped without
one); those tests import no JAX:

    python -m pytest tests/test_torch_ssd_scan.py -k cuda
"""
import numpy as np
import pytest
import torch

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
    torch.backends.cuda.matmul.allow_tf32 = False
    rtol = 2e-2 if dtype == "bfloat16" else 1e-4
    td = getattr(torch, dtype)
    for i, shape in enumerate(((2, 2, 16, 8, 8), (3, 2, 100, 24, 40),
                               (2, 4, 256, 64, 64))):
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
