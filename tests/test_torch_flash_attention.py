"""The port's flash attention against the JAX reference.

On the CPU the port's ``flash_attention``/``gqa_flash`` run their plain
PyTorch versions; they must match the reference's Pallas kernel
(interpret mode) and its jnp oracles on the same seeded numpy inputs, at
the reference tests' tolerances (2e-4 float32, 2e-2 bfloat16, 3e-4 with
the soft-cap). A query row with no valid key gets the mean of v in both
packages (ROADMAP C6). The CUDA kernel is held against the plain version
on the card (skipped without one); those tests import no JAX:

    python -m pytest tests/test_torch_flash_attention.py -k cuda
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


def _qkv(shape_q, shape_kv, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape_q) * scale).astype(np.float32),
            (rng.standard_normal(shape_kv) * scale).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


def _both(arrays, dtype):
    import jax.numpy as jnp
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,d,bq,bkv", [
    (128, 128, 32, 64, 64), (128, 256, 16, 128, 64), (256, 128, 16, 64, 64)])
def test_flash_attention_matches_jax(sq, skv, d, bq, bkv, dtype, causal):
    from repro.kernels.flash_attention.flash_attention import flash_attention
    from repro.kernels.flash_attention.ref import attention_ref
    (jq, jk, jv), (q, k, v) = _both(_qkv((3, sq, d), (3, skv, d), sq + skv),
                                    dtype)
    got = tfa.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == (3, sq, d)
    for want in (flash_attention(jq, jk, jv, causal=causal, bq=bq, bkv=bkv),
                 attention_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **_tol(dtype))


@pytest.mark.parametrize("window", [32, 64])
def test_flash_attention_sliding_window_matches_jax(window):
    from repro.kernels.flash_attention.flash_attention import flash_attention
    from repro.kernels.flash_attention.ref import attention_ref
    (jq, jk, jv), (q, k, v) = _both(_qkv((2, 128, 32), (2, 128, 32), 5),
                                    "float32")
    got = tfa.flash_attention(q, k, v, causal=True, window=window)
    for want in (flash_attention(jq, jk, jv, causal=True, window=window,
                                 bq=32, bkv=32),
                 attention_ref(jq, jk, jv, causal=True, window=window)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


def test_flash_attention_softcap_matches_jax():
    from repro.kernels.flash_attention.flash_attention import flash_attention
    from repro.kernels.flash_attention.ref import attention_ref
    (jq, jk, jv), (q, k, v) = _both(_qkv((2, 64, 32), (2, 64, 32), 6, 3.0),
                                    "float32")
    got = tfa.flash_attention(q, k, v, causal=True, softcap=50.0)
    for want in (flash_attention(jq, jk, jv, causal=True, softcap=50.0,
                                 bq=32, bkv=32),
                 attention_ref(jq, jk, jv, causal=True, softcap=50.0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                                   atol=3e-4)


def test_rows_with_no_valid_key_get_the_mean_of_v():
    """Sq=128 > Skv=64, causal, window 16: rows 79.. see no key. The JAX
    kernel and oracle give them the mean of v over all keys; so must the
    port."""
    from repro.kernels.flash_attention.flash_attention import flash_attention
    from repro.kernels.flash_attention.ref import attention_ref
    arrays = _qkv((2, 128, 32), (2, 64, 32), 11)
    (jq, jk, jv), (q, k, v) = _both(arrays, "float32")
    got = tfa.flash_attention(q, k, v, causal=True, window=16).numpy()
    for want in (flash_attention(jq, jk, jv, causal=True, window=16, bq=64,
                                 bkv=32),
                 attention_ref(jq, jk, jv, causal=True, window=16)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=2e-4)
    empty = got[:, 64 + 16 - 1:]
    np.testing.assert_allclose(
        empty, np.broadcast_to(arrays[2].mean(1, keepdims=True), empty.shape),
        rtol=1e-5, atol=1e-5)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (32, 50.0)])
def test_gqa_flash_matches_jax(window, softcap):
    from repro.kernels.flash_attention.ops import gqa_flash
    from repro.kernels.flash_attention.ref import plain_attention
    b, s, h, kvh, hd = 2, 128, 8, 2, 32
    (jq, jk, jv), (q, k, v) = _both(
        _qkv((b, s, h, hd), (b, s, kvh, hd), 7), "float32")
    got = tops.gqa_flash(q, k, v, causal=True, window=window,
                         softcap=softcap)
    assert got.shape == (b, s, h, hd)
    tol = dict(rtol=3e-4, atol=3e-4) if softcap else _tol("float32")
    for want in (gqa_flash(jq, jk, jv, causal=True, window=window,
                           softcap=softcap, bq=64, bkv=64),
                 plain_attention(jq, jk, jv, causal=True,
                                 window=window or None, attn_cap=softcap)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_plain_attention_matches_jax_with_a_query_offset():
    from repro.kernels.flash_attention.ref import plain_attention
    (jq, jk, jv), (q, k, v) = _both(
        _qkv((1, 16, 4, 8), (1, 48, 2, 8), 9), "float32")
    got = tref.plain_attention(q, k, v, causal=True, window=20,
                               attn_cap=30.0, q_offset=32)
    want = plain_attention(jq, jk, jv, causal=True, window=20, attn_cap=30.0,
                           q_offset=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_flash_rejects_bad_shapes_and_options():
    q, kv = torch.zeros((2, 8, 4)), torch.zeros((2, 8, 4))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, kv[:, :, :3], kv)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, kv, kv, window=-1)
    with pytest.raises(ValueError, match="divide"):
        tops.gqa_flash(torch.zeros((1, 8, 6, 4)), torch.zeros((1, 8, 4, 4)),
                       torch.zeros((1, 8, 4, 4)))


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _close(got, want, rtol):
    got, want = _np(got.cpu()), _np(want)
    return np.all(np.abs(got - want) <= rtol * np.abs(want)
                  + rtol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_kernel_matches_plain(cuda_device, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    rtol = 2e-2 if dtype == "bfloat16" else 1e-4
    td = getattr(torch, dtype)
    cases = ((100, 100, 32, True, 0, 0.0), (128, 256, 16, False, 0, 0.0),
             (128, 128, 64, True, 32, 0.0), (64, 64, 32, True, 0, 50.0),
             (128, 64, 32, True, 16, 0.0), (200, 130, 128, False, 32, 0.0))
    for i, (sq, skv, d, causal, window, cap) in enumerate(cases):
        q, k, v = (torch.from_numpy(a).to(td)
                   for a in _qkv((2, sq, d), (2, skv, d), i))
        want = tref.attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=cap)
        before = tfa.launch_count()
        got = tfa.flash_attention(q.to(cuda_device), k.to(cuda_device),
                                  v.to(cuda_device), causal=causal,
                                  window=window, softcap=cap)
        torch.cuda.synchronize()
        assert tfa.launch_count() - before == 1
        assert _close(got, want, rtol), cases[i]
    q, k, v = (torch.from_numpy(a).to(td)
               for a in _qkv((2, 96, 8, 32), (2, 80, 2, 32), 9))
    want = tref.plain_attention(q, k, v, causal=False, window=24)
    got = tops.gqa_flash(q.to(cuda_device), k.to(cuda_device),
                         v.to(cuda_device), causal=False, window=24)
    assert _close(got, want, rtol)


def test_cuda_tensor_never_reaches_the_plain_version(cuda_device,
                                                     monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(tref, "attention_ref", boom)
    monkeypatch.setattr(tref, "plain_attention", boom)
    q = torch.randn((2, 64, 4, 32), device=cuda_device)
    kv = torch.randn((2, 64, 2, 32), device=cuda_device)
    before = tfa.launch_count()
    tops.gqa_flash(q, kv, kv)
    tfa.flash_attention(q[:, :, 0], kv[:, :, 0], kv[:, :, 0])
    torch.cuda.synchronize()
    assert tfa.launch_count() - before == 2
