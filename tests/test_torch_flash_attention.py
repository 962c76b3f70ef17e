"""The port's flash attention against the JAX reference.

On the CPU the port's ``flash_attention``/``gqa_flash`` run their plain
PyTorch versions; they must match the reference's Pallas kernel
(interpret mode) and its jnp oracles on the same seeded numpy inputs, at
the reference tests' tolerances (2e-4 float32, 2e-2 bfloat16, 3e-4 with
the soft-cap). A query row with no valid key gets the mean of v in both
packages (ROADMAP C6). The kernel's split-precision TF32 arithmetic
("3xTF32") is emulated (``ref.emulated_attention``) and held against a
float64 attention. The CUDA
kernel is held against the plain version on the card (skipped without
one); those tests import no JAX:

    python -m pytest tests/test_torch_flash_attention.py -k cuda
"""
import re

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


@pytest.mark.parametrize("sq,skv,d,causal", [(2048, 2048, 64, True),
                                             (512, 2048, 128, False)])
def test_3xtf32_attention_emulation_meets_the_fp32_bar(sq, skv, d, causal):
    """The kernel's split-precision TF32 route with the exp of its plan,
    emulated on the CPU (``ref.emulated_attention``) at B=1, H=2 (hd=64
    causal at S=2048; hd=128 non-causal over Skv=2048), its sums rounded
    to nearest and as the MMA rounds them (toward zero, a k8 slice at a
    time), against a float64 attention: inside the card's 1e-4 bar (rtol,
    and atol 1e-4 * max|exact|) and at least 10x under the error of one
    TF32 product a pair, so the card's agreement rests on the route, not
    on luck."""
    q, k, v = (torch.from_numpy(a) for a in
               _qkv((2, sq, d), (2, skv, d), sq + d))
    s = (q.double() * d ** -0.5) @ k.double().transpose(1, 2)
    if causal:
        ok = torch.arange(skv)[None, :] <= torch.arange(sq)[:, None]
        s = torch.where(ok, s, torch.full_like(s, -1e30))
    exact = torch.softmax(s, -1) @ v.double()
    fast = bool(tfa.PLAN[2])
    err3, err_rz, err1 = (
        (tref.emulated_attention(q, k, v, causal=causal, split=split,
                                 fast_exp=fast, mma_rz=rz).double()
         - exact).abs() for split, rz in ((True, False), (True, True),
                                          (False, False)))
    bar = 1e-4 * exact.abs() + 1e-4 * exact.abs().max()
    for err in (err3, err_rz):
        assert bool(torch.all(err <= bar))
        assert float(err.max()) * 10 <= float(err1.max())


def _mma(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One mma.sync m16n8k8 from per-lane fragments, in float64: a (32, 4)
    holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of A, b (32, 2)
    (k t, n g), (k t + 4, n g) of B; returns C's (g, 2t), (g, 2t + 1),
    (g + 8, 2t), (g + 8, 2t + 1) a lane (lane = 4g + t)."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[lane]
        B[t, g], B[t + 4, g] = b[lane]
    c = A @ B
    return np.array([[c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
                      c[g + 8, 2 * t + 1]]
                     for g, t in (divmod(lane, 4) for lane in range(32))])


def test_the_kernels_fragment_orders_give_q_kt_and_p_v():
    """``flash_attention.cu``'s fragment orders, mirrored lane by lane for
    one warp's 16 rows: q's A fragment and K's B fragment take dims 2t and
    2t + 1 for k slots t and t + 4; P's A fragment is the score
    accumulator as it stands (slot t key 2t, slot t + 4 key 2t + 1), V's B
    fragment keys 2t and 2t + 1 of dims 16m + 2g + e for output tile
    2m + e; the epilogue's dim of acc[n][i] is 16 (n / 2) + 4t + 2 (i & 1)
    + n % 2. Together they give S = q K^T and S V exactly."""
    rng = np.random.default_rng(5)
    hd, keys = 32, 16
    q, k, v = (rng.standard_normal(shape) for shape in
               ((16, hd), (keys, hd), (keys, hd)))
    lanes = [divmod(lane, 4) for lane in range(32)]
    s = np.zeros((keys // 8, 32, 4))
    for kk in range(hd // 8):
        a = np.array([[q[g, kk * 8 + 2 * t], q[g + 8, kk * 8 + 2 * t],
                       q[g, kk * 8 + 2 * t + 1], q[g + 8, kk * 8 + 2 * t + 1]]
                      for g, t in lanes])
        for j in range(keys // 8):
            b = np.array([[k[j * 8 + g, kk * 8 + 2 * t],
                           k[j * 8 + g, kk * 8 + 2 * t + 1]]
                          for g, t in lanes])
            s[j] += _mma(a, b)
    scores = q @ k.T
    for j in range(keys // 8):
        for lane, (g, t) in enumerate(lanes):
            for i in range(4):
                row, key = g + 8 * (i >> 1), 8 * j + 2 * t + (i & 1)
                assert s[j, lane, i] == pytest.approx(scores[row, key],
                                                      rel=1e-12, abs=1e-12)
    acc = np.zeros((hd // 8, 32, 4))
    for j in range(keys // 8):
        a = s[j][:, [0, 2, 1, 3]]
        for n in range(hd // 8):
            m, e = divmod(n, 2)
            b = np.array([[v[j * 8 + 2 * t, 16 * m + 2 * g + e],
                           v[j * 8 + 2 * t + 1, 16 * m + 2 * g + e]]
                          for g, t in lanes])
            acc[n] += _mma(a, b)
    out = np.zeros((16, hd))
    for n in range(hd // 8):
        for lane, (g, t) in enumerate(lanes):
            for i in range(4):
                col = 16 * (n // 2) + 4 * t + 2 * (i & 1) + n % 2
                out[g + 8 * (i >> 1), col] = acc[n, lane, i]
    np.testing.assert_allclose(out, scores @ v, rtol=1e-12, atol=1e-12)


def _smem_bytes(bkv: int, warps: int, elem: int, dmax: int) -> int:
    """``flash_attention.cu``'s ``Ring::kBytes``: 2 stages of K and V rows
    padded by 16 bytes and, at hd 128, q's fp32 rows."""
    stage = 2 * bkv * (dmax + 16 // elem) * elem
    return 2 * stage + (0 if dmax <= 64 else 16 * warps * (dmax + 4) * 4)


def test_flash_plans_are_launch_shapes_the_kernel_has():
    """``PLAN`` is among the builds the card sweep times; ``build_defines``
    gives every ``-D`` flag the source requires (a missing one stops the
    build); every swept shape keeps whole n8 tiles and fits the 227 KB a
    block may have at every head dim and dtype (the source asserts it)."""
    from repro_torch.launch import bwd_sweep
    src = tfa.SOURCE.read_text()
    required = set(re.findall(r"!defined\((\w+)\)", src))
    given = {d[2:].split("=")[0] for d in tfa.build_defines()}
    assert required == given == {"FLASH_WARPS", "FLASH_BKV", "FLASH_FAST_EXP"}
    assert tfa.PLAN in bwd_sweep.FLASH_PLANS
    assert bwd_sweep.FIRST_FLASH_SOURCE.exists()
    for warps, bkv, fast_exp in bwd_sweep.FLASH_PLANS:
        assert bkv % 8 == 0 and fast_exp in (0, 1)
        for elem in (4, 2):
            for dmax in (32, 64, 128):
                assert _smem_bytes(bkv, warps, elem, dmax) <= 232448


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


def _cuda_case(dev, dtype, sq, skv, d, causal, window, seed, bh=2):
    """(kernel, plain, v) for flat (bh, S, d) inputs made with numpy."""
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(td)
               for a in _qkv((bh, sq, d), (bh, skv, d), seed))
    before = tfa.launch_count()
    got = tfa.flash_attention(q.to(dev), k.to(dev), v.to(dev),
                              causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launch_count() - before == 1
    return got, tref.attention_ref(q, k, v, causal=causal, window=window), v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_at_the_tiles_edges(cuda_device, dtype):
    """Ragged Sq and Skv around the 64-row and 64-key tiles (63, 65, 127,
    129) and at 2048; head dims 32, 40, 64, 100 and 128 (40 and 100 leave
    zero-padded k8 steps); windows that cross key-tile edges, causal and
    not."""
    rtol = 2e-2 if dtype == "bfloat16" else 1e-4
    cases = ((63, 63, 32, True, 0), (65, 65, 40, True, 0),
             (127, 129, 64, False, 0), (129, 127, 100, True, 0),
             (2048, 2048, 128, True, 0), (65, 2048, 64, False, 0),
             (2048, 63, 40, False, 0), (129, 2048, 100, True, 0),
             (2048, 129, 32, True, 0), (200, 200, 64, True, 70),
             (300, 300, 100, True, 65), (129, 129, 32, False, 40),
             (2048, 2048, 64, True, 100))
    for i, (sq, skv, d, causal, window) in enumerate(cases):
        got, want, _ = _cuda_case(cuda_device, dtype, sq, skv, d, causal,
                                  window, i)
        assert _close(got, want, rtol), cases[i]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rows_with_no_valid_key_get_the_mean_of_v(cuda_device, dtype):
    """Sq > Skv with a window: rows 99.. (Skv 70 + window 30 - 1) and, in
    the second case, rows 159.. see no key; each gets the mean of v over
    all keys, and so does every row of a tile that holds such a row."""
    rtol = 2e-2 if dtype == "bfloat16" else 1e-4
    for sq, skv, d, window in ((200, 70, 64, 30), (300, 130, 128, 30)):
        got, want, v = _cuda_case(cuda_device, dtype, sq, skv, d, True,
                                  window, sq)
        assert _close(got, want, rtol)
        first = skv + window - 1
        mean_v = v.float().mean(1, keepdim=True).expand(-1, sq - first, -1)
        assert _close(got[:, first:], mean_v, rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_gqa_views_without_16_byte_rows(cuda_device, dtype):
    """q, k and v as views of wider tensors (hd 64 of 65 or 67 columns):
    their row strides rule out the 16-byte copies, so the kernel takes its
    4-byte or scalar path; the output matches the plain version on
    contiguous copies."""
    rtol = 2e-2 if dtype == "bfloat16" else 1e-4
    td = getattr(torch, dtype)
    b, sq, skv, h, kvh, hd = 2, 129, 200, 8, 2, 64
    qw, kw, vw = _qkv((b, sq, h, hd + 1), (b, skv, kvh, hd + 3), 21)
    vw = np.random.default_rng(22).standard_normal(kw.shape).astype(
        np.float32)
    q, k, v = (torch.from_numpy(a).to(td)[..., :hd] for a in (qw, kw, vw))
    for causal, window in ((True, 0), (False, 50)):
        want = tref.plain_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window or None)
        before = tfa.launch_count()
        got = tops.gqa_flash(q.to(cuda_device), k.to(cuda_device),
                             v.to(cuda_device), causal=causal, window=window)
        torch.cuda.synchronize()
        assert tfa.launch_count() - before == 1
        assert _close(got, want, rtol), (causal, window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_is_bitwise_repeatable(cuda_device, dtype):
    """Two calls at B=1 S=1024 H=8 KV=2 hd=64, causal with soft-cap: one
    launch each, bitwise equal outputs (no float atomics)."""
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(td).to(cuda_device)
               for a in _qkv((1, 1024, 8, 64), (1, 1024, 2, 64), 31))
    outs = []
    for _ in range(2):
        before = tfa.launch_count()
        outs.append(tops.gqa_flash(q, k, v, causal=True, softcap=30.0))
        torch.cuda.synchronize()
        assert tfa.launch_count() - before == 1
    assert torch.equal(outs[0], outs[1])
    assert bool(torch.isfinite(outs[0].float()).all())
