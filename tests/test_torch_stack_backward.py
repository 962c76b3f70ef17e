"""The port's stack backward against the reference's Pallas backward.

On the CPU, ``dense_stack`` differentiates its plain version through
autograd (``dense_stack_grads_ref``); dx, every dW_i and every db_i must
match ``jax.vjp`` of the reference's ``dense_stack(impl="pallas",
interpret=True)``, whose backward is the TPU kernel ``_bwd_kernel``, on the
same seeded inputs and cotangent: every fused connectivity x activation at
a ragged shape, and each connectivity at a narrow ``phi_sa``-like shape
(the training path's OFENet stack, swish). Tolerance: the repo's gradient
bar, rtol 1e-3 and atol 1e-3 * max|want| (float32 reassociation).

On the card (skipped without one; no JAX imported there) the backward
kernels (``csrc/dense_stack_bwd.cu``) are held against the plain version,
must be bitwise equal across two calls, and must compute only the
gradients autograd asks for:

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
    for m, d0, u, L in (RAGGED, PHI_SA, (256, 516, 2048, 2)):
        x, ws, bs, g = _make(conn, m, d0, u, L, seed=L)
        want = tstack.dense_stack_grads_ref(
            torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(b) for b in bs], torch.from_numpy(g),
            connectivity=conn, activation=act)
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
