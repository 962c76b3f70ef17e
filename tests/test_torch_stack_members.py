"""The stack's member route: E fleet members' stacks at once.

Inside a ``torch.func`` transform (a fleet's ``vmap`` of the superstep,
``grad_and_value`` inside it) ``dense_stack`` takes two custom ops whose
vmap rules run the members together: on the card the forward and backward
kernels launch once for all members (``gridDim.z`` the member), on the CPU
the members twins loop the solo plain version. On the CPU:

* ``vmap(grad_and_value(loss))`` through ``dense_stack`` is bitwise a loop
  of solo autograd calls, for mlp, densenet and d2rl x swish and relu, E=3,
  with batched and unbatched (shared) weights, and with a constant weight,
  whose dW the backward is not asked for;
* the members twins are bitwise the solo twins, member by member;
* a member call's launches, against a recording stand-in for the CUDA
  libraries, are the solo call's: the same kernels in the same order with
  the same plans (tiles, splits, 16-byte copies), each once for all
  members, the member count and every operand's member stride passed
  (0 for a shared one), E sets of split counters; the register tile's
  and the tensor-core tile's mlp and d2rl stacks and the whole-stack
  backward included. The forward plans a member call for its E members
  (``plan_fwd``'s ``members``: the tensor-core tile's splits), so the
  solo call is planned as one of E members here.

On the card (skipped without one), each member kernel is bitwise E solo
launches of the same plan, forward and backward, at every forward kernel's
shapes, a shared weight included:

    python -m pytest tests/test_torch_stack_members.py -k cuda
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.dense_block import stack as tstack

CONNS = ("mlp", "densenet", "d2rl")
E = 3


def _members(conn, e, m, d0, u, n_layers, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32))
    x = f(e, m, d0)
    ws = [f(e, k, u, s=1 / np.sqrt(k)) for k in
          (tstack.in_dim(conn, i, d0, u) for i in range(n_layers))]
    bs = [f(e, u, s=0.3) for _ in range(n_layers)]
    g = f(e, m, tstack.feature_dim(conn, n_layers, d0, u))
    return x, ws, bs, g


# ------------------------------------------------- vmap(grad) on the CPU

@pytest.mark.parametrize("act", ("swish", "relu"))
@pytest.mark.parametrize("conn", CONNS)
def test_vmap_grad_is_bitwise_a_loop_of_solo_autograd(conn, act,
                                                      monkeypatch):
    """Layer 0's weight and every bias batched, layer 1's weight shared
    by the members (unbatched) and constant (not differentiated: its dW
    is not asked for), layer 2's batched; a second stack reads the first's
    output detached with only constant weights, so only its biases are
    differentiated."""
    m, d0, u = 5, 7, 8
    x, ws, bs, _ = _members(conn, E, m, d0, u, 3, seed=1)
    shared = ws[1][0]
    c = torch.from_numpy(np.random.default_rng(2).standard_normal(
        tstack.feature_dim(conn, 3, d0, u)).astype(np.float32))
    top = u if conn != "densenet" else d0 + 3 * u
    w2 = [torch.from_numpy(np.random.default_rng(3).standard_normal(
        (tstack.in_dim(conn, i, top, u), u)).astype(np.float32) * 0.2)
        for i in range(2)]

    def loss(p, x, shared):
        h = tstack.dense_stack(x, [p[0], shared, p[1]], p[2:5],
                               connectivity=conn, activation=act)
        h2 = tstack.dense_stack(h.detach(), w2, p[5:7], connectivity=conn,
                                activation=act)
        return (h * c).sum() + h2.square().mean()

    asked = []
    real_op = tstack._bwd_op

    def spy(*args):
        asked.append((args[7], tuple(args[8]), tuple(args[9])))
        return real_op(*args)
    monkeypatch.setattr(tstack, "_bwd_op", spy)
    bias2 = [b[:, :u] * 0.5 for b in bs[:2]]
    params = [ws[0], ws[2], *bs, *bias2]
    grads, value = torch.func.vmap(torch.func.grad_and_value(loss),
                                   in_dims=(0, 0, None))(params, x, shared)
    # the first stack: dx not asked (x is data), dW of the shared
    # constant weight skipped; the second: only its biases
    assert set(asked) == {(False, (True, False, True), (True,) * 3),
                          (False, (False, False), (True, True))}
    for e in range(E):
        p = [t[e].clone().requires_grad_(True) for t in params]
        want = loss(p, x[e], shared)
        g = torch.autograd.grad(want, p)
        assert torch.equal(value[e], want.detach())
        for a, b in zip(g, grads):
            assert torch.equal(a, b[e])


@pytest.mark.parametrize("conn", CONNS)
def test_vmap_forward_is_bitwise_a_loop_of_solo_calls(conn):
    """Under ``vmap`` alone (a fleet's collect and targets) the forward op
    runs the members twin: bitwise E solo ``dense_stack`` calls, x
    batched or shared."""
    x, ws, bs, _ = _members(conn, E, 4, 6, 8, 2, seed=4)
    got = torch.func.vmap(lambda x, *p: tstack.dense_stack(
        x, p[:2], p[2:], connectivity=conn))(x, *ws, *bs)
    shared = torch.func.vmap(lambda *p: tstack.dense_stack(
        x[0], p[:2], p[2:], connectivity=conn))(*ws, *bs)
    for e in range(E):
        solo = [t[e] for t in ws], [t[e] for t in bs]
        assert torch.equal(got[e], tstack.dense_stack(
            x[e], *solo, connectivity=conn))
        assert torch.equal(shared[e], tstack.dense_stack(
            x[0], *solo, connectivity=conn))


@pytest.mark.parametrize("act", ("swish", "relu", "tanh", "identity"))
@pytest.mark.parametrize("conn", CONNS)
def test_members_twins_are_bitwise_the_solo_twins(conn, act):
    x, ws, bs, g = _members(conn, E, 9, 5, 12, 3, seed=5)
    out = tstack.dense_stack_members_ref(x, ws, bs, connectivity=conn,
                                         activation=act)
    dx, dws, dbs = tstack.dense_stack_members_grads_ref(
        x, ws, bs, g, connectivity=conn, activation=act)
    assert torch.equal(out, tstack.dense_stack_members(
        x, ws, bs, connectivity=conn, activation=act))
    for e in range(E):
        solo = ([w[e] for w in ws], [b[e] for b in bs])
        assert torch.equal(out[e], tstack.dense_stack_ref(
            x[e], *solo, connectivity=conn, activation=act))
        want = tstack.dense_stack_grads_ref(x[e], *solo, g[e],
                                            connectivity=conn,
                                            activation=act)
        assert torch.equal(dx[e], want[0])
        for a, b in zip(dws + dbs, want[1] + want[2]):
            assert torch.equal(a[e], b)


def test_plain_backward_is_bitwise_autograd():
    """``dense_stack_grads_ref`` (``torch.func.vjp``, so that it also runs
    in a vmap rule) is bitwise ``torch.autograd.grad`` of the plain stack."""
    for conn in CONNS:
        x, ws, bs, g = _members(conn, 1, 9, 5, 12, 3, seed=6)
        var = [t[0].clone().requires_grad_(True) for t in (x, *ws, *bs)]
        out = tstack.dense_stack_ref(var[0], var[1:4], var[4:],
                                     connectivity=conn)
        want = torch.autograd.grad(out, var, g[0])
        dx, dws, dbs = tstack.dense_stack_grads_ref(
            x[0], [w[0] for w in ws], [b[0] for b in bs], g[0],
            connectivity=conn)
        for a, b in zip([dx, *dws, *dbs], want):
            assert torch.equal(a, b)


# ----------------------------- the member launch plan, recorded on the CPU

class _RecordingLib:
    """Stands in for a CUDA library of the stack: records every call."""

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


class _Event:
    def record(self, stream=None):
        pass


@pytest.fixture
def recorded(monkeypatch):
    """``_kernel_forward`` and ``_kernel_backward`` on CPU tensors against
    recording libraries; every counter request recorded."""
    libs = {"fwd": _RecordingLib(), "bwd": _RecordingLib()}
    asked = []

    def tile_counters(n, dev, stream):
        asked.append(n)
        return torch.zeros((n,), dtype=torch.int32)
    monkeypatch.setattr(tstack, "_library", lambda: libs["fwd"])
    monkeypatch.setattr(tstack, "_bwd_library", lambda: libs["bwd"])
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
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, s: None)
    tstack.reset_launch_count()
    yield libs, asked
    tstack.reset_launch_count()


def _is_ptr(v) -> bool:
    """A device address among a call's arguments (the rest are shapes,
    plans, strides and flags, all far below it)."""
    return isinstance(v, int) and v > 1 << 32


def _same_plan(solo, member, e):
    """A member call is its solo call's entry ``_members`` with the same
    arguments but addresses (member 0's, not the solo tensors'), then E
    and the member strides, then the stream."""
    (sname, sargs), (mname, margs) = solo, member
    assert mname == sname + "_members"
    n = len(sargs) - 1
    assert margs[-1] == sargs[-1]                   # the stream
    assert margs[n] == e
    for a, b in zip(sargs[:n], margs[:n]):
        if _is_ptr(a) or a is None or not isinstance(a, (int, float)):
            assert (a is None) == (b is None)
        else:
            assert a == b
    return margs[n + 1:-1]


def _member_plans(conn, m, d0, u, n_layers):
    """The layer plans of an E-member call (``plan_fwd_stack`` for E
    members), which a solo call is given to launch what one member of the
    member call launches."""
    return tstack.plan_fwd_stack(
        m, u, [tstack.in_dim(conn, i, d0, u) for i in range(n_layers)], 132,
        stack=(d0, n_layers) if conn == "densenet" else None, members=E)


@pytest.mark.parametrize("conn,m,d0,u,n_layers", [
    ("densenet", 128, 300, 128, 2),     # tensor-core tile, split K
    ("densenet", 201, 37, 301, 3),      # register tile, ragged
    ("densenet", 8, 40, 64, 2),         # the whole-stack kernel
    ("densenet", 8, 40, 128, 2),        # streaming, split K
    ("densenet", 1, 3, 256, 2),         # streaming, a 12-byte member x
    ("densenet", 256, 259, 2048, 2),    # the actor: tensor-core tile
    ("mlp", 128, 130, 128, 2),          # tensor-core tile, x padded
    ("mlp", 201, 3, 301, 3),            # register tile over h^T
    ("d2rl", 128, 4, 128, 3),           # thin: register tile over [h | x]^T
    ("d2rl", 128, 37, 128, 3),          # tensor-core tile over [h | x]
    ("d2rl", 201, 4, 301, 3),           # register tile over [h | x]^T
    ("densenet", 256, 260, 64, 4),      # phi_sa: whole forward and back
    ("d2rl", 8, 40, 64, 3),             # streaming, two segments
    ("d2rl", 256, 20, 64, 3)])          # U < 128: dense_tile.cuh
def test_member_launches_are_the_solo_plans(recorded, conn, m, d0, u,
                                            n_layers):
    """Forward and backward: the member call launches what one solo
    member launches (given the member call's plans), once for all E, with
    each operand's member stride (layer 1's weight shared: stride 0) and E
    sets of split counters."""
    libs, asked = recorded
    x, ws, bs, g = _members(conn, E, m, d0, u, n_layers)
    ws[1] = ws[1][:1].expand(E, *ws[1].shape[1:])       # shared, stride 0
    plans = _member_plans(conn, m, d0, u, n_layers)
    runs = {}
    for name, (xx, ww, bb, gg) in {
            "solo": (x[0], [w[0] for w in ws], [b[0] for b in bs], g[0]),
            "members": (x, ws, bs, g)}.items():
        for lib in libs.values():
            lib.calls.clear()
        asked.clear()
        zs = torch.empty((*xx.shape[:-1], n_layers * u))
        out = tstack._kernel_forward(xx, ww, bb, conn, "swish", zs) \
            if name == "members" else \
            tstack._forward_planned(xx, ww, bb, conn, "swish", zs, plans)
        keep = out if conn == "densenet" else xx
        tstack._kernel_backward((keep, zs), ww, gg, conn, "swish", True,
                                [True] * n_layers, [True] * n_layers)
        runs[name] = (list(libs["fwd"].calls), list(libs["bwd"].calls),
                      list(asked), out.shape)
    solo, members = runs["solo"], runs["members"]
    assert members[3] == (E, *solo[3])
    assert members[2] == [E * n for n in solo[2]]
    strides = []
    for side in (0, 1):
        assert len(members[side]) == len(solo[side]) > 0
        for sc, mc in zip(solo[side], members[side]):
            strides.append((mc[0], _same_plan(sc, mc, E)))
    # the shared weight reaches the kernels at member stride 0, the
    # batched ones at theirs
    layers = [(n, st) for n, st in strides[:len(solo[0])]
              if n != "dense_fwd_stream_init_members"]
    if layers[0][0] == "dense_stack_fwd_whole_members":
        w_strides = list(layers[0][1][1])
        assert w_strides[:2] == [ws[0].stride(0), 0]
    else:
        slot = {"dense_layer_fwd_members": 2, "dense_layer_fwd_rt_members": 1,
                "dense_layer_fwd_stream_members": 2,
                "dense_layer_fwd_tc_members": 1}
        assert [st[slot[n]] for n, st in layers[:2]] == [ws[0].stride(0), 0]
    assert tstack.bwd_launch_count() == 2


def test_member_stack_refuses_a_missing_member_axis(recorded):
    x, ws, bs, _ = _members("densenet", E, 4, 6, 8, 2)
    with pytest.raises(ValueError, match="member axis"):
        tstack._kernel_forward(x, [ws[0][0], ws[1]], bs, "densenet",
                               "swish")


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("conn,m,d0,u,n_layers", [
    ("densenet", 256, 259, 2048, 2),    # the actor: tensor-core tile
    ("densenet", 32, 259, 2048, 2),     # the actor at collect: streaming
    ("densenet", 1, 3, 64, 4),          # phi_s at a slot: whole stack
    ("densenet", 256, 260, 64, 4),      # phi_sa: whole stack
    ("densenet", 201, 37, 301, 3),      # register tile, ragged
    ("mlp", 256, 3, 2048, 2),           # fig3's mlp: tensor-core tile
    ("d2rl", 256, 4, 128, 3),           # tensor-core tile (thin, 3 members)
    ("mlp", 256, 3, 64, 3),             # U < 128: dense_tile.cuh
    ("d2rl", 8, 40, 64, 3)])            # streaming, two segments
def test_cuda_member_kernels_are_bitwise_solo_launches(cuda_device, conn, m,
                                                       d0, u, n_layers):
    """Every member launch bitwise E solo launches of its plan: the solo
    calls are given the member call's plans (the tensor-core tile's split
    counts the members)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    plans = _member_plans(conn, m, d0, u, n_layers)
    x, ws, bs, g = (t.to(cuda_device) if isinstance(t, torch.Tensor)
                    else [v.to(cuda_device) for v in t]
                    for t in _members(conn, E, m, d0, u, n_layers, seed=7))
    ws[1] = ws[1][:1].expand(E, *ws[1].shape[1:])       # shared
    zs = torch.empty((E, m, n_layers * u), device=cuda_device)
    before = tstack.launch_count()
    out = tstack.dense_stack_members(x, ws, bs, connectivity=conn, zs=zs)
    launches = tstack.launch_count() - before
    grads = tstack.dense_stack_members_grads(
        x, ws, bs, g, connectivity=conn,
        saved=(out if conn == "densenet" else x, zs))
    before = tstack.launch_count()
    solo = []
    for e in range(E):
        se = ([w[e].contiguous() for w in ws], [b[e] for b in bs])
        z1 = torch.empty((m, n_layers * u), device=cuda_device)
        o1 = tstack._forward_planned(x[e].contiguous(), *se, conn, "swish",
                                     z1, plans)
        solo.append((o1, z1, tstack._kernel_backward(
            (o1 if conn == "densenet" else x[e].contiguous(), z1), se[0],
            g[e].contiguous(), conn, "swish", True, [True] * n_layers,
            [True] * n_layers)))
    assert tstack.launch_count() - before == E * launches
    torch.cuda.synchronize()
    for e, (o1, z1, (dx, dws, dbs)) in enumerate(solo):
        assert torch.equal(out[e], o1) and torch.equal(zs[e], z1)
        assert torch.equal(grads[0][e], dx)
        for a, b in zip(grads[1] + grads[2], dws + dbs):
            assert torch.equal(a[e], b)
