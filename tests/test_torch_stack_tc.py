"""The stack forward's tensor-core tile (``csrc/dense_tile_tc.cuh``, 3xTF32 on
wgmma): its launch accounting on the CPU, and the kernel on the card.

On the CPU, against a recording stand-in for the forward's library, every
wide stack of the benchmark's cells (mlp U=2048 L=2 and L=16, solo and as
5 members; the densenet actor and critic; d2rl) launches the tensor-core
tile once a layer, counted under ``"tc"``, with no register-tile launch and
no transposed init; and a training superstep at the cells' shapes counts
as many ``"tc"`` launches as ``plan_fwd_stack`` gives its stack layers at
the batch.

On the card (skipped without one): the kernel against the plain version at
the cells' shapes within the forward's bar (1e-4 of max|want|), the
pre-activations too, bitwise from call to call; its error against a float64
version at most twice the plain float32 version's at the cells' long
reductions (K = 2048 and 4355, the L = 16 chain, all-positive products);
each member of a member launch bitwise a solo launch of the same plan; and
a superstep's ``"tc"`` launches as the CPU accounting predicts:

    python -m pytest tests/test_torch_stack_tc.py -k cuda
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.dense_block import stack as tstack

# (connectivity, members, M, d0, U, L) of the benchmark cells' wide stacks
# at the batch: fig3's mlp critic and actor (pendulum: d0 = 4 and 3), Fig.
# 4's L=16, the densenet actor (stream 4355 wide) and critic, a d2rl stack
# and a ragged M (its first layer 35 wide: a thin one would keep this
# small stack on the register tile, plan_fwd_stack)
CELLS = [("mlp", None, 256, 4, 2048, 2), ("mlp", None, 256, 3, 2048, 2),
         ("mlp", 5, 256, 4, 2048, 2), ("mlp", 5, 256, 3, 2048, 16),
         ("densenet", None, 256, 259, 2048, 2),
         ("densenet", None, 256, 260, 2048, 2),
         ("d2rl", None, 256, 4, 2048, 2), ("mlp", None, 201, 35, 256, 3)]


def _stack(conn, e, m, d0, u, n_layers, seed=0, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    lead = () if e is None else (e,)

    def f(*shape, s=1.0):
        return s * torch.randn(shape, generator=gen, device=device)
    x = f(*lead, m, d0)
    ws = [f(*lead, k, u, s=1 / np.sqrt(k)) for k in
          (tstack.in_dim(conn, i, d0, u) for i in range(n_layers))]
    bs = [f(*lead, u, s=0.3) for _ in range(n_layers)]
    return x, ws, bs


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


@pytest.fixture
def recorded(monkeypatch):
    lib = _RecordingLib()
    monkeypatch.setattr(tstack, "_library", lambda: lib)
    monkeypatch.setattr(tstack, "_device_info", lambda dev: (132, 77))
    monkeypatch.setattr(tstack, "_tile_counters",
                        lambda n, dev, stream: torch.zeros(
                            (n,), dtype=torch.int32))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    tstack.reset_launch_count()
    yield lib
    tstack.reset_launch_count()


@pytest.mark.parametrize("conn,e,m,d0,u,n_layers", CELLS)
def test_cells_stacks_count_one_tc_launch_a_layer(recorded, conn, e, m, d0,
                                                  u, n_layers):
    """One launch of the tensor-core tile a layer, the member entry for a
    fleet (one launch for all members), under ``"tc"``; no register tile,
    no transposed init; each plan the one ``plan_fwd`` gives the layer for
    the launch's members."""
    x, ws, bs = _stack(conn, e, m, d0, u, n_layers)
    zs = torch.empty((*x.shape[:-1], n_layers * u))
    with torch.no_grad():
        tstack._kernel_forward(x, ws, bs, conn, "swish", zs)
    entry = "dense_layer_fwd_tc" + ("" if e is None else "_members")
    assert [n for n, _ in recorded.calls] == [entry] * n_layers
    assert tstack.launch_count("tc") == tstack.launch_count() == n_layers
    assert tstack.launch_count("rt") == tstack.transpose_count() == 0
    for w, (_, args) in zip(ws, recorded.calls):
        plan = tstack.plan_fwd(m, u, w.shape[-2], 132, members=e or 1)
        assert plan[0] == tstack._TC_CONFIG
        assert (args[15], args[16], args[17], args[19], args[20]) \
            == (m, u, w.shape[-2], plan[2], plan[3])
        if e is not None:
            assert args[21] == e


def _tc_layers_per_superstep(acfg, batch_size: int) -> int:
    """The superstep's stack layers that ``plan_fwd`` puts on the
    tensor-core tile: SAC's stack calls at the batch (``chip_smoke.py``'s
    ``expected_launches``: the actor twice, the critics 8 times, OFENet's
    7 + 5 times), one launch a layer; the actor pool's collect streams."""
    calls = [(2, acfg.actor_block()), (8, acfg.critic_block())]
    if acfg.ofenet:
        calls += [(7, acfg.ofenet.state_block), (5, acfg.ofenet.sa_block)]
    total = 0
    for n, blk in calls:
        dense = blk.connectivity == "densenet"
        plan = tstack.plan_fwd_stack(
            batch_size, blk.num_units,
            [tstack.in_dim(blk.connectivity, i, blk.in_dim, blk.num_units)
             for i in range(blk.num_layers)], 132,
            stack=(blk.in_dim, blk.num_layers) if dense else None)[0]
        if plan[0] == tstack._TC_CONFIG:
            total += n * blk.num_layers
    return total


def _cell_spec(name, **over):
    from repro_torch.rl import presets
    return presets.get(name).override(
        num_units=2048, replay_backend="device", block_backend="fused",
        warmup_steps=256, replay_capacity=1024, batch_size=256,
        eval_every=100, **over)


@pytest.mark.parametrize("name,over,want", [
    ("fig3-width", {}, 20), ("fig4-grid", {"num_layers": 16}, 160),
    ("fig10-ablation", {}, 20)])
def test_superstep_tc_launches_follow_the_plan(name, over, want):
    """At the cells' shapes (U = 2048, batch 256) every actor and critic
    layer of a superstep's stack calls at the batch takes the tensor-core
    tile: 10 L launches (fleet5 and graph: 20; x16: 160), the OFENet
    stacks (U = 64) none."""
    from repro_torch.rl.envs import make_env
    from repro_torch.rl.policy import algo_config
    spec = _cell_spec(name, **over)
    acfg = algo_config(spec, make_env(spec.env))
    assert _tc_layers_per_superstep(acfg, spec.execution.batch_size) == want


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _ref(conn, x, ws, bs, zs_too=False):
    if x.dim() == 3:
        per = [_ref(conn, x[i], [w[i] for w in ws], [b[i] for b in bs],
                    zs_too) for i in range(x.shape[0])]
        return [torch.stack(t) for t in zip(*per)] if zs_too \
            else torch.stack(per)
    out = tstack.dense_stack_ref(x, ws, bs, connectivity=conn)
    if not zs_too:
        return out
    zs, h, stream = [], x, x
    for i, (w, b) in enumerate(zip(ws, bs)):
        inp = stream if conn == "densenet" else \
            torch.cat([h, x], -1) if conn == "d2rl" and i else h
        zs.append(inp @ w + b)
        h = torch.nn.functional.silu(zs[-1])
        stream = torch.cat([stream, h], -1)
    return out, torch.cat(zs, -1)


@pytest.mark.parametrize("conn,e,m,d0,u,n_layers", CELLS)
def test_cuda_tc_matches_plain_at_the_cells_shapes(cuda_device, conn, e, m,
                                                   d0, u, n_layers):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, ws, bs = _stack(conn, e, m, d0, u, n_layers, seed=3,
                       device=cuda_device)
    zs = torch.empty((*x.shape[:-1], n_layers * u), device=cuda_device)
    before = tstack.launch_count("tc")
    got = tstack._kernel_forward(x, ws, bs, conn, "swish", zs)
    again = tstack._kernel_forward(x, ws, bs, conn, "swish")
    assert tstack.launch_count("tc") - before == 2 * n_layers
    want, want_zs = _ref(conn, x, ws, bs, zs_too=True)
    torch.cuda.synchronize()
    for a, b in ((got, want), (zs, want_zs)):
        bar = 1e-4 * float(b.abs().max())
        assert float((a - b).abs().max()) <= bar
    assert torch.equal(got, again)


@pytest.mark.parametrize("conn,d0,u,n_layers", [
    ("mlp", 4, 2048, 2), ("densenet", 259, 2048, 2), ("d2rl", 4, 512, 3)])
def test_cuda_tc_members_are_bitwise_solo_launches(cuda_device, conn, d0, u,
                                                   n_layers):
    """A 5-member launch: member e bitwise the solo launch of the same
    plan on its operands (the solo calls given the member call's plans)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    e = 5
    x, ws, bs = _stack(conn, e, 256, d0, u, n_layers, seed=4,
                       device=cuda_device)
    zs = torch.empty((e, 256, n_layers * u), device=cuda_device)
    out = tstack._kernel_forward(x, ws, bs, conn, "swish", zs)
    plans = tstack.plan_fwd_stack(
        256, u, [w.shape[-2] for w in ws],
        torch.cuda.get_device_properties(cuda_device).multi_processor_count,
        stack=(d0, n_layers) if conn == "densenet" else None, members=e)
    assert {p[0] for p in plans} == {tstack._TC_CONFIG}
    for i in range(e):
        z1 = torch.empty((256, n_layers * u), device=cuda_device)
        o1 = tstack._forward_planned(x[i].contiguous(),
                                     [w[i].contiguous() for w in ws],
                                     [b[i].contiguous() for b in bs], conn,
                                     "swish", z1, plans)
        torch.cuda.synchronize()
        assert torch.equal(out[i], o1) and torch.equal(zs[i], z1)


@pytest.mark.parametrize("name,over", [("fig3-width", {}),
                                       ("fig10-ablation", {})])
def test_cuda_superstep_tc_launches(cuda_device, name, over):
    """One eager superstep at the cells' shapes launches the tensor-core
    tile as many times as the CPU accounting says, and no register tile
    and no transposed init."""
    from repro_torch.rl.runner import Trainer
    tr = Trainer(_cell_spec(name, **over), device=cuda_device)
    ls = tr.init()
    tr.step(ls)
    torch.cuda.synchronize()
    tstack.reset_launch_count()
    tr.step(ls)
    torch.cuda.synchronize()
    assert tstack.launch_count("tc") == _tc_layers_per_superstep(
        tr.acfg, tr.batch_size)
    assert tstack.launch_count("rt") == tstack.transpose_count() == 0


# the cells' long reductions, held to the plain float32 version's error:
# fig3's K = 2048, the L = 16 chain of Fig. 4 at 5 members, the densenet
# actor (K = 259, 2307), a K = 4355 layer (the actor's stream width); and
# K = 2048 and 4355 with every product positive (a nonzero mean, so a sum
# that rounds toward zero drifts one way)
PRECISION = [("mlp", None, 256, 4, 2048, 2, False),
             ("mlp", 5, 256, 3, 2048, 16, False),
             ("densenet", None, 256, 259, 2048, 2, False),
             ("mlp", None, 256, 4355, 2048, 1, False),
             ("mlp", None, 256, 2048, 2048, 1, True),
             ("mlp", None, 256, 4355, 2048, 1, True)]


@pytest.mark.parametrize("conn,e,m,d0,u,n_layers,positive", PRECISION)
def test_cuda_tc_error_is_the_float32_versions(cuda_device, conn, e, m, d0,
                                               u, n_layers, positive):
    """Against a float64 version on the same inputs, the tile's largest
    error (feature and pre-activations) is at most twice the plain
    float32 version's (``allow_tf32`` off): 3xTF32 products summed in
    float32. A tile that let the tensor core sum all of K (its sums round
    toward zero) read 1.6e-5 of max|z| at K = 2048, 20 times this."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, ws, bs = _stack(conn, e, m, d0, u, n_layers, seed=5,
                       device=cuda_device)
    if positive:
        x = x.abs()
        ws = [w.abs() for w in ws]
        bs = [b.abs() for b in bs]
    zs = torch.empty((*x.shape[:-1], n_layers * u), device=cuda_device)
    got = tstack._kernel_forward(x, ws, bs, conn, "swish", zs)
    f32 = _ref(conn, x, ws, bs, zs_too=True)
    f64 = _ref(conn, x.double(), [w.double() for w in ws],
               [b.double() for b in bs], zs_too=True)
    torch.cuda.synchronize()
    for name, a, b, c in (("feature", got, f32[0], f64[0]),
                          ("z", zs, f32[1], f64[1])):
        err = float((a.double() - c).abs().max())
        err32 = float((b.double() - c).abs().max())
        top = float(c.abs().max())
        print(f"{conn} E={e} d0={d0} L={n_layers} positive={positive} "
              f"{name}: tile {err / top:.3e}, float32 {err32 / top:.3e} "
              f"of max|want|; mean error tile "
              f"{float((a.double() - c).mean()) / top:.3e}, float32 "
              f"{float((b.double() - c).mean()) / top:.3e}")
        assert err <= 2 * err32
