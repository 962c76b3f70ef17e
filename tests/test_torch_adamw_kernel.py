"""AdamW's one-pass CUDA kernel (``optim/csrc/adamw.cu``) and its dispatch.

On the CPU:

* the dispatch: CPU trees (float32, float64, strided) take the torch ops,
  and ``adamw_path_counts`` says so; the kernel's operands are copied
  contiguous (a strided view, an argument expanded to every member) or
  refused (another dtype, another device, a leaf the members do not
  lead), never handed to torch ops;
* the custom op ``repro_torch::adamw_step`` on CPU tensors is bitwise
  ``adamw_update_ref`` solo, and under ``torch.func.vmap`` (5 members) its
  vmap rule is bitwise 5 solo calls and the vmapped ``adamw_update_ref``,
  also with a member axis on another dim, with unbatched grads and under
  a nested vmap;
* the state keeps the checkpoint layout ``{"mu", "nu", "count"}``, leaf
  for leaf, through ``ckpt.save`` / ``ckpt.restore``;
* a call past one launch's 40 leaves (41, and the 68 of an L=16 mlp's
  twin critics) through the foreach ops solo and leaf by leaf under vmap,
  bitwise ``adamw_update_ref`` over 3 steps, ``count`` once a call.

On a CUDA card (skipped without one):

* the kernel bitwise ``adamw_update_ref`` over 5 steps, on the four SAC
  calls' leaves of both benchmark configurations (densenet with OFENet,
  mlp), on ragged leaves (the 0-d ``log_alpha``, sizes not a multiple of
  4, leaves not 16-byte aligned), on strided views and on 90 leaves
  (three launches); with and without clipping, weight decay and a
  schedule, which the kernel covers;
* under ``vmap`` with E=5, bitwise 5 solo calls and the vmapped plain
  version, in one launch; unbatched grads (stride 0), a member axis last
  and a nested vmap take the kernel too; float64 leaves raise;
* the bias corrections the kernel computes from ``count`` bitwise
  ``torch.pow``'s at every count up to 200,000 and past 2^24;
* captured in a CUDA graph and replayed 3 times with ``count`` advancing,
  bitwise the eager steps;
* the path counter reads ``"kernel"`` for SAC's four calls and for a
  fleet's (fused and jnp blocks), and never ``"fallback"``;
* 41 and 68 leaves (two launches a call) solo and under ``vmap`` at E=5,
  eager and captured in a CUDA graph, bitwise ``adamw_update_ref`` over 3
  steps, ``count`` advanced once a call.
"""
import math

import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.common import tree_leaves, tree_map
from repro_torch.optim import adamw as A

SETTINGS = [(None, 0.0, False), (0.5, 0.0, False), (None, 0.01, False),
            (None, 0.0, True), (0.5, 0.01, True)]


def _cfg(clip, wd, sched, lr=1e-2):
    return A.AdamWConfig(lr=lr, weight_decay=wd, grad_clip_norm=clip,
                         schedule=A.warmup_cosine(2, 6) if sched else None)


def _tree(gen, lead=(), device="cpu", dtype=torch.float32, scale=1.0):
    def r(*shape):
        return scale * torch.randn(lead + shape, generator=gen,
                                   dtype=dtype).to(device)
    return {"w": r(4, 3), "b": r(3,), "odd": [r(7,), r(5, 3)], "s": r()}


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def _delta(fn):
    before = A.adamw_path_counts()
    out = fn()
    after = A.adamw_path_counts()
    return out, {k: after[k] - before[k] for k in after}


# ----------------------------------------------------------------- the CPU

@pytest.mark.parametrize("kind", ["float32", "float64", "non-contiguous"])
def test_cpu_float64_and_strided_trees_take_the_fallback(kind):
    gen = torch.Generator().manual_seed(0)
    dtype = torch.float64 if kind == "float64" else torch.float32
    p = _tree(gen, dtype=dtype)
    if kind == "non-contiguous":
        p["w"] = p["w"].t()
        assert not p["w"].is_contiguous()
    cfg = _cfg(None, 0.01, False)
    st = st_ref = A.adamw_init(p)
    p_ref = p
    for _ in range(3):
        g = tree_map(lambda t: 3 * torch.randn(t.shape, generator=gen,
                                               dtype=t.dtype), p)
        (p, st), d = _delta(lambda: A.adamw_update(cfg, g, st, p))
        assert d == {"kernel": 0, "fallback": 1}
        p_ref, st_ref = A.adamw_update_ref(cfg, g, st_ref, p_ref)
        assert _bitwise((p, st), (p_ref, st_ref))


def _meta_inputs(lead=(5,), shape=(4, 3)):
    t = lambda *sh, dtype=torch.float32: torch.empty(sh, device="meta",
                                                     dtype=dtype)
    leaves = [[t(*lead, *shape)] for _ in range(4)]
    return leaves, t(*lead, dtype=torch.int32), t(), t()


@pytest.mark.parametrize("kind", ["strided", "expanded", "contiguous"])
def test_the_kernel_operands_are_copied_contiguous(kind):
    (ps, gs, mus, nus), count, lr_t, scale = _meta_inputs()
    if kind == "strided":
        ps = [torch.empty((5, 3, 4), device="meta").transpose(1, 2)]
    elif kind == "expanded":                # one grad for every member
        gs = [torch.empty((4, 3), device="meta").expand(5, 4, 3)]
    assert all(t.is_contiguous() for t in ps + gs) == (kind == "contiguous")
    *trees, c, lr_k, scale_k = A._kernel_inputs(ps, gs, mus, nus, count,
                                                lr_t, scale)
    for t in [x for ts in trees for x in ts] + [c, lr_k, scale_k]:
        assert t.is_contiguous()
    assert [t.shape for ts in trees for t in ts] == [(5, 4, 3)] * 4
    assert lr_k.shape == scale_k.shape == (5,)     # one a member


@pytest.mark.parametrize("kind", ["float64", "count int64", "members",
                                  "grad shape", "device"])
def test_the_kernel_refuses_what_it_cannot_take(kind):
    (ps, gs, mus, nus), count, lr_t, scale = _meta_inputs()
    if kind == "float64":
        ps = [ps[0].to(torch.float64)]
    elif kind == "count int64":
        count = count.to(torch.int64)
    elif kind == "members":
        count = torch.empty((3,), device="meta", dtype=torch.int32)
    elif kind == "grad shape":
        gs = [torch.empty((5, 3, 4), device="meta")]
    else:
        mus = [torch.empty((5, 4, 3))]              # on the CPU
    with pytest.raises(TypeError if kind in ("float64", "count int64",
                                             "device") else ValueError):
        A._kernel_inputs(ps, gs, mus, nus, count, lr_t, scale)
    # no device but the CPU takes torch ops: the call goes to the kernel
    if kind == "float64":
        before = A.adamw_path_counts()
        with pytest.raises(TypeError):
            A._adamw_step(ps, gs, mus, nus, count, lr_t, scale, 1e-3, 0.9,
                          0.999, 1e-8, 0.0)
        assert A.adamw_path_counts() == before
    elif kind == "grad shape":
        with pytest.raises(RuntimeError, match="CUDA card"):
            A._launch(ps, ps, mus, nus, count, None, None, 1e-3, 0.9,
                      0.999, 1e-8, 0.0)


def _op_inputs(cfg, g, st, p):
    scale = (A._clip_scale(A.global_norm(g), cfg.grad_clip_norm)
             if cfg.grad_clip_norm is not None else None)
    lr_t = (cfg.lr * cfg.schedule(st["count"] + 1)
            if cfg.schedule is not None else None)
    return (tree_leaves(p), tree_leaves(g), tree_leaves(st["mu"]),
            tree_leaves(st["nu"]), st["count"], lr_t, scale, cfg.lr, cfg.b1,
            cfg.b2, cfg.eps, cfg.weight_decay)


@pytest.mark.parametrize("clip,wd,sched", SETTINGS)
def test_the_op_on_the_cpu_is_bitwise_the_plain_version(clip, wd, sched):
    cfg = _cfg(clip, wd, sched)
    gen = torch.Generator().manual_seed(1)
    p = p_ref = _tree(gen)
    st = st_ref = A.adamw_init(p)
    for _ in range(4):
        g = _tree(gen, scale=3.0)
        args = _op_inputs(cfg, g, st, p)
        flat, d = _delta(lambda: A._adamw_op(*args))
        assert d == {"kernel": 0, "fallback": 1}
        n = len(args[0])
        p, st = A._new_trees(p, flat[:n], flat[n:2 * n], flat[2 * n:3 * n],
                             flat[3 * n])
        p_ref, st_ref = A.adamw_update_ref(cfg, g, st_ref, p_ref)
        assert _bitwise((p, st), (p_ref, st_ref))


def _vmapped(fn, cfg, in_dims=0):
    return torch.func.vmap(lambda g, s, p: fn(cfg, g, s, p),
                           in_dims=in_dims)


@pytest.mark.parametrize("clip,wd,sched", SETTINGS)
def test_the_op_under_vmap_is_bitwise_solo_calls_and_the_plain_version(
        clip, wd, sched):
    cfg, e = _cfg(clip, wd, sched), 5
    gen = torch.Generator().manual_seed(2)
    p = _tree(gen, lead=(e,))
    st = torch.func.vmap(A.adamw_init)(p)
    solo = [(tree_map(lambda t: t[i], p), tree_map(lambda t: t[i], st))
            for i in range(e)]
    p_ref, st_ref = p, st
    for _ in range(3):
        g = _tree(gen, lead=(e,), scale=3.0)
        (p, st), d = _delta(lambda: _vmapped(A.adamw_update, cfg)(g, st, p))
        assert d == {"kernel": 0, "fallback": 1}
        p_ref, st_ref = _vmapped(A.adamw_update_ref, cfg)(g, st_ref, p_ref)
        assert _bitwise((p, st), (p_ref, st_ref))
        solo = [A.adamw_update(cfg, tree_map(lambda t: t[i], g), s, q)
                for i, (q, s) in enumerate(solo)]
        for i, member in enumerate(solo):
            assert _bitwise(member, tree_map(lambda t: t[i], (p, st)))


def test_the_vmap_rule_takes_any_member_dim_and_unbatched_grads():
    cfg, e = _cfg(None, 0.01, True), 5
    gen = torch.Generator().manual_seed(3)
    p = _tree(gen, lead=(e,))
    st = torch.func.vmap(A.adamw_init)(p)
    g = _tree(gen, scale=3.0)                  # one gradient for all
    got = _vmapped(A.adamw_update, cfg, (None, 0, 0))(g, st, p)
    want = _vmapped(A.adamw_update_ref, cfg, (None, 0, 0))(g, st, p)
    assert _bitwise(got, want)
    # the member axis last in the params and moments
    last = tree_map(lambda t: t.movedim(0, -1).contiguous(), (p, st))
    got = torch.func.vmap(lambda g, s, q: A.adamw_update(cfg, g, s, q),
                          in_dims=(None, -1, -1))(g, last[1], last[0])
    assert _bitwise(got, want)


def test_a_nested_vmap_is_bitwise_the_plain_version():
    cfg = _cfg(0.5, 0.01, True)
    gen = torch.Generator().manual_seed(9)
    p = _tree(gen, lead=(2, 3))
    st = torch.func.vmap(torch.func.vmap(A.adamw_init))(p)

    def nested(fn):
        return torch.func.vmap(torch.func.vmap(
            lambda g, s, q: fn(cfg, g, s, q)))
    for _ in range(3):
        g = _tree(gen, lead=(2, 3), scale=3.0)
        got, d = _delta(lambda: nested(A.adamw_update)(g, st, p))
        assert d == {"kernel": 0, "fallback": 1}
        want = nested(A.adamw_update_ref)(g, st, p)
        assert _bitwise(got, want) and got[1]["count"].shape == (2, 3)
        p, st = got


def test_the_state_keeps_its_checkpoint_layout(tmp_path):
    cfg = _cfg(None, 0.0, False)
    gen = torch.Generator().manual_seed(4)
    p = _tree(gen)
    st0 = A.adamw_init(p)
    _, st = A.adamw_update(cfg, _tree(gen), st0, p)
    _, st_e = _vmapped(A.adamw_update, cfg)(
        _tree(gen, lead=(2,)), torch.func.vmap(A.adamw_init)(
            _tree(gen, lead=(2,))), _tree(gen, lead=(2,)))
    assert set(st) == set(st0) == {"mu", "nu", "count"}
    assert st["count"].dtype == torch.int32 and st["count"].shape == ()
    assert st_e["count"].dtype == torch.int32 and st_e["count"].shape == (2,)
    ckpt.save(str(tmp_path / "a.npz"), {"opt": st0})
    ckpt.save(str(tmp_path / "b.npz"), {"opt": st})
    assert ckpt.leaf_names(str(tmp_path / "a.npz")) == \
        ckpt.leaf_names(str(tmp_path / "b.npz"))
    back = ckpt.restore(str(tmp_path / "b.npz"), {"opt": st0},
                        torch.device("cpu"))
    assert _bitwise(back["opt"], st)
    for a, b in zip(tree_leaves(st), tree_leaves(st0)):
        assert a.shape == b.shape and a.dtype == b.dtype


def _deep_tree(leaves, lead=(), device="cpu"):
    """A tree past one launch's 40 leaves: the twin critics of an L=16
    mlp (68 leaves, at U=32), or 41 leaves of ragged sizes; members
    stacked on ``lead``, each a little apart."""
    gen = torch.Generator().manual_seed(leaves)
    if leaves == 68:
        from repro_torch.core.blocks import MLPBlockConfig, mlp_block_init
        block = MLPBlockConfig(in_dim=4, num_layers=16, num_units=32,
                               connectivity="mlp", out_dim=1)
        tree = {q: mlp_block_init(gen, block, torch.device("cpu"))
                for q in ("q1", "q2")}
    else:
        tree = {f"l{i:02d}": torch.randn(5 * i + 3, generator=gen)
                for i in range(leaves)}
    assert len(tree_leaves(tree)) == leaves
    m = math.prod(lead)
    return tree_map(lambda t: torch.stack(
        [t + 0.01 * k for k in range(m)]).reshape(lead + t.shape).to(device),
        tree)


def _calls(cfg, lead):
    """``(init, step, plain)``: solo, or vmapped over the members."""
    if lead:
        return (torch.func.vmap(A.adamw_init), _vmapped(A.adamw_update, cfg),
                _vmapped(A.adamw_update_ref, cfg))
    return (A.adamw_init, lambda g, s, q: A.adamw_update(cfg, g, s, q),
            lambda g, s, q: A.adamw_update_ref(cfg, g, s, q))


def _steps(p, gen, n=3):
    """``n`` grads shaped as ``p``, on its device."""
    dev = tree_leaves(p)[0].device
    return [tree_map(lambda t: 1e-2 * torch.randn(
        t.shape, generator=gen).to(dev), p) for _ in range(n)]


@pytest.mark.parametrize("leaves", [41, 68])
def test_past_40_leaves_on_the_cpu_is_bitwise_the_plain_version(leaves):
    cfg = _cfg(None, 0.0, False, lr=3e-4)
    gen = torch.Generator().manual_seed(11)
    for lead in ((), (5,)):
        p = _deep_tree(leaves, lead)
        init, step, plain = _calls(cfg, lead)
        got = want = (p, init(p))
        for k, g in enumerate(_steps(p, gen), 1):
            got, d = _delta(lambda: step(g, got[1], got[0]))
            assert d == {"kernel": 0, "fallback": 1}
            want = plain(g, want[1], want[0])
            assert _bitwise(got, want)
            assert (got[1]["count"] == k).all()


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the AdamW kernel is CUDA")
    return torch.device("cuda")


def _agent_groups(name, device):
    """The four SAC calls' ``(params, state)`` of a benchmark configuration
    (fig10's densenet agent with OFENet, fig3's mlp), on the card."""
    from repro_torch.rl import presets
    from repro_torch.rl.envs import make_env
    from repro_torch.rl.policy import algo_config
    from repro_torch.rl.sac import sac_init
    over = dict(num_units=2048, block_backend="fused")
    if name == "fig10-ablation":
        over.update(ofenet_units=64, ofenet_layers=4)
    spec = presets.get(name).override(**over)
    acfg = algo_config(spec, make_env(spec.env))
    agent = sac_init(acfg, torch.Generator(device=device).manual_seed(0),
                     device)
    p, opt = agent["params"], agent["opt"]
    groups = [(p["actor"], opt["actor"]), (p["critics"], opt["critics"]),
              (p["log_alpha"], opt["alpha"])]
    if "ofenet" in opt:
        groups.append((p["ofenet"]["online"], opt["ofenet"]))
    return groups


def _randn_like(gen, shifted=(), scale=1e-2):
    """Draws shaped as a flat tree's leaves; the leaves named in ``shifted``
    are views 4 bytes past a 16-byte boundary."""
    def draw(name, t):
        n = t.numel() + (1 if name in shifted else 0)
        x = scale * torch.randn(n, generator=gen, device=t.device)
        return x[n - t.numel():].view(t.shape)
    return lambda tree: {k: draw(k, v) for k, v in tree.items()}


def _ragged(gen, device):
    """Leaves the vector path cannot take whole: a 0-d leaf, sizes not a
    multiple of 4, and (``u``, ``v``) views not 16-byte aligned."""
    shapes = {"s": (), "a": (7,), "b": (5, 3), "c": (3001,),
              "d": (4131, 2), "u": (2050,), "v": (33, 7)}
    p = _randn_like(gen, ("u", "v"), 1.0)(
        {k: torch.empty(s, device=device) for k, s in shapes.items()})
    assert p["u"].data_ptr() % 16 == 4
    return p


def _grads(gen, p):
    if isinstance(p, dict) and "u" in p:          # the ragged tree
        return _randn_like(gen, ("u", "v"))(p)
    return tree_map(lambda t: 1e-2 * torch.randn(
        t.shape, generator=gen, device=t.device), p)


def _strided(gen, device):
    """Views that are not contiguous: a transpose, a column slice, every
    other element."""
    def r(*shape):
        return torch.randn(shape, generator=gen, device=device)
    return {"t": r(300, 7).t(), "cols": r(64, 130)[:, 1:129],
            "every": r(4098)[::2]}


@pytest.mark.parametrize("clip,wd,sched", SETTINGS)
@pytest.mark.parametrize("leaves", ["fig10-ablation", "fig3-width",
                                    "ragged", "strided", "many"])
def test_cuda_kernel_is_bitwise_plain(cuda_device, leaves, clip, wd, sched):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    launches = 1
    if leaves == "ragged":
        groups = [_ragged(gen, cuda_device)]
    elif leaves == "strided":
        groups = [_strided(gen, cuda_device)]
        assert not any(t.is_contiguous() for t in groups[0].values())
    elif leaves == "many":
        # 90 leaves, more than one launch's table holds: three launches
        groups, launches = [{f"l{i:02d}": torch.randn(
            3 * i + 1, generator=gen, device=cuda_device)
            for i in range(90)}], 3
    else:
        groups = [q for q, _ in _agent_groups(leaves, cuda_device)]
    cfg = _cfg(clip, wd, sched, lr=3e-4)
    for p in groups:
        kern = ref = (p, A.adamw_init(p))
        for _ in range(5):
            g = _grads(gen, p)
            kern, d = _delta(lambda: A.adamw_update(cfg, g, kern[1],
                                                    kern[0]))
            assert d == {"kernel": launches, "fallback": 0}
            ref = A.adamw_update_ref(cfg, g, ref[1], ref[0])
            assert _bitwise(kern, ref)


def test_cuda_vmap_takes_the_kernel_for_any_layout(cuda_device):
    cfg, e = _cfg(0.5, 0.01, True, lr=3e-4), 5
    gen = torch.Generator().manual_seed(9)          # _tree draws on the CPU
    p = _tree(gen, lead=(e,), device=cuda_device)
    st = torch.func.vmap(A.adamw_init)(p)
    g = _tree(gen, scale=3.0, device=cuda_device)   # one grad for all
    want = _vmapped(A.adamw_update_ref, cfg, (None, 0, 0))(g, st, p)
    got, d = _delta(lambda: _vmapped(A.adamw_update, cfg, (None, 0, 0))(
        g, st, p))
    assert d == {"kernel": 1, "fallback": 0} and _bitwise(got, want)
    last = tree_map(lambda t: t.movedim(0, -1).contiguous(), (p, st))
    got, d = _delta(lambda: torch.func.vmap(
        lambda g, s, q: A.adamw_update(cfg, g, s, q),
        in_dims=(None, -1, -1))(g, last[1], last[0]))
    assert d == {"kernel": 1, "fallback": 0} and _bitwise(got, want)
    # a nested vmap: 2 x 3 members, one launch
    p = _tree(gen, lead=(2, 3), device=cuda_device)
    st = torch.func.vmap(torch.func.vmap(A.adamw_init))(p)
    g = _tree(gen, lead=(2, 3), scale=3.0, device=cuda_device)

    def nested(fn):
        return torch.func.vmap(torch.func.vmap(
            lambda g, s, q: fn(cfg, g, s, q)))
    got, d = _delta(lambda: nested(A.adamw_update)(g, st, p))
    assert d == {"kernel": 1, "fallback": 0}
    assert _bitwise(got, nested(A.adamw_update_ref)(g, st, p))
    # another dtype is refused, not run as torch ops
    p64 = _tree(gen, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        A.adamw_update(cfg, p64, A.adamw_init(p64), p64)


@pytest.mark.parametrize("clip,wd,sched", SETTINGS)
def test_cuda_vmap_is_one_launch_bitwise_solo_calls(cuda_device, clip, wd,
                                                    sched):
    e = 5
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    cfg = _cfg(clip, wd, sched, lr=3e-4)
    trees = [q for q, _ in _agent_groups("fig3-width", cuda_device)]
    for p in trees + [{k: t.contiguous()
                       for k, t in _ragged(gen, cuda_device).items()}]:
        p = tree_map(lambda t: torch.stack(
            [t + 0.01 * k for k in range(e)]), p)
        st = torch.func.vmap(A.adamw_init)(p)
        ref = (p, st)
        solo = [tree_map(lambda t: t[i].clone(), (p, st)) for i in range(e)]
        for _ in range(3):
            g = _grads(gen, p)
            (p, st), d = _delta(
                lambda: _vmapped(A.adamw_update, cfg)(g, st, p))
            assert d == {"kernel": 1, "fallback": 0}
            ref = _vmapped(A.adamw_update_ref, cfg)(g, ref[1], ref[0])
            assert _bitwise((p, st), ref)
            if clip is None:        # a batched norm may sum in its own order
                solo = [A.adamw_update(cfg, tree_map(
                    lambda t: t[i].contiguous(), g), s, q)
                    for i, (q, s) in enumerate(solo)]
                for i, member in enumerate(solo):
                    assert _bitwise(member, tree_map(lambda t: t[i],
                                                     (p, st)))


def test_cuda_bias_corrections_are_torch_pow_at_every_count(cuda_device):
    # one member a count: 0 .. 200,000 and counts past 2^24, where the
    # float of count + 1 rounds
    counts = torch.cat([torch.arange(200_001), torch.tensor(
        [2**24 - 2, 2**24 - 1, 2**24, 2**24 + 1, 2**24 + 2, 123_456_789,
         2**31 - 2])]).to(torch.int32).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    p = {"w": torch.randn((counts.shape[0], 3), generator=gen,
                          device=cuda_device)}
    st = {"mu": {"w": 1e-3 * torch.randn(p["w"].shape, generator=gen,
                                         device=cuda_device)},
          "nu": {"w": 1e-6 * torch.rand(p["w"].shape, generator=gen,
                                        device=cuda_device)},
          "count": counts}
    g = {"w": 1e-2 * torch.randn(p["w"].shape, generator=gen,
                                 device=cuda_device)}
    for cfg in (_cfg(None, 0.0, False, lr=3e-4),
                A.AdamWConfig(lr=1e-3, b1=0.5, b2=0.9)):
        got, d = _delta(lambda: _vmapped(A.adamw_update, cfg)(g, st, p))
        assert d == {"kernel": 1, "fallback": 0}
        want = _vmapped(A.adamw_update_ref, cfg)(g, st, p)
        assert torch.equal(got[1]["count"], counts + 1)
        assert _bitwise(got, want)


def test_cuda_graph_replays_advance_count_bitwise_eager(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    cfg = _cfg(None, 0.01, True, lr=3e-4)
    p = {"ragged": _ragged(gen, cuda_device),
         "actor": _agent_groups("fig3-width", cuda_device)[0][0]}
    st = A.adamw_init(p)
    grads = [tree_map(lambda t: 1e-2 * torch.randn(
        t.shape, generator=gen, device=cuda_device), p) for _ in range(3)]
    eager = [(p, st)]
    for g in grads:
        eager.append(A.adamw_update(cfg, g, eager[-1][1], eager[-1][0]))
    static = tree_map(torch.clone, (grads[0], st, p))
    A.adamw_update(cfg, *static)              # builds the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.adamw_update(cfg, *static)
    for g, want in zip(grads, eager[1:]):
        for d, s in zip(tree_leaves(static[0]), tree_leaves(g)):
            d.copy_(s)
        graph.replay()
        assert _bitwise((out[0], out[1]), want)
        for d, s in zip(tree_leaves((static[2], static[1])),
                        tree_leaves(out)):
            d.copy_(s)
    assert int(out[1]["count"]) == 3


@pytest.mark.parametrize("mode", ["solo", "vmap"])
@pytest.mark.parametrize("leaves", [41, 68])
def test_cuda_past_40_leaves_is_two_launches_bitwise_plain(
        cuda_device, leaves, mode):
    """A call of more leaves than one launch's table holds (the critics of
    an L=16 mlp: 68), solo and as a fleet of 5 under vmap, eager and then
    replayed from a captured graph."""
    cfg = _cfg(None, 0.0, False, lr=3e-4)
    gen = torch.Generator().manual_seed(12)
    lead = (5,) if mode == "vmap" else ()
    p = _deep_tree(leaves, lead, cuda_device)
    init, step, plain = _calls(cfg, lead)
    grads = _steps(p, gen)
    got = want = (p, init(p))
    eager = []
    for k, g in enumerate(grads, 1):
        got, d = _delta(lambda: step(g, got[1], got[0]))
        assert d == {"kernel": 2, "fallback": 0}
        want = plain(g, want[1], want[0])
        assert _bitwise(got, want) and (got[1]["count"] == k).all()
        eager.append(got)
    # the same steps from a captured graph, its state copied back
    static = tree_map(torch.clone, (grads[0], init(p), p))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, d = _delta(lambda: step(*static))
    assert d == {"kernel": 2, "fallback": 0}
    for g, want in zip(grads, eager):
        for dst, src in zip(tree_leaves(static[0]), tree_leaves(g)):
            dst.copy_(src)
        graph.replay()
        assert _bitwise((out[0], out[1]), want)
        for dst, src in zip(tree_leaves((static[2], static[1])),
                            tree_leaves(out)):
            dst.copy_(src)
    assert (out[1]["count"] == 3).all()


def test_cuda_sac_and_fleet_calls_take_the_kernel(cuda_device):
    from repro_torch.rl import Fleet
    from repro_torch.rl.experiment import Experiment, ExperimentSpec
    small = dict(num_units=64, num_layers=2, n_core=1, n_env=4,
                 total_steps=4, warmup_steps=8, eval_every=40,
                 eval_episodes=1, replay_capacity=256, batch_size=32,
                 replay_backend="device", block_backend="fused")
    spec = ExperimentSpec().override(use_ofenet=True, ofenet_units=8,
                                     loop="python", **small)
    exp = Experiment.from_spec(spec, device=cuda_device)
    _, d = _delta(lambda: exp.run(3))
    assert d == {"kernel": 12, "fallback": 0}      # 4 calls a superstep
    for backend in ("fused", "jnp"):
        specs = [ExperimentSpec().override(
            **{**small, "block_backend": backend}, use_ofenet=False,
            loop="scan", seed=s) for s in (0, 1)]
        fleet = Fleet(specs, device=cuda_device)
        _, d = _delta(lambda: fleet.run(4))
        assert d["kernel"] > 0 and d["fallback"] == 0, (backend, d)
