"""The sharded device replay (``execution.mesh_shards``) against the JAX
reference on a fake 4-device CPU mesh, and the sharded runner's
invariants.

* One subprocess (``XLA_FLAGS`` set before JAX is imported, as in
  ``tests/test_device_replay.py``) runs the reference's
  ``collect_and_add_sharded`` (n_step 1: a stamped add; n_step 3: the
  warm-up's ``drop``, then a stamped add), ``sharded_replay_sample``,
  ``sharded_replay_update`` and ``apex.collect_sharded`` with the random
  policy, writes every result and the draws each shard consumed (its
  noise, resets and uniforms from ``fold_in(key, shard)``) to an npz, and
  saves a reference ``Experiment`` at ``mesh_shards=4`` after its init.
  The port's functions get those draws and must give the reference's
  results: store ``ptr``/``count``/``add_step`` and leaf ``idx`` bitwise,
  store data, n-step rings, actors and weights within 1e-5, the tree and
  ``max_priority`` within 1e-4.
* The reference checkpoint restores in the port leaf for leaf and trains
  on there.
* The port's runner (the reference's fails, ROADMAP C1): ``n = 1`` is
  bitwise the unsharded run in both loops; at ``n = 4`` the python loop
  is bitwise the scan loop, ``n_step=3`` stays finite, the returns sit
  within the reference's own band of the unsharded run
  (``tests/test_train_loop.py``), and save/restore is bitwise at a split.
* On the card (skipped here) each sharded add, sample and refresh is one
  member-axis launch, bitwise the plain twins.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.kernels.replay_tree import ops
from repro_torch.launch.mesh import make_actor_mesh, replay_shards
from repro_torch.replay import (DeviceReplayConfig, collect_and_add_sharded,
                                sharded_nstep_init, sharded_replay_init,
                                sharded_replay_sample, sharded_replay_update)
from repro_torch.rl import apex
from repro_torch.rl.envs import EnvState, make_env
from repro_torch.rl.experiment import Experiment, ExperimentSpec
from repro_torch.rl.runner import state_leaves

SHARDS, ACTORS, CAP, BATCH = 4, 8, 32, 16

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_actor_mesh
from repro.replay import (DeviceReplayConfig, collect_and_add_sharded,
                          sharded_replay_init, sharded_replay_sample,
                          sharded_replay_update)
from repro.replay.sharded import sharded_nstep_init
from repro.rl import apex, make_env
from repro.rl.experiment import Experiment, ExperimentSpec

out_path, ckpt_path = sys.argv[1], sys.argv[2]
S, A, CAP, B = 4, 8, 32, 16
# (steps, drop, stamp, key) of each collect_and_add_sharded call: the
# warm-up's priming drop with no stamp, then a stamped add
_CALLS = {1: [(3, 0, 7, 1)], 3: [(3, 2, None, 1), (4, 0, 7, 2)]}
mesh = make_actor_mesh(S)
env = make_env("pendulum")
rand = apex.random_policy(env.act_dim)
out = {}
# each call under jax.jit: an eager shard_map dispatches its body op by op
# (about 3x the time on the CPU, with the same results)

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = "/".join(str(getattr(p, "key", getattr(p, "name",
                                                     getattr(p, "idx", p))))
                        for p in path)
        if not jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            out[prefix + "/" + name] = np.asarray(leaf)

def draws(key, steps):
    # what each shard's apex.collect consumes from fold_in(key, shard)
    a, n = env.act_dim, A // S
    noise = np.zeros((steps, A, a), np.float32)
    reset = np.zeros((steps, A, 2), np.float32)
    for i in range(S):
        for s, k in enumerate(jax.random.split(jax.random.fold_in(key, i),
                                               steps)):
            noise[s, i * n:(i + 1) * n] = jax.random.uniform(k, (n, a))
            for j, rk in enumerate(jax.random.split(k, n)):
                k1, k2, _ = jax.random.split(rk, 3)
                reset[s, i * n + j] = [jax.random.uniform(k1, ()),
                                       jax.random.uniform(k2, ())]
    return {"noise": noise, "reset": reset}

states0 = apex.init_actor_states(env, jax.random.key(0), A)
put("actors0", (states0.q, states0.qd, states0.t))
for ns in (1, 3):
    p = f"n{ns}"
    cfg = DeviceReplayConfig(capacity=CAP, obs_dim=env.obs_dim,
                             act_dim=env.act_dim, n_step=ns)
    st = sharded_replay_init(cfg, mesh)
    nst = (sharded_nstep_init(mesh, ns, A // S, env.obs_dim, env.act_dim)
           if ns > 1 else None)
    states = states0
    for call, (steps, drop, stamp, seed) in enumerate(_CALLS[ns]):
        key = jax.random.key(seed)
        for k, v in draws(key, steps).items():
            out[f"{p}/draws{call}/{k}"] = v
        step = None if stamp is None else jnp.int32(stamp)
        if ns > 1:
            states, nst, st = jax.jit(
                lambda a, k, r, b, t: collect_and_add_sharded(
                    env, rand, mesh, cfg, {}, a, steps, k, r,
                    nstep_state=b, gamma=0.99, step=t, drop=drop))(
                        states, key, st, nst, step)
            put(f"{p}/nstep{call}", nst)
        else:
            states, st = jax.jit(
                lambda a, k, r, t: collect_and_add_sharded(
                    env, rand, mesh, cfg, {}, a, steps, k, r, step=t))(
                        states, key, st, step)
        put(f"{p}/actors{call}", (states.q, states.qd, states.t))
        put(f"{p}/replay{call}", st)
    ks = jax.random.key(3)
    out[f"{p}/u"] = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(ks, i), (B // S,))) for i in range(S)])
    batch, idx, w = jax.jit(lambda r, k: sharded_replay_sample(
        cfg, mesh, r, k, B))(st, ks)
    put(f"{p}/batch", batch)
    out[f"{p}/idx"], out[f"{p}/w"] = np.asarray(idx), np.asarray(w)
    pr = jnp.abs(jax.random.normal(jax.random.key(4), (B,))) + 0.1
    out[f"{p}/pr"] = np.asarray(pr)
    put(f"{p}/updated", jax.jit(lambda r, i, q: sharded_replay_update(
        cfg, mesh, r, i, q))(st, idx, pr))

key = jax.random.key(5)
for k, v in draws(key, 2).items():
    out[f"pool/draws/{k}"] = v
states, trs = jax.jit(lambda a, k: apex.collect_sharded(
    env, rand, mesh, {}, a, 2, k))(states0, key)
put("pool/actors", (states.q, states.qd, states.t))
put("pool/trs", trs)
np.savez(out_path, **out)

spec = ExperimentSpec().override(
    env="pendulum", num_units=16, num_layers=1, use_ofenet=False,
    n_core=1, n_env=8, total_steps=10, warmup_steps=16, eval_every=5,
    eval_episodes=2, replay_capacity=512, batch_size=16,
    replay_backend="device", loop="scan", mesh_shards=4, n_step=3)
Experiment.from_spec(spec).save(ckpt_path)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    out, path = str(tmp / "ref.npz"), str(tmp / "mesh4.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(os.path.dirname(__file__), "..", "src")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _REFERENCE, out, path],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr
    with np.load(out) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, path


def _t(x):
    return torch.from_numpy(np.array(x))


def _actors(ref, prefix):
    return EnvState(*(_t(ref[f"{prefix}/{i}"]) for i in range(3)))


def _draws(ref, prefix):
    return {k: _t(ref[f"{prefix}/{k}"]) for k in ("noise", "reset")}


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-12),
                               err_msg=what)


def _check_replay(st, ref, prefix):
    for k, v in st["store"]["data"].items():
        _close(v.numpy(), ref[f"{prefix}/store/data/{k}"], 1e-5, k)
    for k in ("ptr", "count"):
        np.testing.assert_array_equal(st["store"][k].numpy(),
                                      ref[f"{prefix}/store/{k}"], k)
    np.testing.assert_array_equal(st["add_step"].numpy(),
                                  ref[f"{prefix}/add_step"])
    _close(st["tree"].numpy(), ref[f"{prefix}/tree"], 1e-4, "tree")
    _close(st["max_priority"].numpy(), ref[f"{prefix}/max_priority"], 1e-4,
           "max_priority")


def _check_actors(actors, ref, prefix):
    for i, name in enumerate(("q", "qd")):
        _close(actors[i].numpy(), ref[f"{prefix}/{i}"], 1e-5, name)
    np.testing.assert_array_equal(actors.t.numpy(), ref[f"{prefix}/2"])


@pytest.mark.parametrize("n_step", [1, 3])
def test_sharded_replay_matches_the_reference(ref, n_step):
    ref, _ = ref
    p = f"n{n_step}"
    env = make_env("pendulum")
    mesh = make_actor_mesh(SHARDS, "cpu")
    cfg = DeviceReplayConfig(capacity=CAP, obs_dim=env.obs_dim,
                             act_dim=env.act_dim, n_step=n_step)
    st = sharded_replay_init(cfg, mesh)
    nst = (sharded_nstep_init(mesh, n_step, ACTORS // SHARDS, env.obs_dim,
                              env.act_dim) if n_step > 1 else None)
    assert st["tree"].shape == (SHARDS, 64) and replay_shards(mesh) == 4
    actors = _actors(ref, "actors0")
    rand = apex.random_policy(env.act_dim)
    calls = [(0, 7)] if n_step == 1 else [(n_step - 1, None), (0, 7)]
    for call, (drop, stamp) in enumerate(calls):
        step = None if stamp is None else torch.tensor(stamp, dtype=torch.int32)
        out = collect_and_add_sharded(
            env, rand, mesh, cfg, {}, actors,
            _draws(ref, f"{p}/draws{call}"), st, nstep_state=nst,
            gamma=0.99, step=step, drop=drop)
        if n_step > 1:
            actors, nst, st2 = out
            for k, v in nst.items():
                _close(v.numpy(), ref[f"{p}/nstep{call}/{k}"], 1e-5,
                       f"nstep/{k}")
        else:
            actors, st2 = out
        assert st2 is st      # in place
        _check_actors(actors, ref, f"{p}/actors{call}")
        _check_replay(st, ref, f"{p}/replay{call}")
    batch, idx, w = sharded_replay_sample(cfg, mesh, st, _t(ref[f"{p}/u"]),
                                          BATCH)
    np.testing.assert_array_equal(idx.numpy(), ref[f"{p}/idx"])
    _close(w.numpy(), ref[f"{p}/w"], 1e-5, "weights")
    assert float(w.max()) == 1.0      # over the global max
    for k, v in batch.items():
        if k == "add_step":
            np.testing.assert_array_equal(v.numpy(), ref[f"{p}/batch/{k}"])
        else:
            _close(v.numpy(), ref[f"{p}/batch/{k}"], 1e-5, f"batch/{k}")
    sharded_replay_update(cfg, mesh, st, idx, _t(ref[f"{p}/pr"]))
    _check_replay(st, ref, f"{p}/updated")
    with pytest.raises(ValueError, match=r"u \(16,\)"):
        sharded_replay_sample(cfg, mesh, st, _t(ref[f"{p}/w"]), BATCH)


def test_collect_sharded_matches_the_reference(ref):
    ref, _ = ref
    env = make_env("pendulum")
    states, trs = apex.collect_sharded(
        env, apex.random_policy(env.act_dim), make_actor_mesh(SHARDS, "cpu"),
        {}, _actors(ref, "actors0"), _draws(ref, "pool/draws"))
    _check_actors(states, ref, "pool/actors")
    assert set(trs) == {k.split("/")[-1] for k in ref if
                        k.startswith("pool/trs/")}
    for k, v in trs.items():
        _close(v.numpy(), ref[f"pool/trs/{k}"], 1e-5, k)


def test_reference_sharded_checkpoint_restores_and_trains(ref):
    _, path = ref
    exp = Experiment.restore(path, device="cpu")
    assert exp.spec.execution.mesh_shards == 4 and exp.step == 0
    ls = exp._ls
    assert ls.replay["store"]["data"]["obs"].shape == (4, 128, 3)
    assert ls.replay["tree"].shape == (4, 256)
    assert ls.nstep["obs"].shape == (4, 3, 2, 3) and ls.actors.q.shape[0] == 8
    with np.load(path) as data:
        saved = {k: data[k] for k in data.files}
    got = dict(ckpt._leaves({"loop": ls._replace(gen=None)}))
    assert set(got) == {k for k in saved if not k.endswith(".key")
                        and k != ckpt.META_KEY}
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), saved[k], err_msg=k)
    # the warm-up: 3 steps of 8 actors, the ring's first 2 dropped
    assert (ls.replay["store"]["count"] == 2).all()
    res = exp.run(6)
    assert exp.step == 6 and res.eval_steps == [5]
    assert all(np.isfinite(res.returns))
    assert all(torch.isfinite(t).all() for t in state_leaves(exp._ls))


_RUN = dict(env="pendulum", algo="sac", num_units=16, num_layers=1,
            use_ofenet=False, n_core=1, n_env=8, total_steps=10,
            warmup_steps=16, eval_every=5, eval_episodes=2,
            replay_capacity=512, batch_size=16, replay_backend="device")


def _exp(**kw):
    return Experiment.from_spec(ExperimentSpec().override(**_RUN, **kw),
                                device="cpu")


def _same(a, b):
    return all(torch.equal(x.reshape(-1), y.reshape(-1))
               for x, y in zip(state_leaves(a), state_leaves(b))) \
        and torch.equal(a.gen.get_state(), b.gen.get_state())


@pytest.mark.parametrize("loop", ["scan", "python"])
def test_one_shard_is_bitwise_the_unsharded_run(loop):
    runs = [_exp(loop=loop, n_step=3, mesh_shards=n) for n in (0, 1)]
    res = [e.run(10, keep_last=True) for e in runs]
    assert runs[1]._ls.replay["tree"].ndim == 2
    assert _same(runs[0]._ls, runs[1]._ls)
    assert res[0].returns == res[1].returns
    assert res[0].metrics == res[1].metrics


@pytest.mark.filterwarnings("ignore:execution.mesh_shards")
def test_four_shards_loops_band_n_step_and_resume(tmp_path):
    single = _exp(loop="scan")
    rs = single.run(eval_at_end=True)
    scan, py = _exp(loop="scan", mesh_shards=4), _exp(loop="python",
                                                       mesh_shards=4)
    r4 = scan.run(eval_at_end=True, keep_last=True)
    rp = py.run(eval_at_end=True)
    assert _same(scan._ls, py._ls) and r4.returns == rp.returns
    assert r4.metrics["staleness_mean"] >= 0
    # the reference's own band (tests/test_train_loop.py)
    assert abs(np.mean(r4.returns) - np.mean(rs.returns)) < 400, (
        r4.returns, rs.returns)
    assert (scan._ls.replay["store"]["count"] == 4 + 10 * 2).all()
    n3 = _exp(loop="scan", mesh_shards=4, n_step=3).run(eval_at_end=True)
    assert all(np.isfinite(n3.returns))
    first = _exp(loop="scan", mesh_shards=4)
    first.run(7)
    path = str(tmp_path / "mesh4.npz")
    first.save(path)
    resumed = Experiment.restore(path, device="cpu")
    assert resumed.trainer.mesh.shards == 4
    resumed.run(3, eval_at_end=True)
    assert _same(resumed._ls, scan._ls) and resumed.returns == r4.returns


def test_mesh_rules(tmp_path):
    with pytest.raises(ValueError, match="must divide"):
        ExperimentSpec().override(**_RUN, mesh_shards=3)
    spec = ExperimentSpec().override(**_RUN, mesh_shards=2, loop="scan")
    # a given mesh must agree with the spec, which a checkpoint records
    for n, m in ((0, 2), (2, 4)):
        with pytest.raises(ValueError, match="execution.mesh_shards"):
            Experiment.from_spec(spec.override(mesh_shards=n), device="cpu",
                                 mesh=make_actor_mesh(m, "cpu"))
    with pytest.raises(ValueError, match="live on"):
        Experiment.from_spec(spec, device="cpu",
                             mesh=make_actor_mesh(2, "meta"))
    exp = Experiment.from_spec(spec, device="cpu",
                               mesh=make_actor_mesh(2, "cpu"))
    assert exp.trainer.dcfg.capacity == 256
    exp.run(3)
    path = str(tmp_path / "mesh2.npz")
    exp.save(path)
    back = Experiment.restore(path, device="cpu")
    assert back.trainer.mesh.shards == 2 and _same(back._ls, exp._ls)
    with pytest.raises(ValueError, match="execution.mesh_shards"):
        Experiment.restore(path, device="cpu", mesh=make_actor_mesh(4, "cpu"))
    with pytest.raises(ValueError, match="shards"):
        make_actor_mesh(0, "cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the member kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_sharded_ops_are_one_member_launch_each(cuda_device):
    env = make_env("pendulum")
    cfg = DeviceReplayConfig(capacity=25_000, obs_dim=env.obs_dim,
                             act_dim=env.act_dim)
    gen = torch.Generator().manual_seed(0)
    rows = {"obs": torch.randn(128, 3, generator=gen),
            "act": torch.rand(128, 1, generator=gen),
            "rew": torch.randn(128, generator=gen),
            "next_obs": torch.randn(128, 3, generator=gen),
            "done": torch.zeros(128)}
    u = torch.rand(4, 64, generator=gen)
    pr = torch.rand(256, generator=gen) + 0.1
    results = {}
    for dev in ("cpu", cuda_device):
        mesh = make_actor_mesh(4, dev)
        st = sharded_replay_init(cfg, mesh)
        ops.reset_launch_count()
        from repro_torch.replay import sharded_replay_add
        sharded_replay_add(cfg, mesh, st, {k: v.to(dev)
                                           for k, v in rows.items()})
        batch, idx, w = sharded_replay_sample(cfg, mesh, st, u.to(dev), 256)
        sharded_replay_update(cfg, mesh, st, idx, pr.to(dev))
        results[str(dev)] = (st["tree"].cpu(), idx.cpu(), w.cpu())
        if dev != "cpu":
            assert ops.launch_count("sample") == 1
            assert ops.launch_count("set") == 2
    a, b = results["cpu"], results[str(cuda_device)]
    for x, y in zip(a, b):
        assert torch.equal(x, y)
