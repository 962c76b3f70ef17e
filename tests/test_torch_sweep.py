"""The port's vmapped fleets (``repro_torch.rl.sweep``) against the JAX
reference and against its own solo runs, on the CPU.

* One member-batched superstep against the reference's: a JAX ``Fleet``
  of 3 seeds (jnp or fused blocks, the xla sum-tree, OFENet on; the
  reference's fused stack runs its XLA twin on the CPU, the port's its
  members twin, a loop of the solo plain version) warms up and hands
  its stacked state over; the port's ``Trainer.fleet_step``, fed each
  member's draws of ``_device_step`` from its own key, must give the
  reference's ``jax.vmap(Trainer._superstep)``: params within 1e-6, AdamW
  moments within 1e-3 of their scale, actors, store and sum-tree as in
  ``test_torch_train.py``. The warm-up fills the replay (64 rows, batch
  16, equal priorities), so the 16 strata sample 16 distinct leaves and
  the reference's xla write, whose winner among repeated indices is
  unspecified (ROADMAP C2), is comparable leaf for leaf.
* The routes the vmapped body takes: ``value_and_grad_func`` is bitwise
  ``torch.autograd.grad`` on ``sac_update``'s and ``td3_update``'s
  losses; ``adamw_update`` under vmap (``adamw_update_ref``) is bitwise a
  loop of per-member ``adamw_update`` (foreach).
* The port's analogues of ``tests/test_sweep.py``: member vs solo within
  ``SOLO_PARITY``, the freeze bitwise, resume at a mid-chunk split, the
  whole run and per-segment dispatch bitwise, the rejections (with the
  differing paths), ``from_grid``'s partition and host upgrade, and both
  ``exploit_explore`` tests. With fused blocks a member matches its solo
  run within ``SOLO_PARITY`` and ``Sweep.from_grid`` partitions and steps
  (the stack's member route; its kernels are held bitwise to solo
  launches in ``tests/test_torch_stack_members.py``). The reference rejects
  ``replay.kernel='pallas'`` in a fleet; the port accepts both values (the
  CPU runs the plain sum-tree and the card its member-axis kernels either
  way; ROADMAP C12).
"""
import jax
import numpy as np
import pytest
import torch

from repro.rl.experiment import ExperimentSpec as JSpec
from repro.rl.sweep import Fleet as JFleet
from repro_torch import convert
from repro_torch import common
from repro_torch.common import tree_leaves
from repro_torch.optim import adamw
from repro_torch.rl import Fleet, MemberResult, Sweep
from repro_torch.rl import sac as sac_mod, sweep as sweep_mod, \
    td3 as td3_mod
from repro_torch.rl.envs import EnvState
from repro_torch.rl.experiment import (Experiment, ExperimentSpec,
                                      SpecError, SpecWarning)
from repro_torch.rl.runner import (TrainLoopState, Trainer, _stack_trees,
                                   clone_state, member_state,
                                   stack_states, state_leaves)
from repro_torch.rl.sweep import SOLO_PARITY_ATOL, SOLO_PARITY_RTOL

_SMALL = dict(num_units=16, num_layers=1, use_ofenet=False, n_core=1,
              n_env=4, total_steps=12, warmup_steps=8, eval_every=3,
              eval_episodes=1, replay_capacity=256, batch_size=16,
              replay_backend="device", loop="scan")


def _small(**overrides):
    return ExperimentSpec().override(**{**_SMALL, **overrides})


def _fleet(seeds=(0, 1, 2), **overrides):
    spec = _small(**overrides)
    return Fleet([spec.override(seed=s) for s in seeds], device="cpu")


def _same(a, b) -> bool:
    """Two (member) states equal bitwise, every tensor and generator."""
    gens = (list(zip(a.gen, b.gen)) if isinstance(a.gen, list)
            else [(a.gen, b.gen)])
    return all(torch.equal(x, y) for x, y in zip(state_leaves(a),
                                                 state_leaves(b))) \
        and all(torch.equal(g.get_state(), h.get_state()) for g, h in gens)


# --------------------------------------------- one superstep against JAX

_JBASE = dict(env="pendulum", num_units=16, num_layers=2, use_ofenet=True,
              ofenet_units=8, ofenet_layers=2, n_core=1, n_env=4,
              total_steps=6, warmup_steps=60, eval_every=3,
              eval_episodes=2, replay_capacity=64, batch_size=16,
              replay_backend="device", replay_kernel="xla")


def _np(tree):
    """Arrays as numpy; PRNG keys (the reference's, not ported) as None."""
    return jax.tree_util.tree_map(
        lambda x: None if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key)
        else np.asarray(x), tree)


def _port_state(jls):
    t = lambda tree: convert.params_from_numpy(_np(tree), device="cpu")
    actors = EnvState(*(torch.from_numpy(np.array(a)) for a in
                        (jls.actors.q, jls.actors.qd, jls.actors.t)))
    return TrainLoopState(t(jls.agent), actors, None, t(jls.replay),
                          torch.Generator(),
                          torch.tensor(int(jls.step), dtype=torch.int32))


def _jax_draws(jtr, key):
    """The draws of the reference's ``_device_step`` from ``key``."""
    _, kc, ks, ku = jax.random.split(key, 4)
    n, a = jtr.n_actors, jtr.env.act_dim
    (k,) = jax.random.split(kc, 1)
    resets = []
    for rk in jax.random.split(k, n):
        k1, k2, _ = jax.random.split(rk, 3)       # pendulum's reset
        resets.append([float(jax.random.uniform(k1, ())),
                       float(jax.random.uniform(k2, ()))])
    f = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    draws = {"collect": {"noise": f(jax.random.normal(k, (n, a)))[None],
                         "reset": f(resets)[None]},
             "u": f(jax.random.uniform(ks, (jtr.batch_size,)))}
    if jtr.spec.algo == "td3":
        draws["noise"] = f(jax.random.normal(ku, (jtr.batch_size, a)))
    else:
        k1, k2 = jax.random.split(ku)
        draws["eps1"] = f(jax.random.normal(k1, (jtr.batch_size, a)))
        draws["eps2"] = f(jax.random.normal(k2, (jtr.batch_size, a)))
    return draws


def _close(a, b, rtol, what):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-12),
                               err_msg=what)


@pytest.mark.parametrize("block_backend", ["jnp", "fused"])
@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_fleet_superstep_matches_jax_vmapped_superstep(algo, block_backend):
    over = dict(_JBASE, algo=algo, block_backend=block_backend)
    jf = JFleet([JSpec().override(**over).override(seed=s)
                 for s in (0, 1, 2)])
    jf._ensure_init()
    jtr, jfls = jf.trainer, jf._fls
    members = [jax.tree_util.tree_map(lambda v: v[m], jfls)
               for m in range(3)]
    tls = stack_states([_port_state(m) for m in members])
    draws = _stack_trees([_jax_draws(jtr, m.key) for m in members])
    jls2, _, _ = jax.jit(jax.vmap(jtr._superstep))(jfls)
    ttr = Trainer(ExperimentSpec().override(**over), device="cpu")
    tls2, metrics, _ = ttr.fleet_step(tls, draws)
    j = _np(jls2)
    for a, b in zip(tree_leaves(tls2.agent["params"]),
                    tree_leaves(j.agent["params"])):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    for name in j.agent["opt"]:
        for part in ("mu", "nu"):
            for a, b in zip(tree_leaves(tls2.agent["opt"][name][part]),
                            tree_leaves(j.agent["opt"][name][part])):
                _close(a.numpy(), b, 1e-3, f"opt/{name}/{part}")
    _close(tls2.actors.q.numpy(), j.actors.q, 1e-5, "actors.q")
    np.testing.assert_array_equal(tls2.actors.t.numpy(), j.actors.t)
    rs, jr = tls2.replay, j.replay
    for k in rs["store"]["data"]:
        _close(rs["store"]["data"][k].numpy(), jr["store"]["data"][k], 1e-5,
               f"store/{k}")
    _close(rs["tree"].numpy(), jr["tree"], 1e-4, "tree")
    _close(rs["max_priority"].numpy(), jr["max_priority"], 1e-4,
           "max_priority")
    np.testing.assert_array_equal(rs["add_step"].numpy(), jr["add_step"])
    np.testing.assert_array_equal(tls2.step.numpy(), j.step)
    assert metrics["critic_loss"].shape == (3,)


# ------------------------------------------------ the vmapped body's routes

@pytest.mark.parametrize("algo,mod", [("sac", sac_mod), ("td3", td3_mod)])
def test_value_and_grad_func_is_bitwise_autograd(algo, mod, monkeypatch):
    spec = ExperimentSpec().override(
        algo=algo, num_units=16, ofenet_units=8, ofenet_layers=2, n_core=1,
        n_env=4, warmup_steps=8, replay_capacity=64, batch_size=16,
        replay_backend="device")
    tr = Trainer(spec, device="cpu")
    ls = tr.init()
    draws = tr.draws(torch.Generator().manual_seed(3))
    want, wm, _ = tr.step(clone_state(ls), draws)
    monkeypatch.setattr(mod, "value_and_grad", common.value_and_grad_func)
    got, gm, _ = tr.step(clone_state(ls), draws)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got.agent),
                                                 tree_leaves(want.agent)))
    assert torch.equal(gm["actor_loss"], wm["actor_loss"])


def test_adamw_under_vmap_is_bitwise_per_member_foreach():
    cfg = adamw.AdamWConfig(lr=1e-3, weight_decay=0.01, grad_clip_norm=1.0)
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    params = {"w": r(3, 4, 5), "b": r(3, 5)}
    grads = {"w": r(3, 4, 5), "b": r(3, 5)}
    state = {"mu": {"w": 0.1 * r(3, 4, 5), "b": 0.1 * r(3, 5)},
             "nu": {"w": r(3, 4, 5).abs(), "b": r(3, 5).abs()},
             "count": torch.tensor([0, 4, 9], dtype=torch.int32)}
    vp, vs = torch.func.vmap(lambda gr, st, p: adamw.adamw_update(
        cfg, gr, st, p))(grads, state, params)
    for m in range(3):
        pick = lambda t: common.tree_map(lambda x: x[m], t)
        p, s = adamw.adamw_update(cfg, pick(grads), pick(state),
                                  pick(params))
        assert all(torch.equal(a, b[m]) for a, b in zip(
            tree_leaves((p, s)), tree_leaves((vp, vs))))


# ------------------------------------------------------------- solo parity

def test_member_matches_solo_run_within_tolerance():
    fleet = _fleet()
    fleet.run(12)
    solo = Experiment.from_spec(_small(seed=1), device="cpu")
    res = solo.run(12)
    fr = fleet.results()[1]
    assert fr.eval_steps == res.eval_steps
    np.testing.assert_allclose(fr.returns, res.returns,
                               rtol=SOLO_PARITY_RTOL, atol=SOLO_PARITY_ATOL)
    for a, b in zip(tree_leaves(fleet._fls.agent["params"]),
                    tree_leaves(solo._ls.agent["params"])):
        np.testing.assert_allclose(a[1].numpy(), b.numpy(),
                                   rtol=SOLO_PARITY_RTOL,
                                   atol=SOLO_PARITY_ATOL)


def test_member_init_is_bitwise_the_solo_init():
    fleet = _fleet(seeds=(4, 7))
    fleet._ensure_init()
    for m, seed in enumerate((4, 7)):
        solo = Trainer(_small(seed=seed), device="cpu").init()
        assert _same(member_state(fleet._fls, m), solo)


# ------------------------------------------------------- early-stop masking

def test_freeze_is_bitwise_and_does_not_perturb_neighbors():
    fleet, twin = _fleet(), _fleet()
    fleet.run(6)
    twin.run(6)
    frozen = clone_state(member_state(fleet._fls, 1))
    fleet.set_done([1])
    fleet.run(6)
    twin.run(6)
    assert _same(member_state(fleet._fls, 1), frozen)
    assert fleet.eval_steps[1] == [3, 6]
    for m in (0, 2):
        assert _same(member_state(fleet._fls, m),
                     member_state(twin._fls, m))
        assert fleet.returns[m] == twin.returns[m]
    fleet.set_done([1], False)
    fleet.run(3)
    assert fleet.eval_steps[1] == [3, 6, 15]
    back = _fleet()                 # unfrozen member 1 == 9 steps of it
    back.run(9)
    assert _same(member_state(fleet._fls, 1), member_state(back._fls, 1))


def test_stop_at_return_freezes_members():
    fleet = _fleet()
    fleet.run(6, stop_at_return=-float("inf"))
    assert fleet.done.all()
    step0 = clone_state(fleet._fls)
    fleet.run(3)
    assert _same(fleet._fls, step0)


# ------------------------------------------------------------ resume parity

def test_fleet_save_restore_resume_parity_mid_chunk(tmp_path):
    path = str(tmp_path / "fleet.npz")
    full = _fleet(seeds=(0, 1))
    full.run(12)
    part = _fleet(seeds=(0, 1))
    part.run(5)                    # mid eval-period split (eval_every=3)
    part.save(path)
    back = Fleet.restore(path, device="cpu")
    assert back.step == 5
    back.run(7)
    assert _same(back._fls, full._fls)
    assert back.returns == full.returns
    assert back.eval_steps == full.eval_steps


def test_whole_run_and_per_segment_dispatch_agree_bitwise():
    whole = _fleet(seeds=(0, 1))
    whole.run(12)
    segs = _fleet(seeds=(0, 1))
    segs.run(12, stop_at_return=float("inf"))
    assert not any(segs.done)
    assert _same(whole._fls, segs._fls)
    assert whole.returns == segs.returns


# --------------------------------------------------------------- validation

def test_host_backend_fleet_is_rejected():
    with pytest.raises(SpecError, match="replay.backend"):
        Fleet([_small(replay_backend="host", loop="python",
                      distributed=True)], device="cpu")


def test_mesh_sharded_fleet_is_rejected():
    with pytest.raises(SpecError, match="mesh_shards"):
        Fleet([_small(mesh_shards=2, n_env=4, batch_size=16)], device="cpu")


def test_fleet_rejects_skip_policy():
    spec = _small(**{"guard.enabled": True, "guard.policy": "skip"})
    with pytest.raises(SpecError, match="skip"):
        Fleet([spec.override(seed=s) for s in (0, 1)], device="cpu")


def test_fused_fleet_member_matches_its_solo_fused_run():
    """A fleet of fused-block members (the stack's member route under the
    vmap) against each member's solo fused run: within ``SOLO_PARITY``."""
    over = dict(block_backend="fused", use_ofenet=True, ofenet_units=8,
                ofenet_layers=2, num_layers=2)
    fl = _fleet(seeds=(0, 1), **over)
    fl.run(6)
    for m in (0, 1):
        exp = Experiment.from_spec(_small(**over).override(seed=m),
                                   device="cpu")
        exp.run(6)
        solo = exp._ls
        got = member_state(fl._fls, m)
        for a, b in zip(tree_leaves(got.agent["params"]),
                        tree_leaves(solo.agent["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=SOLO_PARITY_RTOL,
                                       atol=SOLO_PARITY_ATOL)
        assert int(got.step) == int(solo.step)


def test_from_grid_over_a_fused_base_partitions_and_steps():
    """``Sweep.from_grid`` over a fused base: one fleet a width, each of
    fused members, stepped on the CPU."""
    base = _small(block_backend="fused")
    sweep = Sweep.from_grid(base, axis={"num_units": [8, 16]}, seeds=2,
                            device="cpu")
    assert [f.n_members for f in sweep.fleets] == [2, 2]
    assert all(f.spec.network.block_backend == "fused"
               for f in sweep.fleets)
    res = sweep.run(3)
    assert [r.point["num_units"] for r in res] == [8, 8, 16, 16]
    assert [r.seed for r in res] == [0, 1, 0, 1]
    assert all(len(r.result.returns) == 1 for r in res)
    for f in sweep.fleets:
        assert all(bool(torch.isfinite(t).all())
                   for t in tree_leaves(f._fls.agent["params"]))


def test_pallas_kernel_fleet_is_accepted_and_xla_raises_on_cuda(monkeypatch):
    """The reference's fleets reject replay.kernel='pallas'; the port's
    accept both values and run the same sum-tree for each (ROADMAP C12):
    on the CPU the two fleets end bitwise equal, and neither value is
    refused for a card (with none present, building for one stops only
    where it first allocates on it)."""
    fleets = [_fleet(seeds=(0, 1), replay_kernel=k)
              for k in ("pallas", "xla")]
    for fl in fleets:
        assert len(fl.run(3)[0].returns) == 1
    assert _same(fleets[0]._fls, fleets[1]._fls)
    monkeypatch.setattr(sweep_mod, "resolve_device",
                        lambda device: torch.device("cuda"))
    for kernel in ("pallas", "xla"):
        if torch.cuda.is_available():
            Fleet([_small(replay_kernel=kernel)])
            continue
        with pytest.raises(RuntimeError, match="no CUDA card") as err:
            Fleet([_small(replay_kernel=kernel)])
        assert not isinstance(err.value, NotImplementedError)


def test_shape_heterogeneous_members_are_rejected_with_paths():
    with pytest.raises(SpecError, match="network.num_units"):
        Fleet([_small(num_units=16), _small(num_units=32)], device="cpu")


def test_fleet_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Fleet([_small()])


def test_from_grid_partitions_by_compiled_shape():
    sweep = Sweep.from_grid(_small(), axis={"num_units": [16, 24]}, seeds=2,
                            device="cpu")
    assert len(sweep.fleets) == 2
    assert [len(p) for p in sweep.partition] == [2, 2]
    assert "num_units=16" in sweep.describe()
    res = sweep.run(6)
    assert len(res) == 4 and all(isinstance(r, MemberResult) for r in res)
    assert [r.point["num_units"] for r in res] == [16, 16, 24, 24]
    assert [r.seed for r in res] == [0, 1, 0, 1]
    assert all(len(r.result.returns) == 2 for r in res)


def test_from_grid_upgrades_host_spec_with_warning():
    base = _small(replay_backend="host", loop="python", distributed=True)
    with pytest.warns(SpecWarning, match="device"):
        sweep = Sweep.from_grid(base, seeds=2, device="cpu")
    assert sweep.fleets[0].spec.replay.backend == "device"


def test_sweep_save_restore_round_trips(tmp_path):
    sweep = Sweep.from_grid(_small(), axis=[{"num_units": 16}], seeds=2,
                            device="cpu")
    sweep.run(4)
    sweep.save(str(tmp_path / "sw"))
    back = Sweep.restore(str(tmp_path / "sw"), device="cpu")
    assert [r.label for r in back.results()] == \
        [r.label for r in sweep.results()]
    assert _same(back.fleets[0]._fls, sweep.fleets[0]._fls)


# -------------------------------------------------------------------- PBT

def test_exploit_explore_truncation_selection():
    fleet = _fleet(seeds=range(4))
    fleet.run(6)
    before = [clone_state(member_state(fleet._fls, m)) for m in range(4)]
    report = fleet.exploit_explore(fraction=0.25,
                                   scores=[3.0, 0.0, 2.0, 1.0])
    assert report["copied"] == {fleet.labels[1]: fleet.labels[0]}
    after1 = member_state(fleet._fls, 1)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(after1.agent), tree_leaves(before[0].agent)))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(after1.replay), tree_leaves(before[1].replay)))
    assert torch.equal(after1.gen.get_state(), before[1].gen.get_state())
    for m in (0, 2, 3):
        assert _same(member_state(fleet._fls, m), before[m])
    fleet.run(3)
    assert all(len(r) == 3 for r in fleet.returns)


def test_exploit_explore_noise_perturbs_only_losers():
    fleet = _fleet(seeds=range(4))
    fleet.run(6)
    before = [clone_state(member_state(fleet._fls, m)) for m in range(4)]
    fleet.exploit_explore(fraction=0.25, noise_scale=0.1,
                          scores=[3.0, 0.0, 2.0, 1.0])
    got = tree_leaves(member_state(fleet._fls, 1).agent["params"])
    winner = tree_leaves(before[0].agent["params"])
    assert not all(torch.equal(a, b) for a, b in zip(got, winner))
    for a, b in zip(got, winner):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0.5, atol=0.5)
    for m in (0, 2, 3):
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(member_state(fleet._fls, m).agent),
            tree_leaves(before[m].agent)))
