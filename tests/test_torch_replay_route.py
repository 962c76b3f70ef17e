"""``replay.kernel`` on the port's device replay (ROADMAP C14, C12).

The reference's field picks between its Pallas sum-tree kernels and their
XLA scatter twins. The port has one route a device: the CUDA kernels of
``csrc/replay_tree.cu`` for tensors on the card, their plain twins for
tensors on the CPU, whatever the field says. So:

* neither value is refused for a card by ``Trainer`` (here the card is
  faked at ``resolve_device``; construction then stops only where it first
  allocates on it);
* on the CPU a solo run ends bitwise equal under either value;
* the presets that ship the device replay with the default "xla"
  (``rl-distributed``, ``fleet-smoke``) build and train unchanged, and so
  does ``Sweep.from_grid`` over a host preset (its upgrade keeps "xla");
* "pallas" on the host replay stays a ``SpecError``, as in the reference.

``Fleet`` is held to the same in ``tests/test_torch_sweep.py``
(``test_pallas_kernel_fleet_is_accepted_and_xla_raises_on_cuda``). On the
card: ``chip_smoke.py``'s ``phase_figs`` (``[figs] c14`` lines) and
``test_cuda_either_kernel_is_bitwise`` here.
"""
import warnings

import pytest
import torch

from repro_torch.rl import Fleet, Sweep, presets
from repro_torch.rl import runner as runner_mod
from repro_torch.rl.experiment import (Experiment, ExperimentSpec,
                                      SpecError, SpecWarning)
from repro_torch.rl.runner import UnportedError, clone_state, state_leaves

_SMALL = dict(num_units=16, num_layers=1, use_ofenet=False, n_core=1,
              n_env=4, total_steps=12, warmup_steps=8, eval_every=3,
              eval_episodes=1, replay_capacity=256, batch_size=16,
              replay_backend="device", loop="scan")


def _small(**overrides):
    return ExperimentSpec().override(**{**_SMALL, **overrides})


def _bitwise(a, b) -> bool:
    gens = (list(zip(a.gen, b.gen)) if isinstance(a.gen, list)
            else [(a.gen, b.gen)])
    return all(torch.equal(x, y) for x, y in zip(state_leaves(a),
                                                 state_leaves(b))) \
        and all(torch.equal(g.get_state(), h.get_state()) for g, h in gens)


def _builds_for_a_card(build):
    """``build()`` is not refused for a card: with one it succeeds, without
    one it stops where it first allocates on the card."""
    if torch.cuda.is_available():
        build()
        return
    with pytest.raises(RuntimeError, match="no CUDA card") as err:
        build()
    assert not isinstance(err.value, UnportedError)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_trainer_accepts_either_kernel_for_a_card(monkeypatch, kernel):
    monkeypatch.setattr(runner_mod, "resolve_device",
                        lambda device: torch.device("cuda"))
    _builds_for_a_card(lambda: runner_mod.Trainer(
        _small(replay_kernel=kernel)))



@pytest.mark.parametrize("loop", ["python", "scan"])
def test_solo_run_is_bitwise_under_either_kernel_on_cpu(loop):
    states = []
    for kernel in ("xla", "pallas"):
        exp = Experiment.from_spec(_small(replay_kernel=kernel, loop=loop),
                                   device="cpu")
        res = exp.run(6, eval_at_end=True)
        states.append((clone_state(exp._ls), res.returns))
    assert _bitwise(states[0][0], states[1][0])
    assert states[0][1] == states[1][1]



@pytest.mark.parametrize("name", ["rl-distributed", "fleet-smoke"])
def test_shipped_device_presets_build_and_step_unchanged(name):
    spec = presets.get(name)
    assert spec.replay.backend == "device" and spec.replay.kernel == "xla"
    exp = Experiment.from_spec(spec, device="cpu")
    exp.run(1)
    assert exp.step == 1
    assert all(bool(torch.isfinite(t).all())
               for t in state_leaves(exp._ls) if t.is_floating_point())


def test_fleet_smoke_fleet_steps_unchanged():
    spec = presets.get("fleet-smoke")
    fl = Fleet([spec.override(seed=s) for s in (0, 1)], device="cpu")
    fl.run(2)
    assert fl.step == 2 and fl.spec.replay.kernel == "xla"


def test_from_grid_over_a_host_preset_runs():
    base = presets.get("smoke")
    assert base.replay.backend == "host"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SpecWarning)
        sweep = Sweep.from_grid(base, axis={"num_units": [16]}, seeds=2,
                                device="cpu", loop="scan")
    assert sweep.fleets[0].spec.replay.kernel == "xla"
    res = sweep.run(6, eval_at_end=True)
    assert [len(r.result.returns) for r in res] == [1, 1]


def test_pallas_on_the_host_replay_stays_refused():
    with pytest.raises(SpecError, match="pallas"):
        _small(replay_backend="host", replay_kernel="pallas")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_cuda_either_kernel_is_bitwise(cuda_device):
    """On the card both values run the tree kernels: one seed gives the
    same solo state and the same fleet state, bit for bit."""
    from repro_torch.kernels.replay_tree import ops
    solo, fleet = [], []
    for kernel in ("xla", "pallas"):
        ops.reset_launch_count()
        exp = Experiment.from_spec(_small(replay_kernel=kernel, loop="scan",
                                          prioritized=True),
                                   device=cuda_device)
        exp.run(6, eval_at_end=True)
        fl = Fleet([_small(replay_kernel=kernel, seed=s) for s in (0, 1)],
                   device=cuda_device)
        fl.run(6, eval_at_end=True)
        torch.cuda.synchronize()
        assert ops.launch_count("sample") > 0
        solo.append(clone_state(exp._ls))
        fleet.append(clone_state(fl._fls))
    assert _bitwise(*solo) and _bitwise(*fleet)
