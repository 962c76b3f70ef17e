"""The superstep's phase stamps (``repro_torch.obs.trace``) on the CPU.

* ``stamp`` is a no-op outside a stamped capture, and on the CPU, where
  no capture runs; inside one (the capture faked) it hands each phase to
  the active ring in order: ``adamw_update`` opens ``adamw`` and returns
  to ``update`` (its foreach and its vmapped route), and a device-replay
  superstep stamps the add, the update, each AdamW call and the refresh
  in that order.
* ``Experiment.trace_phases`` / ``Fleet.trace_phases`` drop a graph
  captured without stamps; ``obs.trace = N`` stamps from the
  start; a CPU run with ``trace_phases()`` called is bitwise the run
  without, and ``phases`` reads None there.
* ``phase_table`` on synthetic rings: the phases partition the
  superstep, a phase's intervals are summed, the ring wraps, a fleet's
  int64 counter picks its rows, ``lead_ms`` follows from a given clock
  offset, and rows not stamped in order are refused.
* The checkpoint spans: a save opens ``repro.ckpt.save`` once, and no
  duplicate span around it.
* On a CUDA card (skipped without one): stamps on and off leave a
  device-replay run, a host-replay run and a 2-member fleet bitwise equal
  over 20 supersteps; a graph captured without stamps after one with them
  has the kernels of one captured before, and the stamped graph exactly
  its stamps more; ``phases`` reads positive phases that sum to the wall
  time a replay, from a ring of two of the longest chunks' rows.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.obs import trace
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.rl import Fleet
from repro_torch.rl.experiment import Experiment, ExperimentSpec
from repro_torch.rl.runner import Trainer, state_leaves

_SMALL = dict(num_units=16, num_layers=1, use_ofenet=False, n_core=1,
              n_env=4, total_steps=6, warmup_steps=8, eval_every=3,
              eval_episodes=1, replay_capacity=256, batch_size=16,
              replay_backend="device", loop="scan")

# a device-replay SAC superstep without OFENet, as StepGraph captures it
_DEVICE = ("collect", "replay", "update", "adamw", "update", "adamw",
           "update", "adamw", "update", "replay", "copyback", "gap")
# a host-replay superstep: segment A, then B
_HOST = ("collect", "gap", "update", "adamw", "update", "adamw", "update",
         "adamw", "update", "copyback", "gap")


def _small(**overrides):
    return ExperimentSpec().override(**{**_SMALL, **overrides})


class _Ring:
    """Records the phases ``stamp`` hands it."""

    def __init__(self):
        self.schedule = []

    def stamp(self, phase):
        self.schedule.append(phase)


@pytest.fixture
def capturing(monkeypatch):
    """A capture in progress, as ``stamp`` sees it."""
    monkeypatch.setattr(trace, "_capture_in_progress", lambda: True)


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(state_leaves(a), state_leaves(b)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stamps are CUDA kernels in a "
                    "captured graph")
    return torch.device("cuda")


# ------------------------------------------------------------------ stamp

def test_stamp_is_a_no_op_outside_a_stamped_capture_and_on_the_cpu():
    ring = _Ring()
    trace.stamp("collect")                      # no ring
    with trace.stamping(ring):                  # no capture on the CPU
        trace.stamp("collect")
    assert ring.schedule == [] and trace._ACTIVE is None
    assert not trace._capture_in_progress()


def test_stamp_hands_each_phase_to_the_active_ring(capturing):
    outer, inner = _Ring(), _Ring()
    trace.stamp("collect")
    with trace.stamping(outer):
        trace.stamp("collect")
        with trace.stamping(None):              # a capture without stamps
            trace.stamp("replay")
        with trace.stamping(inner):
            trace.stamp("update")
        trace.stamp("gap")
    assert outer.schedule == ["collect", "gap"]
    assert inner.schedule == ["update"] and trace._ACTIVE is None


def test_phase_stamps_need_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        trace.PhaseStamps(torch.zeros((), dtype=torch.int32), 4)


@pytest.mark.parametrize("members", [0, 3])
def test_adamw_update_is_the_adamw_phase_inside_update(capturing, members):
    gen = torch.Generator().manual_seed(0)
    lead = (members,) if members else ()
    params = {"w": torch.randn(lead + (4, 3), generator=gen),
              "b": torch.randn(lead + (3,), generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen)
             for k, v in params.items()}
    cfg = AdamWConfig(lr=1e-3)
    ring = _Ring()
    with trace.stamping(ring):
        if members:
            state = torch.func.vmap(adamw_init)(params)
            torch.func.vmap(lambda g, s, p: adamw_update(cfg, g, s, p))(
                grads, state, params)
        else:
            adamw_update(cfg, grads, adamw_init(params), params)
    assert ring.schedule == ["adamw", "update"]


def test_a_superstep_stamps_its_phases_in_order(capturing):
    tr = Trainer(_small(), "cpu")
    ls = tr.init()
    ring = _Ring()
    with trace.stamping(ring):
        tr.step(ls)
    # StepGraph adds the first ("collect") and the last two around it
    assert ring.schedule == list(_DEVICE[1:-2])


# ---------------------------------------------------- trace_phases, phases

@pytest.mark.parametrize("backend", ["device", "host"])
def test_trace_phases_leaves_a_cpu_run_bitwise(backend):
    spec = _small(replay_backend=backend)
    plain, stamped = Experiment.from_spec(spec, device="cpu"), \
        Experiment.from_spec(spec, device="cpu")
    stamped.trace_phases()
    assert stamped.trainer.stamp_phases and not plain.trainer.stamp_phases
    plain.run(5)
    stamped.run(5)
    assert _bitwise(plain._ls, stamped._ls)
    assert torch.equal(plain._ls.gen.get_state(),
                       stamped._ls.gen.get_state())
    assert plain.returns == stamped.returns
    assert stamped.phases(4) is None


def test_fleet_trace_phases_leaves_a_cpu_run_bitwise():
    specs = [_small(seed=s) for s in (0, 1)]
    plain, stamped = Fleet(specs, device="cpu"), Fleet(specs, device="cpu")
    stamped.trace_phases()
    plain.run(4)
    stamped.run(4)
    assert _bitwise(plain._fls, stamped._fls)
    assert stamped.phases(3) is None


def test_trace_phases_drops_a_graph_without_stamps():
    exp = Experiment.from_spec(_small(), device="cpu")
    fleet = Fleet([_small(seed=s) for s in (0, 1)], device="cpu")
    graph = object()
    for holder, system in ((exp.trainer, exp), (fleet, fleet)):
        holder.graph = graph
        system.trace_phases()
        assert holder.graph is None and system.trainer.stamp_phases
        holder.graph = graph
        system.trace_phases()                  # already on: kept
        assert holder.graph is graph


def test_obs_trace_stamps_from_the_first_chunk(tmp_path):
    on = {"obs.enabled": True, "obs.sinks": ["jsonl"],
          "obs.log_dir": str(tmp_path)}
    assert Trainer(_small(**on, **{"obs.trace": 1}), "cpu").stamp_phases
    assert not Trainer(_small(**on), "cpu").stamp_phases
    assert not Trainer(_small(), "cpu").stamp_phases


def test_the_trainers_longest_chunk_bounds_the_stream_and_the_ring():
    on = {"obs.enabled": True, "obs.sinks": [], "obs.log_dir": ""}
    assert Trainer(_small(eval_every=40), "cpu").chunk_steps == 40
    tr = Trainer(_small(eval_every=40, **on,
                        **{"eval.srank_every": 15}), "cpu")
    assert tr.chunk_steps == tr.stream_rows == 15
    assert Trainer(_small(eval_every=40), "cpu").stream_rows == 0


# ------------------------------------------------------------ phase_table

def _rows(schedule, widths_ns, n, period_ns, start_ns=10**12):
    """``n`` rows whose slot k lasts ``widths_ns[k]`` (the last slot's
    width is unused), one row every ``period_ns``."""
    offsets = np.concatenate([[0], np.cumsum(widths_ns[:-1])])
    assert len(offsets) == len(schedule)
    return start_ns + np.arange(n)[:, None] * period_ns + offsets[None, :]


def test_the_phases_partition_the_superstep():
    widths = [200_000, 30_000, 900_000, 150_000, 700_000, 160_000,
              800_000, 10_000, 300_000, 40_000, 190_000, 0]
    period = 5_000_000
    got = trace.phase_table(_rows(_DEVICE, widths, 8, period), _DEVICE)
    ms = lambda *k: sum(widths[i] for i in k) / 1e6
    assert got["collect"] == pytest.approx(ms(0))
    assert got["replay"] == pytest.approx(ms(1, 9))        # two intervals
    assert got["update"] == pytest.approx(ms(2, 4, 6, 8))
    assert got["adamw"] == pytest.approx(ms(3, 5, 7))
    assert got["copyback"] == pytest.approx(ms(10))
    assert got["step_gap"] == pytest.approx(
        (period - sum(widths[:-1])) / 1e6)
    phases = [got[k] for k in ("collect", "replay", "update", "adamw",
                               "copyback", "step_gap")]
    assert sum(phases) == pytest.approx(period / 1e6)
    assert got["supersteps"] == 8


def test_the_host_replays_gap_between_its_graphs_is_step_gap():
    widths = [250_000, 1_500_000, 800_000, 100_000, 900_000, 100_000,
              950_000, 10_000, 300_000, 200_000, 0]
    period = 7_000_000
    got = trace.phase_table(_rows(_HOST, widths, 5, period), _HOST)
    assert got["collect"] == pytest.approx(0.25)
    assert got["replay"] == 0.0
    assert got["copyback"] == pytest.approx(0.2)
    assert got["step_gap"] == pytest.approx(
        (1_500_000 + period - sum(widths[:-1])) / 1e6)


def test_the_step_gap_varies_row_to_row():
    sched = ("collect", "update", "gap")
    rows = np.array([[100, 200, 300], [1000, 1100, 1300], [1500, 1600, 1700]])
    got = trace.phase_table(rows * 1000, sched)
    assert got["collect"] == pytest.approx(0.1)
    assert got["update"] == pytest.approx((100 + 200 + 100) / 3 / 1000)
    assert got["step_gap"] == pytest.approx((700 + 200) / 2 / 1000)


@pytest.mark.parametrize("now", [3, 512 * 7 + 3, 2**40 + 3])
def test_the_ring_wraps_to_the_last_rows_in_order(now):
    """A solo run's int32 step or a fleet's int64 clock: the last n rows
    end at row ``now - 1`` mod rows."""
    ring = np.zeros((512, 4), np.int64)
    for k in range(6):                       # supersteps now-6 .. now-1
        ring[(now - 6 + k) % 512] = 10**9 + k * 1000 + np.arange(4) * 10
    rows = trace.ring_rows(ring, now, 6)
    assert (rows[:, 0] == 10**9 + np.arange(6) * 1000).all()
    got = trace.phase_table(rows, ("collect", "replay", "copyback", "gap"))
    assert got["collect"] == pytest.approx(1e-5)
    assert got["step_gap"] == pytest.approx((1000 - 30) / 1e6)


def test_lead_from_a_given_clock_offset():
    sched = ("collect", "gap")
    launched = np.array([0, 4_000_000, 8_000_000]) + 5 * 10**9
    offset = 123_456_789_000                  # card minus host
    lead = np.array([2_000_000, 1_500_000, 3_000_000])
    card = launched + offset + lead
    rows = np.stack([card, card + 100_000], 1)
    got = trace.phase_table(rows, sched, launched.tolist(), offset, 7_500)
    assert got["lead_ms"] == pytest.approx([2.0, 1.5, 3.0])
    assert got["clock_uncertainty_ms"] == pytest.approx(0.0075)
    assert "lead_ms" not in trace.phase_table(rows, sched)


@pytest.mark.parametrize("case", ["unstamped", "out_of_order", "one_row",
                                  "no_gap_last"])
def test_rows_not_stamped_in_order_are_refused(case):
    sched = ["collect", "update", "gap"]
    rows = _rows(sched, [100, 200, 0], 4, 1000)
    if case == "unstamped":
        rows[2] = 0
    elif case == "out_of_order":
        rows[1, 1] = rows[1, 0] - 5
    elif case == "one_row":
        rows = rows[:1]
    else:
        sched[-1] = "copyback"
    with pytest.raises(ValueError):
        trace.phase_table(rows, sched)


# ------------------------------------------------------- checkpoint spans

def test_a_save_opens_one_checkpoint_span(tmp_path):
    exp = Experiment.from_spec(_small(), device="cpu")
    exp.run(3)
    fleet = Fleet([_small(seed=s) for s in (0, 1)], device="cpu")
    fleet.run(3)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exp.save(str(tmp_path / "solo.npz"))
        fleet.save(str(tmp_path / "fleet.npz"))
    names = [e.name for e in prof.events() if e.name.startswith("repro")]
    assert names.count("repro.ckpt.save") == 2
    assert not {"repro.ckpt_save", "repro.fleet_ckpt_save"} & set(names)


# ------------------------------------------------------------- on the card

_CARD = dict(eval_every=40, total_steps=40)


def _graph_kernels(graph, reps=5):
    """Kernels a replay of ``graph`` (a ``StepGraph``), by a profiler
    count, and those of them that are stamps."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay(reps)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.count > 0 and "Memcpy" not in e.key
          and "Memset" not in e.key]
    total = sum(e.count for e in ev)
    stamps = sum(e.count for e in ev if "phase_stamp" in e.key)
    assert total % reps == 0 and stamps % reps == 0
    return total // reps, stamps // reps


def _same_run(a, b):
    """Two runs' states and generators are bitwise equal."""
    gens = lambda ls: ls.gen if isinstance(ls.gen, list) else [ls.gen]
    return _bitwise(a, b) and all(
        torch.equal(x.get_state(), y.get_state())
        for x, y in zip(gens(a), gens(b)))


@pytest.mark.parametrize("backend", ["device", "host"])
def test_cuda_stamps_leave_training_bitwise_and_add_only_their_kernels(
        cuda_device, backend):
    spec = _small(replay_backend=backend, **_CARD)
    before = Experiment.from_spec(spec, device=cuda_device)
    before.run(2)                       # captured before any stamps
    stamped = Experiment.from_spec(spec, device=cuda_device)
    stamped.trace_phases()
    stamped.run(20)
    after = Experiment.from_spec(spec, device=cuda_device)
    after.run(20)
    assert _same_run(after._ls, stamped._ls)
    assert after.returns == stamped.returns
    k_before, s_before = _graph_kernels(before.trainer.graph)
    k_after, s_after = _graph_kernels(after.trainer.graph)
    k_stamped, s_stamped = _graph_kernels(stamped.trainer.graph)
    stamps = stamped.trainer.graph.stamps
    assert s_before == s_after == 0 and k_after == k_before
    assert s_stamped == len(stamps.schedule)
    assert k_stamped == k_before + s_stamped
    assert before.trainer.graph.stamps is None
    assert after.trainer.graph.stamps is None


@pytest.mark.parametrize("backend", ["device", "host"])
def test_cuda_phases_sum_to_the_wall_time_a_replay(cuda_device, backend):
    exp = Experiment.from_spec(_small(replay_backend=backend, **_CARD),
                               device=cuda_device)
    exp.trace_phases()
    exp.run(4)
    graph, n = exp.trainer.graph, 30
    assert graph.stamps.ring.shape[0] == 2 * exp.trainer.chunk_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.replay(n)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    got = exp.phases(n)
    assert got["supersteps"] == n and len(got["lead_ms"]) == n
    names = ["collect", "update", "adamw", "copyback", "step_gap"] + \
        (["replay"] if backend == "device" else [])
    assert all(got[k] > 0 for k in names), got
    total = sum(got[k] for k in ("collect", "replay", "update", "adamw",
                                 "copyback", "step_gap"))
    assert total == pytest.approx(wall_ms, rel=0.1)
    # each superstep begins on the card after the host launched it
    assert min(got["lead_ms"]) > -got["clock_uncertainty_ms"]
    # past the ring's end it wraps; asked for more, it reads all it holds
    rows = graph.stamps.ring.shape[0]
    graph.replay(rows + 7)
    wrapped = exp.phases(10 * rows)
    assert wrapped["supersteps"] == rows
    assert all(wrapped[k] > 0 for k in names), wrapped


def test_cuda_fleet_stamps_leave_training_bitwise(cuda_device):
    specs = [_small(seed=s, **_CARD) for s in (0, 1)]
    plain = Fleet(specs, device=cuda_device)
    stamped = Fleet(specs, device=cuda_device)
    stamped.trace_phases()
    plain.run(20)
    stamped.run(20)
    assert _same_run(plain._fls, stamped._fls)
    got = stamped.phases(16)
    assert got["supersteps"] == 16
    assert all(got[k] > 0 for k in ("collect", "replay", "update",
                                    "adamw", "copyback", "step_gap"))
    assert plain.phases(16) is None
