"""The readers of the superstep's phases and of the host replay's waits,
on synthetic contexts: each reads its number from the system's phase
stamps (``bench.phases``, one read a run) or from the host capture's
spans, and reports nothing where those are absent: on the CPU, from a
system without stamps, or without the spans."""
from types import SimpleNamespace

import pytest
import torch

from bench import phases, registry

TABLE = {"collect": 0.21, "replay": 0.07, "update": 3.4, "adamw": 0.71,
         "copyback": 0.19, "step_gap": 0.05, "supersteps": 200,
         "lead_ms": [1.0, 2.0], "clock_uncertainty_ms": 0.004}
READS = {"collect_ms": "collect", "collect_ms.host_replay": "collect",
         "replay_device_ms": "replay", "update_ms": "update",
         "adamw_ms": "adamw", "copyback_ms": "copyback",
         "step_gap_ms": "step_gap"}
WAITS = ("repro_torch.replay.wait_rows", "repro_torch.replay.wait_prio")


class _System:
    """An ``Experiment`` or ``Fleet`` as ``bench.phases`` drives it."""

    def __init__(self, table=TABLE):
        self.table, self.calls = table, []

    def trace_phases(self):
        self.calls.append("trace_phases")

    def phases(self, n):
        self.calls.append(("phases", n))
        return self.table


def _ctx(system, kind="exp", device="cuda", call_steps=100, spans=(),
         supersteps=20):
    runs = []
    drv = SimpleNamespace(device=torch.device(device), run=runs.append,
                          **{kind: system})
    return SimpleNamespace(
        driver=drv, cell={"call_steps": call_steps}, runs=runs,
        host_profile={"spans": list(spans), "supersteps": supersteps})


@pytest.mark.parametrize("kind", ["exp", "fleet"])
@pytest.mark.parametrize("metric", sorted(READS))
def test_each_phase_reader_reads_its_phase(metric, kind):
    system = _System()
    ctx = _ctx(system, kind, call_steps=150)
    assert registry.reader("layer_metrics", metric).read(ctx) == \
        TABLE[READS[metric]]
    assert system.calls == ["trace_phases", ("phases", 300)]
    assert ctx.runs == [150, 150, 150]


def test_the_phases_are_read_once_a_run():
    system = _System()
    ctx = _ctx(system)
    got = [registry.reader("layer_metrics", m).read(ctx) for m in READS]
    assert got == [TABLE[READS[m]] for m in READS]
    assert system.calls.count("trace_phases") == 1
    assert len(ctx.runs) == 3 and phases.table(ctx) is TABLE


@pytest.mark.parametrize("case", ["cpu", "no_stamps", "nothing_read"])
def test_the_phase_readers_report_nothing_without_stamps(case):
    if case == "cpu":
        ctx = _ctx(_System(), device="cpu")
    elif case == "no_stamps":              # a system older than the stamps
        ctx = _ctx(SimpleNamespace(run=lambda n: None))
    else:
        ctx = _ctx(_System(table=None))
    for metric in READS:
        assert registry.reader("layer_metrics", metric).read(ctx) is None
    if case != "nothing_read":
        assert ctx.runs == []


def test_host_wait_reads_the_two_waits_a_superstep():
    spans = [("repro.chunk_dispatch", 0.0, 100_000.0),
             (WAITS[0], 10.0, 2_010.0), (WAITS[1], 3_000.0, 4_500.0),
             (WAITS[0], 6_000.0, 8_000.0), (WAITS[1], 9_000.0, 10_500.0),
             ("repro.replay.host_add", 2_100.0, 2_500.0)]
    ctx = _ctx(None, spans=spans, supersteps=2)
    mod = registry.reader("layer_metrics", "host_wait_ms.host_replay")
    assert mod.read(ctx) == pytest.approx((2000 + 1500 + 2000 + 1500)
                                          / 1e3 / 2)
    assert mod.read(_ctx(None, spans=spans[:1] + spans[-1:])) is None


def test_dispatch_keeps_the_waits_in_its_self_time():
    """The waits are ``repro_torch.*`` spans: ``dispatch_ms`` subtracts
    the nested ``repro.*`` spans only, so it reads the waits as before."""
    spans = [("repro.chunk_dispatch", 0.0, 10_000.0),
             (WAITS[0], 1_000.0, 3_000.0),
             ("repro.replay.host_add", 3_000.0, 3_500.0),
             (WAITS[1], 5_000.0, 6_000.0)]
    ctx = _ctx(None, spans=spans, supersteps=1)
    mod = registry.reader("layer_metrics", "dispatch_ms.host_replay")
    assert mod.read(ctx) == pytest.approx(9.5)
