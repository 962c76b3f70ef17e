"""The port's figure drivers (``repro_torch.figures``) against the
reference's (``benchmarks/``, ``examples/``), on the CPU.

* What each driver would run: for every driver and both scales, the rows
  (name, ``spec.to_dict()``, seeds, fleet or solo) and the rows' extra
  fields are the reference driver's. They are captured by replacing
  ``bench_run``, ``fleet_rows`` and ``Sweep`` (and, for the examples and
  the landscape, ``Experiment``) in each package's driver namespace, so
  nothing trains and no file of the reference changes.
* One tiny run a kind on ``device="cpu"`` with the budget cut by
  ``common.cut_budget`` (as ``chip_smoke.py``'s ``phase_figs`` cuts it on
  the card): a fleet driver (fig3), a solo driver (fig5) and
  ``loss_landscape_bench``; each row has the reference's fields (those of
  ``benchmarks.common.bench_run`` and ``fleet_rows`` over stand-in
  results).
* ``run.py`` merges its rows into ``experiments/torch_bench_results.json``
  under the working directory, stamped with a host fingerprint.
"""
import importlib
import importlib.util
import itertools
import json
import os
import types
from collections.abc import Mapping

import numpy as np
import pytest

import repro.core.loss_landscape as jll
import repro.rl
import repro.rl.sac
from repro_torch.figures import common
from repro_torch.rl.experiment import ExperimentSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_DRIVERS = ["fig1_depth", "fig3_width", "fig4_grid"]
SOLO_DRIVERS = ["fig5_connectivity", "fig6_ofenet", "fig8_distributed",
                "fig10_ablation", "fig13_activation", "table1_final"]
CUT = dict(total_steps=8, warmup_steps=8, eval_every=4, eval_episodes=1)


def _points(axis):
    if isinstance(axis, Mapping):
        keys = list(axis)
        return [dict(zip(keys, v))
                for v in itertools.product(*(axis[k] for k in keys))]
    return [dict(p) for p in axis]


def _result(**kw):
    return types.SimpleNamespace(max_return=-1.0, final_return=-2.0,
                                 param_count=3, sranks=[4], **kw)


class _Recorder:
    """Stand-ins for ``bench_run``, ``fleet_rows``, ``Sweep`` and
    ``Experiment`` that record what a driver asks for."""

    def __init__(self):
        self.calls = []
        rec = self

        class Sweep:
            def __init__(self, base, points, seeds):
                self.base, self.points, self.seeds = base, points, seeds

            @classmethod
            def from_grid(cls, base, axis=None, seeds=1, **kw):
                pts = _points(axis)
                for p in pts:
                    rec.calls.append(("fleet", p, base.override(**p)
                                      .to_dict(), seeds))
                return cls(base, pts, seeds)

            def describe(self):
                return ""

            def run(self, *a, **kw):
                return [types.SimpleNamespace(seed=s, result=_result())
                        for _ in self.points for s in range(self.seeds)]

        class Experiment:
            @staticmethod
            def from_spec(spec, **kw):
                rec.calls.append(("solo", None, spec.to_dict(), 1))
                return types.SimpleNamespace(step=0, _ls=None,
                                             run=lambda *a, **k: _result(
                    state={"params": {"critics": None,
                                      "target_critics": None}},
                    last_batch={k: np.zeros(4, np.float32) for k in (
                        "obs", "act", "rew", "next_obs", "done")}))

        self.Sweep, self.Experiment = Sweep, Experiment

    def bench_run(self, name, spec, extra=None, seeds=1, **kw):
        self.calls.append(("solo", name, spec.to_dict(), seeds))
        return {"name": name, **(extra or {})}

    def fleet_rows(self, sweep, name_fn, extra_fn=None):
        rows = []
        for p in sweep.points:
            rows.append({"name": name_fn(p), "fleet": True,
                         **(extra_fn(p) if extra_fn else {})})
        return rows


def _ref_module(name):
    if name in ("width_study", "rl_distributed"):
        spec = importlib.util.spec_from_file_location(
            f"_ref_example_{name}", os.path.join(ROOT, "examples",
                                                 f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return importlib.import_module(f"benchmarks.{name}")


def _capture(monkeypatch, pkg, name, call):
    """``call(module)`` with the stand-ins in place: ``(calls, out)``."""
    rec = _Recorder()
    with monkeypatch.context() as m:
        if pkg == "ref":
            mod = _ref_module(name)
            m.setattr(repro.rl, "Sweep", rec.Sweep)
            m.setattr(repro.rl, "Experiment", rec.Experiment)
            m.setattr(repro.rl.sac, "q_values",
                      lambda *a, **k: (np.zeros(4), np.zeros(4), None))
            m.setattr(jll, "loss_surface",
                      lambda *a, **k: (None, None, np.ones((9, 9))))
        else:
            mod = importlib.import_module(f"repro_torch.figures.{name}")
            m.setattr(common, "bench_run", rec.bench_run)
            m.setattr(common, "fleet_rows", rec.fleet_rows)
            if name == "loss_landscape_bench":
                m.setattr(mod, "surface",
                          lambda *a, **k: (None, None, np.ones((9, 9))))
        for attr in ("bench_run", "fleet_rows", "Sweep", "Experiment"):
            if hasattr(mod, attr):
                m.setattr(mod, attr, getattr(rec, attr))
        out = call(mod, pkg)
    return rec.calls, out


def _same_runs(monkeypatch, name, call):
    ref = _capture(monkeypatch, "ref", name, call)
    port = _capture(monkeypatch, "port", name, call)
    assert port[0] == ref[0]
    assert ref[0], "the driver ran nothing"
    return ref[1], port[1]


def _run(scale, **kw):
    def call(mod, pkg):
        return mod.run(scale, **kw, **({"device": "cpu"}
                                       if pkg == "port" else {}))
    return call


@pytest.mark.parametrize("scale", ["quick", "paper"])
@pytest.mark.parametrize("name", SOLO_DRIVERS)
def test_solo_driver_runs_the_reference_rows(monkeypatch, name, scale):
    ref, port = _same_runs(monkeypatch, name, _run(scale))
    assert port == ref


@pytest.mark.parametrize("sequential", [False, True])
@pytest.mark.parametrize("scale", ["quick", "paper"])
@pytest.mark.parametrize("name", FLEET_DRIVERS)
def test_fleet_driver_runs_the_reference_rows(monkeypatch, name, scale,
                                              sequential):
    ref, port = _same_runs(monkeypatch, name,
                           _run(scale, sequential=sequential))
    assert port == ref


@pytest.mark.parametrize("scale", ["quick", "paper"])
def test_loss_landscape_bench_trains_the_reference_agents(monkeypatch,
                                                          scale):
    ref, port = _same_runs(monkeypatch, "loss_landscape_bench", _run(scale))
    assert port == ref


def test_presets_smoke_builds_the_reference_presets(monkeypatch):
    ref, port = _same_runs(monkeypatch, "presets_smoke", _run("quick"))
    strip = lambda rows: [{k: v for k, v in r.items() if k != "us_per_call"}
                          for r in rows]
    assert strip(port) == strip(ref)


@pytest.mark.parametrize("argv", [
    [], ["--steps", "24", "--seeds", "2", "--override",
         "execution.warmup_steps=8"]])
def test_width_study_runs_the_reference_grid(monkeypatch, argv):
    def call(mod, pkg):
        if pkg == "port":
            return mod.main(argv + ["--device", "cpu"])
        return _ref_main(monkeypatch, mod, argv)
    _same_runs(monkeypatch, "width_study", call)


@pytest.mark.parametrize("argv", [
    [], ["--steps", "40", "--env", "cartpole_swingup", "--override",
         "replay.n_step=3"]])
def test_rl_distributed_runs_the_reference_variants(monkeypatch, argv):
    def call(mod, pkg):
        if pkg == "port":
            return mod.main(argv + ["--device", "cpu"])
        return _ref_main(monkeypatch, mod, argv)
    _same_runs(monkeypatch, "rl_distributed", call)


def _ref_main(monkeypatch, mod, argv):
    """An example's ``main()``, which reads ``sys.argv``."""
    monkeypatch.setattr("sys.argv", [mod.__file__] + argv)
    return mod.main()


# ------------------------------------------------- tiny runs on the CPU

def _ref_row_keys():
    """The keys of the reference's ``bench_run`` and ``fleet_rows`` rows
    (no extras), over stand-in results."""
    import benchmarks.common as bc
    spec = bc.make_spec("quick", "smoke")
    solo = types.SimpleNamespace(
        from_spec=lambda s: types.SimpleNamespace(run=lambda **k: _result()))
    orig = bc.Experiment
    bc.Experiment = solo
    try:
        row = bc.bench_run("x", spec)
    finally:
        bc.Experiment = orig
    fl = types.SimpleNamespace(results=lambda: [_result()], points=[{}],
                               _wall=1.0, step=1, n_members=1)
    frow = bc.fleet_rows(types.SimpleNamespace(fleets=[fl]), lambda p: "x")[0]
    return set(row), set(frow)


def test_fig3_fleet_rows_at_a_cut_budget_on_cpu():
    from repro_torch.figures import fig3_width
    _, fleet_keys = _ref_row_keys()
    with common.cut_budget(**CUT):
        rows = fig3_width.run("quick", device="cpu")
    assert [r["name"] for r in rows] == ["fig3_width_U16", "fig3_width_U64",
                                         "fig3_width_U256"]
    for r in rows:
        assert set(r) == fleet_keys | {"units"}
        assert np.isfinite(r["derived"]) and r["seeds"] == 1 and r["fleet"]
        assert r["us_per_call"] > 0


def test_fig5_solo_rows_at_a_cut_budget_on_cpu():
    from repro_torch.figures import fig5_connectivity
    solo_keys, _ = _ref_row_keys()
    with common.cut_budget(**CUT):
        rows = fig5_connectivity.run("quick", device="cpu")
    assert [r["name"] for r in rows] == [
        f"fig5_{c}_{t}" for t in ("S", "L")
        for c in ("mlp", "resnet", "densenet", "d2rl")]
    for r in rows:
        assert set(r) == solo_keys | {"connectivity", "size"}
        assert np.isfinite(r["derived"]) and r["params"] > 0


def test_loss_landscape_bench_at_a_cut_budget_on_cpu():
    from repro_torch.figures import loss_landscape_bench
    with common.cut_budget(**CUT):
        rows = loss_landscape_bench.run("quick", device="cpu")
    assert [r["name"] for r in rows] == ["landscape_deep", "landscape_wide"]
    for r in rows:
        assert set(r) == {"name", "us_per_call", "derived", "loss_range",
                          "return"}
        assert r["derived"].startswith("sharpness=")
        assert np.isfinite(float(r["derived"].split("=")[1]))
        assert r["loss_range"] >= 0 and np.isfinite(r["return"])


def test_cut_budget_applies_last_and_restores():
    full = common.make_spec
    with common.cut_budget(total_steps=8, num_units=24):
        spec = common.make_spec("paper", "fig3-width", num_units=512)
        assert spec.execution.total_steps == 8
        assert spec.network.num_units == 24
        assert spec.execution.batch_size == common.PAPER["batch_size"]
    assert common.make_spec is full
    assert common.make_spec("paper", "fig3-width").execution.total_steps \
        == common.PAPER["total_steps"]


def test_drivers_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    import torch
    from repro_torch.figures import fig13_activation
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fig13_activation.run("quick")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        common.bench_run("x", ExperimentSpec())


def test_driver_cli_passes_scale_device_and_sequential(capsys):
    seen = []

    def fake(scale, device=None, **kw):
        seen.append((scale, device, kw))
        return [{"name": "r", "us_per_call": 1.5, "derived": 2}]
    common.main(fake, ["--scale", "paper", "--device", "cpu",
                       "--sequential"], fleet=True)
    common.main(fake, ["--device", "cpu"])
    assert seen == [("paper", "cpu", {"sequential": True}),
                    ("quick", "cpu", {})]
    assert capsys.readouterr().out == "r,2,2\nr,2,2\n"


def test_run_merges_rows_into_the_port_results(tmp_path, monkeypatch,
                                               capsys):
    from repro_torch.figures import run
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "experiments" / "torch_bench_results.json"
    out.parent.mkdir()
    out.write_text(json.dumps([{"name": "kept", "us_per_call": 1},
                               {"name": "preset_build_smoke", "old": 1}]))
    run.main(["--only", "presets_smoke", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert any(l.startswith("preset_build_rl-distributed,") for l in lines)
    rows = json.loads(out.read_text())
    names = [r["name"] for r in rows]
    assert names[0] == "kept" and names.count("preset_build_smoke") == 1
    new = [r for r in rows if r["name"] != "kept"]
    assert all("old" not in r for r in new)
    for r in new:
        host = r["host"]
        assert {"torch", "cuda", "device", "python", "cpus"} <= set(host)
        assert host["device"] == "cpu" and "card" not in host
        assert r["recorded_at"]
    assert not (tmp_path / "experiments" / "bench_results.json").exists()


def test_run_lists_only_the_port_drivers():
    from repro_torch.figures import run
    assert all(m.startswith("repro_torch.") for m in run.MODULES)
    ref = importlib.import_module("benchmarks.run")
    ported = {m.rsplit(".", 1)[1] for m in run.MODULES}
    assert ported == {m.rsplit(".", 1)[1] for m in ref.MODULES} - {
        "replay_micro", "dense_stack", "loop_fusion", "sweep_fleet",
        "serve_policy"}
