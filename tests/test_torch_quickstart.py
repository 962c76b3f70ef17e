"""The port's quickstart (``python -m repro_torch.launch.quickstart``)
against ``examples/quickstart.py``.

* For the same arguments both build the same spec (``to_dict``): each
  script's ``Experiment`` is replaced by a stand-in that records the spec
  and stops.
* A tiny CPU run with ``--serve`` prints "match" (the served actions are
  the direct ``act_deterministic`` ones); ``--ckpt`` then ``--resume``
  continues from the saved step; ``--log-dir`` writes ``metrics.jsonl``,
  which ``repro_torch.obs.report`` reads; the ``--resume`` and
  ``--trace`` conflicts are the reference's.
"""
import importlib.util
import os

import pytest

from repro_torch.launch import quickstart
from repro_torch.obs import report as obs_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--units", "16", "--override", "warmup_steps=64",
        "--override", "batch_size=32", "--override", "eval_episodes=1",
        "--override", "ofenet_units=8", "--device", "cpu"]


class _Stop(Exception):
    pass


class _Recorder:
    specs = []

    @classmethod
    def from_spec(cls, spec, **kw):
        cls.specs.append(spec.to_dict())
        raise _Stop


def _reference_module():
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", os.path.join(ROOT, "examples",
                                             "quickstart.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    [],
    ["--steps", "40", "--units", "32", "--override", "replay.backend=device",
     "--override", "execution.mesh_shards=4"],
    ["--steps", "160", "--log-dir", "runs/x", "--trace", "2", "--guard",
     "skip", "--override", "network.num_layers=3"]],
    ids=["defaults", "device-mesh", "obs-guard"])
def test_spec_is_the_reference_quickstarts(monkeypatch, argv):
    ref = _reference_module()
    _Recorder.specs = []
    monkeypatch.setattr(ref, "Experiment", _Recorder)
    monkeypatch.setattr(quickstart, "Experiment", _Recorder)
    monkeypatch.setattr("sys.argv", ["quickstart.py"] + argv)
    with pytest.raises(_Stop):
        ref.main()
    with pytest.raises(_Stop):
        quickstart.main(argv + ["--device", "cpu"])
    want, got = _Recorder.specs
    assert got == want


def test_serve_resume_and_telemetry_on_cpu(tmp_path, capsys):
    ckpt, logs = str(tmp_path / "q.npz"), str(tmp_path / "runs")
    assert quickstart.main(["--steps", "8", "--serve", "--ckpt", ckpt,
                            "--log-dir", logs] + TINY) == 0
    out = capsys.readouterr().out
    assert "match direct policy call" in out and "MISMATCH" not in out
    assert "effective-rank trace" in out and os.path.exists(ckpt)
    assert os.path.exists(os.path.join(logs, "metrics.jsonl"))
    assert obs_report.main([logs]) == 0
    summary = capsys.readouterr().out
    assert "steps" in summary or "train" in summary
    rows = obs_report.load_rows(logs)
    assert {r["kind"] for r in rows} >= {"train", "eval", "event"}
    assert quickstart.main(["--steps", "8", "--resume", ckpt,
                            "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resumed at step 8" in out and "step     16" in out


def test_flag_conflicts_are_the_references(capsys):
    for argv in (["--resume", "x.npz", "--units", "8"],
                 ["--resume", "x.npz", "--guard", "halt"],
                 ["--trace", "1"]):
        with pytest.raises(SystemExit) as err:
            quickstart.main(argv + ["--device", "cpu"])
        assert err.value.code == 2
    assert "cannot be combined with --resume" in capsys.readouterr().err
