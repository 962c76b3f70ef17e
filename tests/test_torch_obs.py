"""The port's obs (``repro_torch.obs``) against the JAX package's and its
own contracts (mirroring ``tests/test_obs.py``).

* Writers: the port's jsonl and csv files equal the reference writers'
  files byte for byte for the same rows; the buffered writer keeps order,
  fans out and surfaces a sink error at ``drain``.
* Report: ``repro_torch.obs.report.summarize`` on a run directory a JAX
  ``Experiment`` wrote equals ``repro.obs.report.summarize`` on it, and the
  reverse on a port run; the CLI renders; spikes, non-finite values and
  srank collapse are flagged.
* Stream: downsampling on absolute steps; a chunk's stream equals the
  per-step metrics of eager supersteps, bitwise; the train rows' keys of a
  port run equal a JAX run's at the same spec; one superstep's train row,
  fed the reference's draws (``tests/test_torch_train.py``'s harness),
  matches the reference's metrics at that harness's tolerance.
* Contracts, both loops: obs on equals obs off bitwise; ``run(5); save;
  restore; run(7)`` with a jsonl sink equals ``run(12)`` bitwise and the
  file reads back as one run; a profiler trace of the first chunk holds
  the ``repro.chunk_dispatch`` span.
"""
import json
import math
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.obs.report import SPIKE_FACTOR, load_rows
from repro_torch.obs.stream import ObsRun
from repro_torch.obs.trace import TraceCapture, annotate
from repro_torch.obs.writers import (BufferedWriter, CsvWriter, JsonlWriter,
                                     MemoryWriter)
from repro_torch.rl.experiment import Experiment, ExperimentSpec, ObsSpec
from repro_torch.rl.runner import Trainer, scalar_keys, state_leaves

_SMALL = dict(num_units=16, num_layers=1, use_ofenet=False, n_core=1,
              n_env=4, total_steps=12, warmup_steps=8, eval_every=3,
              eval_episodes=1, replay_capacity=256, batch_size=16,
              replay_backend="device")


def _small(**overrides):
    return ExperimentSpec().override(**{**_SMALL, **overrides})


def _obs(log_dir, sinks=("jsonl", "memory"), log_every=1, **kw):
    return {"obs.enabled": True, "obs.sinks": sinks,
            "obs.log_dir": str(log_dir), "obs.log_every": log_every, **kw}


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(state_leaves(a),
                                                 state_leaves(b))) \
        and torch.equal(a.gen.get_state(), b.gen.get_state())


_ROWS = [{"kind": "train", "step": 1, "critic_loss": 0.5, "alpha": 0.1,
          "grad_norm_actor": float("nan")},
         {"kind": "train", "step": 2, "critic_loss": 1e-30, "extra": 3.0},
         {"kind": "eval", "step": 2, "return": -100.25},
         {"kind": "event", "event": "chunk", "step": 2, "steps": 2.0,
          "wall_s": 0.001}]


# ------------------------------------------------------------------ writers

@pytest.mark.parametrize("kind", ["jsonl", "csv"])
def test_writer_files_equal_the_reference_writers_byte_for_byte(
        tmp_path, kind):
    from repro.obs import writers as jw
    from repro_torch.obs import writers as tw
    files = []
    for mod, d in ((jw, tmp_path / "jax"), (tw, tmp_path / "torch")):
        w = mod.make_writer(kind, str(d))
        w.write(_ROWS[:2])
        w.write(_ROWS[2:])
        w.close()
        w = mod.make_writer(kind, str(d))      # a resumed run appends
        w.write(_ROWS[:1])
        w.close()
        files.append(sorted(d.iterdir()))
    (a,), (b,) = files
    assert a.name == b.name == {"jsonl": "metrics.jsonl",
                                "csv": "metrics.csv"}[kind]
    assert a.read_bytes() == b.read_bytes()


def test_jsonl_round_trips_and_report_dedups_last_wins(tmp_path):
    w = JsonlWriter(str(tmp_path / "metrics.jsonl"))
    w.write([{"kind": "train", "step": 5, "loss": 1.0}])
    w.close()
    w = JsonlWriter(str(tmp_path / "metrics.jsonl"))
    w.write([{"kind": "train", "step": 5, "loss": 2.0},
             {"kind": "train", "step": 10, "loss": 3.0}])
    w.close()
    rows = load_rows(str(tmp_path))
    assert [(r["step"], r["loss"]) for r in rows] == [(5, 2.0), (10, 3.0)]


def test_csv_writer_pins_header_to_first_row(tmp_path):
    w = CsvWriter(str(tmp_path / "metrics.csv"))
    w.write([{"kind": "train", "step": 1, "a": 1.0}])
    w.write([{"kind": "train", "step": 2, "b": 9.0},
             {"kind": "train", "step": 3, "a": 3.0}])
    w.close()
    lines = (tmp_path / "metrics.csv").read_text().splitlines()
    assert lines == ["kind,step,a", "train,1,1.0", "train,2,",
                     "train,3,3.0"]


def test_buffered_writer_keeps_order_and_fans_out():
    m1, m2 = MemoryWriter(), MemoryWriter()
    bw = BufferedWriter([m1, m2], maxsize=4)     # small queue: blocks
    stop = threading.Event()

    def pound():
        i = 100
        while not stop.is_set():
            bw.write([{"kind": "train", "step": i}])
            i += 1
    for i in range(100):
        bw.write([{"kind": "train", "step": i}])
    t = threading.Thread(target=pound)
    t.start()
    time.sleep(0.02)
    stop.set()
    t.join()
    bw.drain()
    steps = [r["step"] for r in m1.rows]
    assert steps == list(range(len(steps))) and len(steps) >= 100
    assert m1.rows == m2.rows
    bw.close()


class _BoomWriter:
    def __init__(self):
        self.calls = 0

    def write(self, rows):
        self.calls += 1
        if self.calls == 1:
            raise ValueError("boom: sink bug")

    def flush(self):
        pass

    def close(self):
        pass


def test_buffered_writer_errors_surface_at_drain_not_in_thread():
    bw = BufferedWriter([_BoomWriter()])
    bw.write([{"kind": "train", "step": 1}])
    with pytest.raises(ValueError, match="sink bug"):
        bw.drain()
    bw.write([{"kind": "train", "step": 2}])
    bw.drain()
    bw.close()
    with pytest.raises(RuntimeError, match="closed"):
        bw.write([{"kind": "train", "step": 3}])


# ------------------------------------------------------------------- stream

def test_stream_downsamples_on_absolute_steps():
    def run_chunks(bounds):
        obs = ObsRun(ObsSpec(enabled=True, log_every=5, sinks=("memory",)))
        start = 0
        for stop in bounds:
            n = stop - start
            obs.flush_chunk(start, {"loss": np.arange(n) + start + 1.0})
            start = stop
        obs.drain()
        return [(r["step"], r["loss"]) for r in obs.rows]

    expect = [(5, 5.0), (10, 10.0), (15, 15.0)]
    assert run_chunks([15]) == run_chunks([7, 15]) == expect
    assert run_chunks([3, 6, 9, 12, 15]) == expect
    obs = ObsRun(ObsSpec(enabled=True, log_every=5, sinks=("memory",)))
    for s in range(1, 16):
        obs.log_train(s, {"loss": float(s)})
    obs.drain()
    assert [(r["step"], r["loss"]) for r in obs.rows] == expect
    assert obs.state() == {"rows_written": 3, "events_written": 0,
                           "last_train_step": 15}


def test_obsrun_disabled_is_inert():
    obs = ObsRun(ObsSpec())
    obs.flush_chunk(0, {"loss": np.ones(8)})
    obs.log_train(1, {"loss": 1.0})
    obs.log_eval(1, -10.0, {})
    obs.log_event("chunk", step=1, steps=1)
    obs.drain()
    assert obs.rows == [] and obs.rows_written == 0
    assert obs.trace.status == "idle"
    obs.close()


def test_chunk_stream_is_each_eager_superstep_bitwise():
    """``chunk_fn``'s ``out["stream"]``: every scalar metric of every
    superstep, sorted names, equal to the eager supersteps' metrics."""
    spec = _small(**{"obs.enabled": True, "eval.srank_every": 2})
    tr = Trainer(spec, device="cpu")
    assert tr.obs_stream and tr.stream_rows == 2
    ls = tr.init()
    from repro_torch.rl.runner import clone_state
    ref = clone_state(ls)
    ls, out = tr.chunk_fn(2, False)(ls)
    rows = []
    for _ in range(2):
        ref, m, _ = tr.step(ref)
        rows.append(m)
    assert list(out["stream"]) == list(scalar_keys(m))
    assert {"grad_norm_actor", "update_ratio_critics", "alpha",
            "staleness_max"} <= set(out["stream"])
    for k, v in out["stream"].items():
        assert v.dtype == np.float32 and v.shape == (2,)
        assert [float(x) for x in v] == [float(r[k]) for r in rows], k
    assert _bitwise(ls, ref)
    with pytest.raises(ValueError, match="stream"):
        tr.chunk_fn(3, False)
    assert "stream" not in Trainer(_small(), device="cpu").chunk_fn(
        5, False)(ref)[1]


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_train_row_keys_equal_a_jax_run(algo, tmp_path):
    from repro.rl.experiment import Experiment as JExperiment
    from repro.rl.experiment import ExperimentSpec as JSpec
    over = dict(_SMALL, algo=algo, loop="scan", use_ofenet=True,
                ofenet_units=8, ofenet_layers=2,
                **{"obs.enabled": True, "obs.log_every": 3})
    jexp = JExperiment.from_spec(JSpec().override(**over))
    jexp.run(6)
    texp = Experiment.from_spec(ExperimentSpec().override(**over),
                                device="cpu")
    texp.run(6)
    for e in (jexp, texp):
        e.obs.drain()
    jtrain = [r for r in jexp.obs.rows if r["kind"] == "train"]
    ttrain = [r for r in texp.obs.rows if r["kind"] == "train"]
    assert [r["step"] for r in ttrain] == [r["step"] for r in jtrain] \
        == [3, 6]
    assert [list(r) for r in ttrain] == [list(r) for r in jtrain]
    assert ("alpha" in ttrain[0]) == (algo == "sac")
    assert "grad_norm_ofenet" in ttrain[0]
    jexp.close(), texp.close()


@pytest.mark.parametrize("algo,backend", [("sac", "fused"), ("td3", "jnp")])
def test_one_superstep_train_row_matches_the_reference(algo, backend):
    """The train row of one superstep from the reference's state with the
    reference's draws (``test_torch_train``'s harness) against the row the
    reference's ``ObsRun`` writes from its ``py_step``'s metrics."""
    from repro.obs.stream import ObsRun as JObsRun
    from repro.rl.experiment import ExperimentSpec as JSpec
    from repro.rl.runner import Trainer as JTrainer
    from test_torch_train import _BASE, _port_state, jax_superstep_draws
    over = dict(_BASE, block_backend=backend, algo=algo,
                **{"obs.enabled": True, "obs.sinks": ("memory",),
                   "obs.log_every": 1})
    jtr = JTrainer(JSpec().override(**over))
    jls = jtr.init()
    draws = jax_superstep_draws(jtr, jls.key)
    tls = _port_state(jls, 1)
    _, jm, _ = jtr.py_step(jls)
    spec = ExperimentSpec().override(**over)
    ttr = Trainer(spec, device="cpu")
    _, tm, _ = ttr.step(tls, draws)
    jobs, tobs = JObsRun(JSpec().override(**over).obs), ObsRun(spec.obs)
    jobs.log_train(1, {k: float(np.asarray(v)) for k, v in jm.items()
                       if np.ndim(v) == 0})
    tobs.log_train(1, {k: float(v) for k, v in tm.items() if v.ndim == 0})
    jobs.drain(), tobs.drain()
    (jrow,), (trow,) = jobs.rows, tobs.rows
    assert sorted(trow) == sorted(jrow)
    assert "grad_norm_critics" in trow and "update_ratio_actor" in trow
    for k, v in jrow.items():
        if k in ("kind", "step"):
            assert trow[k] == v
        else:           # the harness's 1e-3 (AdamW moments: the grads)
            np.testing.assert_allclose(trow[k], v, rtol=1e-3,
                                       atol=1e-3 * max(abs(v), 1e-6),
                                       err_msg=k)
    jobs.close(), tobs.close()


# ------------------------------------------------------- bitwise on/off

@pytest.mark.parametrize("loop,algo", [("python", "sac"), ("scan", "sac"),
                                       ("scan", "td3")])
def test_obs_stream_is_bitwise_invisible(loop, algo, tmp_path):
    """The default stream (grad-norm taps on, per-step cadence,
    jsonl+memory sinks) changes nothing trained."""
    base = dict(_SMALL, loop=loop, algo=algo)
    off = Experiment.from_spec(ExperimentSpec().override(**base),
                               device="cpu")
    r_off = off.run(eval_at_end=True, keep_last=True)
    exp = Experiment.from_spec(ExperimentSpec().override(
        **base, **_obs(tmp_path)), device="cpu")
    r_on = exp.run(eval_at_end=True, keep_last=True)
    assert _bitwise(off._ls, exp._ls)
    assert r_on.returns == r_off.returns
    assert r_on.eval_steps == r_off.eval_steps
    np.testing.assert_array_equal(r_on.last_priorities, r_off.last_priorities)
    train = [r for r in exp.obs.rows if r["kind"] == "train"]
    assert [r["step"] for r in train] == list(range(1, 13))
    assert all("grad_norm_critics" in r and "update_ratio_critics" in r
               for r in train)
    run = [r for r in exp.obs.rows if r.get("event") == "run"]
    assert len(run) == 1 and run[0]["host_dispatches"] == 12
    exp.close()


@pytest.mark.parametrize("loop", ["python", "scan"])
def test_resume_parity_with_jsonl_sink(loop, tmp_path):
    """``run(5); save; restore; run(7)`` with the obs stack attached is
    bitwise ``run(12)``, and the appended metrics.jsonl reads back as one
    run (last row wins over the replayed steps)."""
    spec = _small(loop=loop, **_obs(tmp_path / "run"))
    full = Experiment.from_spec(spec, device="cpu")
    r_full = full.run(12)
    part = Experiment.from_spec(spec, device="cpu")
    part.run(5)
    path = str(tmp_path / "ck.npz")
    part.save(path)
    res = Experiment.restore(path, device="cpu")
    assert res.spec == spec
    assert res.obs.state() == part.obs.state()
    r_res = res.run(7)
    assert r_res.returns == r_full.returns
    assert r_res.eval_steps == r_full.eval_steps
    assert _bitwise(full._ls, res._ls)
    full_rows = [r for r in full.obs.rows if r["kind"] == "train"]
    res_rows = [r for r in part.obs.rows + res.obs.rows
                if r["kind"] == "train"]
    assert res_rows == full_rows
    full.close(), part.close(), res.close()
    rows = load_rows(str(tmp_path / "run"))
    train = [r for r in rows if r["kind"] == "train"]
    assert [r["step"] for r in train] == list(range(1, 13))
    assert train == full_rows
    marks = [r["event"] for r in rows if r["kind"] == "event"
             and r["event"] in ("save", "restore")]
    assert marks == ["save", "restore"]


# ------------------------------------------------------------------ trace

def test_trace_captures_the_first_chunk_with_its_spans(tmp_path):
    tc = TraceCapture(2, str(tmp_path / "t"))
    assert tc.status == "pending"
    tc.begin()
    assert tc.status == "active"
    tc.begin()                                   # idempotent while active
    with annotate("repro.test_span"):
        torch.ones(4).sum()
    tc.end()
    assert tc.status == "active" and tc.remaining == 1
    tc.end()
    assert tc.status == "done" and not tc.active
    tc.finish()
    assert "repro.test_span" in open(tc.path).read()

    spec = _small(loop="scan", srank_every=3,
                  **_obs(tmp_path / "run", sinks=("jsonl",),
                        **{"obs.trace": 1}))
    exp = Experiment.from_spec(spec, device="cpu")
    exp.run(6)
    exp.close()
    assert exp.obs.trace.status == "done"
    text = open(exp.obs.trace.path).read()
    assert exp.obs.trace.path.startswith(str(tmp_path / "run" / "trace"))
    for span in ("repro.chunk_dispatch", "repro.srank", "repro.eval"):
        assert span in text, span
    events = [r for r in load_rows(str(tmp_path / "run"))
              if r.get("event") == "trace"]
    assert events[-1]["status"] == "done"


# ------------------------------------------------------------ report CLI

def _summaries(run_dir):
    from repro.obs import report as jreport
    from repro_torch.obs import report as treport
    return (treport.summarize(treport.load_rows(str(run_dir))),
            jreport.summarize(jreport.load_rows(str(run_dir))))


def test_report_of_a_jax_run_dir_equals_the_reference_report(tmp_path):
    from repro.rl.experiment import Experiment as JExperiment
    from repro.rl.experiment import ExperimentSpec as JSpec
    over = dict(_SMALL, loop="scan", srank_every=6,
                **_obs(tmp_path, sinks=("jsonl",), log_every=2))
    jexp = JExperiment.from_spec(JSpec().override(**over))
    jexp.run(12, eval_at_end=True)
    jexp.close()
    ours, ref = _summaries(tmp_path)
    assert ours == ref
    assert ours["counts"]["train"] == 6 and ours["srank"]["n"] == 2


def test_report_of_a_port_run_dir_equals_the_reference_report(tmp_path,
                                                              capsys):
    spec = _small(loop="scan", srank_every=6,
                  **_obs(tmp_path, sinks=("jsonl",), log_every=2))
    exp = Experiment.from_spec(spec, device="cpu")
    exp.run(12, eval_at_end=True)
    exp.close()
    ours, ref = _summaries(tmp_path)
    assert ours == ref
    s = ours
    assert s["counts"]["train"] == 6 and s["counts"]["eval"] >= 4
    assert s["steps"] == {"first": 2, "last": 12}
    assert s["throughput"]["steps"] == 12
    assert s["throughput"]["chunks"] == 4
    assert set(s["grad_norms"]) == {"grad_norm_actor", "grad_norm_critics"}
    assert s["staleness"] and s["srank"]["n"] == 2
    from repro_torch.obs import report
    assert report.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "throughput:" in out and "grad_norm_critics" in out
    assert report.main([str(tmp_path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["counts"]["train"] == 6
    import repro_torch.obs as obs_pkg
    assert obs_pkg.summarize is report.summarize


def test_report_flags_spikes_nonfinite_and_srank_collapse(tmp_path):
    w = JsonlWriter(str(tmp_path / "metrics.jsonl"))
    base = [{"kind": "train", "step": s, "critic_loss": 1.0,
             "grad_norm_actor": 2.0} for s in (1, 2, 3, 4, 5)]
    base[3]["critic_loss"] = SPIKE_FACTOR * 1.0 + 1.0
    base[4]["grad_norm_actor"] = math.inf
    w.write(base)
    w.write([{"kind": "event", "event": "srank", "step": 2, "srank": 40.0},
             {"kind": "event", "event": "srank", "step": 5, "srank": 10.0}])
    w.close()
    ours, ref = _summaries(tmp_path)
    assert ours == ref
    why = {(f["metric"], f["step"]): f["why"] for f in ours["instability"]}
    assert "spike" in why[("critic_loss", 4)]
    assert why[("grad_norm_actor", 5)] == "non-finite"
    assert "collapse" in why[("srank", 5)]


def test_load_rows_rejects_bad_schema(tmp_path):
    p = tmp_path / "metrics.jsonl"
    p.write_text('{"kind": "train"}\n')
    with pytest.raises(ValueError, match="kind/step"):
        load_rows(str(tmp_path))
    p.write_text("not json\n")
    with pytest.raises(ValueError, match="JSONL"):
        load_rows(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="jsonl sink"):
        load_rows(str(tmp_path / "nope"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph records the stream")
    return torch.device("cuda")


def test_cuda_graph_stream_is_each_eager_superstep_bitwise(cuda_device):
    """Under the CUDA graph the graph writes each replay's row: the
    stream of chunks of 2 and 3 (the first with the warm-up's row) equals
    the eager supersteps' metrics, bitwise, and the state too."""
    spec = _small(loop="scan", replay_kernel="pallas",
                  **{"obs.enabled": True, "eval.srank_every": 3})
    tr = Trainer(spec, device=cuda_device)
    ls = tr.init()
    from repro_torch.rl.runner import clone_state
    eager, graph = clone_state(ls), clone_state(ls)
    rows = []
    for _ in range(5):
        eager, m, _ = tr.step(eager)
        rows.append({k: float(v) for k, v in m.items() if v.ndim == 0})
    streams = []
    for n in (2, 3):
        graph, out = tr.chunk_fn(n, False)(graph)
        streams.append(out["stream"])
    got = [{k: float(v[i]) for k, v in s.items()}
           for s in streams for i in range(len(next(iter(s.values()))))]
    assert got == rows and tr.captures == 1 and tr.dispatches == 5
    assert _bitwise(graph, eager)
