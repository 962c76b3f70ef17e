"""repro_torch.obs — in-loop observability: metric streams, sinks, traces,
report (port of ``repro.obs`` for a solo run).

The training loop's chunks are graph replays on the card; this package
opens them up without perturbing them. Four pieces:

* **Metric stream** (``stream.ObsRun``): every superstep records every
  scalar training metric (under the CUDA graph the graph writes its row
  into a device buffer; the chunk epilogue copies the chunk's rows to the
  host once), and ``ObsRun.flush_chunk`` downsamples against ABSOLUTE
  steps (``step % log_every == 0``) and writes rows. Recording reads what
  the superstep computed and writes nothing it reads, so obs on or off
  trains bit for bit the same, and resume stays bitwise with a sink
  attached (tests/test_torch_obs.py).
* **Sinks** (``writers``): the ``MetricWriter`` protocol with JSONL / CSV /
  in-memory implementations behind one ``BufferedWriter`` (async daemon
  thread, ordered, drained by ``Experiment.save``). The files are the
  reference's, letter for letter.
* **Trace hooks** (``trace``): ``torch.profiler`` spans (NVTX ranges on a
  card) around chunk dispatch / eval / srank / checkpoint save and
  restore, plus ``ObsSpec(trace=N)`` capturing a profiler trace of the
  first N chunks into ``<log_dir>/trace/``.
* **Run report** (``report``): ``python -m repro_torch.obs.report
  <run_dir>`` summarizes throughput, grad-norm/staleness trajectories and
  flags instability events (spikes, non-finite values, srank collapse).

Configuration is ``ObsSpec`` in the ``ExperimentSpec`` tree
(``repro_torch.rl.experiment``): ``enabled``, ``log_every``, ``sinks``,
``grad_norms``, ``trace``, ``log_dir``.

Row schema (the reference's; one JSON object per ``metrics.jsonl`` line;
CSV mirrors the train rows' columns):

    {"kind": "train", "step": <int>, <metric>: <float>, ...}
        metrics: critic_loss, actor_loss, aux_loss (OFENet), alpha (SAC),
        q_mean, td_error, staleness_mean/p50/max, and with ``grad_norms``
        on: grad_norm_{actor,critics,ofenet} plus
        update_ratio_{actor,critics,ofenet} (||step Δ|| / ||params||).
    {"kind": "eval", "step": <int>, "return": <float>, ...scalars}
    {"kind": "event", "event": "chunk"|"run"|"srank"|"save"|"restore"|
        "trace"|"guard_*", "step": <int>, ...}
        "chunk": steps, wall_s, steps_per_sec       (scan loop timing)
        "run":   steps, wall_s, steps_per_sec, host_dispatches,
                 chunk_compiles                     (per run() call;
                 dispatches: graph replays + eager supersteps; compiles:
                 graph captures)
        "srank": srank                              (eval.srank_every)
        "save"/"restore": path                      (checkpoint markers)
        "trace": status, dir                        (profiler capture)

A resumed run appends to the same files; readers (the report CLI) keep the
LAST row per (kind, step, event), so replayed steps are reported once.
"""
from repro_torch.obs.stream import ObsRun
from repro_torch.obs.trace import TraceCapture, annotate
from repro_torch.obs.writers import (SINKS, BufferedWriter, CsvWriter,
                                     JsonlWriter, MemoryWriter, MetricWriter,
                                     make_writer)


def __getattr__(name):
    # lazy: importing report at package load would shadow the
    # `python -m repro_torch.obs.report` entry point (runpy warning)
    if name in ("load_rows", "summarize"):
        from repro_torch.obs import report
        return getattr(report, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
