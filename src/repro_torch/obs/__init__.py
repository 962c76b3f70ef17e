"""repro_torch.obs — in-loop observability: metric streams, sinks, traces,
report (port of ``repro.obs`` for a solo run).

The training loop's chunks are graph replays on the card; this package
opens them up without perturbing them. Five pieces:

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
  restore and the host replay's two waits on the card, plus
  ``ObsSpec(trace=N)`` capturing a profiler trace of the first N chunks
  into ``<log_dir>/trace/``.
* **Phase stamps** (``trace.stamp``): on the card, a superstep graph can
  be captured with a one-thread kernel at each phase boundary that writes
  the card's clock into a device ring, so the graph, which shows the host
  nothing of its inside, says where its device time goes.
  ``Experiment.trace_phases()`` / ``Fleet.trace_phases()`` turn them on
  (the graph is captured anew at the next chunk), and ``obs.trace = N``
  captures with them from the first chunk and keeps them for the whole
  run, past the N chunks it profiles, so that ``phases`` reads at any
  time (0.2-0.9% a superstep on an H100 in the benchmark's cells). Off,
  the graph is the same node for node; on, training is bitwise the same
  (the stamps write only their ring), and each stamp costs one graph
  node. ``Experiment.phases(n)`` / ``Fleet.phases(n)`` synchronize, copy
  the ring to the host once and return, over the last ``n`` replays (or
  all the ring holds, when fewer: two of the longest chunks, the min of
  ``eval.every`` and ``eval.srank_every``; a fleet's: per fleet
  superstep, all members):

      collect    device ms a superstep from its start to the replay add:
                 the draws, the actors' policy and env step, the n-step
                 ring (a host-replay run: its whole segment A)
      replay     the device replay's add and sample, then its refresh
                 with the sampled rows' staleness (two intervals, summed)
      update     the losses, forward and backward, less AdamW
      adamw      the ``adamw_update`` calls, summed
      copyback   the stream row (obs on) and the copy into the static state
      step_gap   from a superstep's last stamp to the next one's first
                 (a host-replay run: and from segment A's end to B's
                 start): epilogues, and the card waiting on the host
      lead_ms    per superstep: its device begin less the host time its
                 replay was launched, on the host's clock: how far the
                 host runs ahead
      clock_uncertainty_ms  the bound of the card-to-host clock mapping
      supersteps the replays read

  None where no stamped graph ran (the CPU, or before a chunk).
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
