"""Dynamic half of ``repro_torch.check``: gates over a real run (port of
``repro/check/dynamic.py``, its gates rebuilt for torch and the card).

``python -m repro_torch.check dynamic --preset smoke`` runs the
reference's spec (the preset on the device replay under
``loop="scan"``, srank at every eval, obs and the guard off; plus any
``--override``) twice and checks three things the static rules can only
approximate:

* **D001 — no hidden sync.** The second, steady-state pass runs under
  ``torch.cuda.set_sync_debug_mode("error")``: any synchronizing CUDA
  call inside the loop (a stray ``.item()``, ``.cpu()``, ``float()`` of a
  device tensor, a blocking copy, a ``synchronize``) raises. The chunk
  epilogue's explicit reads (the stream's one copy, srank, eval and their
  scalars, which the reference also fetches there) run inside
  ``runner.host_read``, which lowers the mode for their span. On the CPU
  the mode watches nothing, so D001 reports that it did not run.
* **D002 — captures and chunks on the schedule.** On the card a run
  captures one ``StepGraph`` for every chunk length, at its first chunk:
  after the first pass ``Trainer.captures`` is 1 (0 on the CPU, where a
  chunk runs eagerly) and the second pass adds none. The chunks
  ``Experiment.run`` dispatches must be ``chunk_signatures``' for each
  pass's step range.
* **D003 — one clean superstep.** One eager superstep from a copy of the
  run's state must leave every parameter finite
  (``guard.monitor.all_finite``) and, on the card, the sum-tree write's
  skip counter (``kernels.replay_tree.ops.skipped_writes``) where it was;
  on the CPU an index outside the tree raises ``IndexError`` from the
  plain twin (ROADMAP C0), which is a finding too.

Findings use the static report format; exit 0 clean, 1 with findings.
"""
from __future__ import annotations

import argparse
import sys
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.check.report import Finding, render

Sig = Tuple[int, bool, bool]

GATES = ("D001", "D002", "D003")


def chunk_signatures(start: int, end: int, eval_every: int,
                     srank_every: int) -> List[Sig]:
    """The chunk signatures ``Experiment.run`` dispatches for a step range.

    This mirrors the scheduler in ``rl/experiment.py`` line for line:
    chunks stop at every eval point, every srank point, and ``end``; the
    signature is ``(n_steps, do_eval, do_srank)``.
    """
    sigs: List[Sig] = []
    step = start
    while step < end:
        stops = [(step // eval_every + 1) * eval_every, end]
        if srank_every:
            stops.append((step // srank_every + 1) * srank_every)
        stop = min(stops)
        do_eval = stop % eval_every == 0
        do_srank = bool(srank_every) and stop % srank_every == 0
        sigs.append((stop - step, do_eval, do_srank))
        step = stop
    return sigs


def _dyn(rule: str, message: str, hint: str) -> Finding:
    return Finding(rule=rule, file="<dynamic>", line=1, message=message,
                   hint=hint)


def gate_spec(preset: str = "smoke", overrides: Optional[Dict] = None):
    """The spec the gates run: ``preset`` on the device replay under the
    scan loop, srank at every eval, obs and the guard off, then
    ``overrides``."""
    from repro_torch.rl import presets
    base = presets.get(preset)
    return base.override(
        loop="scan", replay_backend="device",
        srank_every=base.eval.every,
        **{"obs.enabled": False, "guard.enabled": False,
           **(overrides or {})})


def _record_chunks(trainer, log: List[Sig]) -> None:
    """Wrap ``trainer.chunk_fn`` so every dispatch appends its signature
    to ``log``."""
    inner = trainer.chunk_fn

    def chunk_fn(n_steps, do_eval, do_srank=False):
        log.append((n_steps, bool(do_eval),
                    bool(do_srank) and bool(trainer.srank_every)))
        return inner(n_steps, do_eval, do_srank)
    trainer.chunk_fn = chunk_fn


def run_sanitizers(preset: str = "smoke", *, steps: Optional[int] = None,
                   device=None, overrides: Optional[Dict] = None
                   ) -> Tuple[List[Finding], Dict[str, str]]:
    """Run the D001/D002/D003 gates; returns ``(findings, status)``,
    ``status`` each gate's ``"passed"``, ``"failed"`` or ``"not run:
    <why>"``."""
    import torch

    from repro_torch.guard.monitor import all_finite
    from repro_torch.kernels.replay_tree import ops
    from repro_torch.rl.experiment import Experiment
    from repro_torch.rl.runner import clone_state

    spec = gate_spec(preset, overrides)
    ev = spec.eval
    budget = steps or spec.execution.total_steps
    findings: List[Finding] = []
    status: Dict[str, str] = {}
    exp = Experiment.from_spec(spec, device=device)
    tr = exp.trainer
    card = tr.device.type == "cuda"

    # ---- first pass: every capture the schedule needs ------------------
    log: List[Sig] = []
    _record_chunks(tr, log)
    exp.run(budget)
    want_captures = 1 if card else 0
    predicted = chunk_signatures(0, budget, ev.every, ev.srank_every)
    if log != predicted or tr.captures != want_captures:
        findings.append(_dyn(
            "D002",
            f"first pass: {tr.captures} capture(s) (want {want_captures}) "
            f"and chunks {log}; the scheduler predicts {predicted}",
            "one StepGraph serves every chunk length, captured at the "
            "first chunk; a chunk outside the prediction means "
            "Experiment.run's scheduler diverged from chunk_signatures"))

    # ---- steady state: the same schedule, no sync, no capture ----------
    log.clear()
    n_before = tr.captures
    mode = torch.cuda.get_sync_debug_mode() if card else 0
    completed = False
    try:
        if card:
            torch.cuda.synchronize(tr.device)
            torch.cuda.set_sync_debug_mode("error")
        exp.run(budget)
        completed = True
    except Exception:
        if not card:         # no sync mode on the CPU: a fault, not D001
            raise
        tb = traceback.format_exc(limit=20)
        findings.append(_dyn(
            "D001",
            f"a synchronizing call inside the steady-state run:\n"
            f"{tb.strip()}",
            "read device values only at the chunk epilogue, inside "
            "runner.host_read; never .item()/.cpu()/float() a device "
            "tensor mid-loop"))
    finally:
        if card:
            torch.cuda.set_sync_debug_mode(mode)
    status["D001"] = ("not run: no CUDA device (the sync debug mode "
                      "watches the card only)" if not card else
                      "failed" if any(f.rule == "D001" for f in findings)
                      else "passed")
    predicted = chunk_signatures(budget, 2 * budget, ev.every,
                                 ev.srank_every)
    n_new = tr.captures - n_before
    # an interrupted pass (D001) dispatched only some of its chunks
    if n_new or (completed and log != predicted):
        findings.append(_dyn(
            "D002",
            f"steady-state pass: {n_new} new capture(s), chunks {log}; "
            f"the scheduler predicts {predicted}",
            "the second pass re-chunks the same schedule on the captured "
            "graph, so a new capture is a graph rebuilt per chunk"))
    status["D002"] = ("failed" if any(f.rule == "D002" for f in findings)
                      else "passed")

    # ---- one eager superstep -------------------------------------------
    try:
        skipped = ops.skipped_writes(tr.device) if card else 0
        nxt = tr.step(clone_state(exp._ls))[0]
        bad = []
        if not all_finite(nxt.agent["params"]):
            bad.append("a non-finite parameter after the superstep")
        if card and ops.skipped_writes(tr.device) != skipped:
            bad.append(f"{ops.skipped_writes(tr.device) - skipped} sum-tree "
                       f"write(s) outside the leaves, skipped on the card")
        if bad:
            raise FloatingPointError("; ".join(bad))
    except (FloatingPointError, IndexError) as e:
        findings.append(_dyn(
            "D003",
            f"one superstep: {type(e).__name__}: {e}",
            "a NaN or an out-of-range replay index inside the superstep is "
            "a training fault: bisect it with the python loop"))
    status["D003"] = ("failed" if any(f.rule == "D003" for f in findings)
                      else "passed")
    return findings, status


def report(findings: List[Finding], status: Dict[str, str]) -> str:
    """Each gate's status, then the findings."""
    return "\n".join([f"{g}: {status.get(g, 'not run')}" for g in GATES]
                     + [render(findings)])


def main(argv: Optional[Sequence[str]] = None) -> int:
    from repro_torch.rl.experiment import parse_overrides
    ap = argparse.ArgumentParser(
        prog="repro_torch.check dynamic",
        description="sync-debug / capture / finite-superstep gates")
    ap.add_argument("--preset", default="smoke",
                    help="preset to run (default: smoke)")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the per-pass step budget")
    ap.add_argument("--device", default=None,
                    help="the run's device (default: the card)")
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="spec override, e.g. execution.mesh_shards=4 "
                         "(repeatable)")
    args = ap.parse_args(argv)
    findings, status = run_sanitizers(
        args.preset, steps=args.steps, device=args.device,
        overrides=parse_overrides(args.override))
    print(report(findings, status))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
