"""Crash-safe supervisor: ``python -m repro_torch.guard.supervise <preset>``
(port of ``repro/guard/supervise.py``).

Runs an ``Experiment`` (or, with ``--seeds N``, a ``Fleet``) in SEGMENTS
with a durable checkpoint after each one, inside a worker SUBPROCESS that
a parent supervisor restarts after any crash — SIGKILL, OOM, preemption, a
guard halt — with bounded retries and exponential backoff. Auto-resume rides the bitwise resume contract: each
attempt restores the newest GOOD checkpoint from the ``DurableStore``
(checksum-verified, falling back past torn/corrupt ones) and replays from
there, so a supervised run that crashed K times ends with the same params
and eval returns as an uninterrupted run, bit for bit. The worker runs on
the CUDA card unless ``--device cpu`` is passed.

Layout under ``--dir``::

    ckpts/                durable checkpoints (repro_torch.guard.store)
    result.json           terminal state of the successful attempt: step,
                          eval returns, sha256 digest of the final params
    incident.json         structured incident report, written by the parent
    incident-worker.json  a failing attempt's guard violations (transient;
                          merged into incident.json by the parent)
    chaos-*.fired         OneShot latches (``--chaos`` faults fire once
                          ACROSS attempts)

Deterministic fault injection (``--chaos``, repeatable)::

    kill@K           SIGKILL at the first segment boundary >= K, BEFORE the
                     save — the segment is lost and must replay on resume
    kill-in-save@K   SIGKILL inside the first save at a boundary >= K, one
                     rename short of commit (torn-commit window)
    corrupt-latest@K bit-flip the newest committed checkpoint right after
                     the first save at a boundary >= K
    nan@K[:m]        NaN-poison the live params right AFTER the first save
                     at a boundary >= K (member m in a fleet) — the next
                     segment's guard detects it; with guard.policy=rollback
                     the run recovers in-process from the checkpoint it
                     just wrote

Exit codes: 0 = run completed; 2 = retry budget spent (see incident.json).
Worker-internal: 3 = ``GuardViolation`` (halt policy or recovery budget).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from repro_torch.guard import chaos
from repro_torch.guard.monitor import GuardViolation
from repro_torch.guard.store import DurableStore

RESULT = "result.json"
INCIDENT = "incident.json"
WORKER_INCIDENT = "incident-worker.json"
EXIT_BUDGET_SPENT = 2
EXIT_GUARD = 3


@dataclass
class Fault:
    """One parsed ``--chaos`` entry + its cross-attempt latch."""
    kind: str                  # kill | kill-in-save | corrupt-latest | nan
    at: int
    member: int
    latch: chaos.OneShot

    def due(self, step: int) -> bool:
        return step >= self.at and not self.latch.fired()


def _parse_chaos(spec: str, run_dir: Path) -> Fault:
    kind, sep, rest = spec.partition("@")
    if not sep:
        raise SystemExit(f"--chaos {spec!r}: expected <fault>@<step>")
    member = 0
    if ":" in rest:
        rest, _, mstr = rest.partition(":")
        member = int(mstr)
    kinds = ("kill", "kill-in-save", "corrupt-latest", "nan")
    if kind not in kinds:
        raise SystemExit(f"--chaos {spec!r}: fault must be one of {kinds}")
    name = spec.replace("@", "-at-").replace(":", "-m")
    return Fault(kind, int(rest), member, chaos.OneShot(str(run_dir), name))


def _keystr(path) -> str:
    """A leaf path as ``jax.tree_util.keystr`` renders it."""
    return "".join(f"[{p!r}]" if isinstance(p, str) else f"[{p}]"
                   for p in path)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _digest(params) -> str:
    """Order-stable sha256 over every param leaf (cross-process compare),
    in the reference's leaf order and key rendering: equal params of either
    package give the same digest."""
    h = hashlib.sha256()
    for path, leaf in _flat(params):
        h.update(_keystr(path).encode())
        h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.guard.supervise",
        description="Crash-safe supervised training with durable "
                    "checkpoints and auto-resume.")
    ap.add_argument("preset", help="preset name (repro_torch.rl.presets)")
    ap.add_argument("--dir", required=True, help="run directory")
    ap.add_argument("--steps", type=int, default=0,
                    help="total steps (default: the spec budget)")
    ap.add_argument("--save-every", type=int, default=0,
                    help="durable-save cadence (default: eval.every)")
    ap.add_argument("--seeds", type=int, default=1,
                    help=">1: run a Fleet of this many seeds")
    ap.add_argument("--keep", type=int, default=3,
                    help="durable checkpoints retained (keep-last-K)")
    ap.add_argument("--retries", type=int, default=3,
                    help="worker restarts after the first attempt")
    ap.add_argument("--backoff", type=float, default=0.5,
                    help="base retry delay, doubles per attempt (s)")
    ap.add_argument("--device", default=None,
                    help="the worker's device (default: the CUDA card)")
    ap.add_argument("--override", action="append", default=[],
                    metavar="K=V", help="spec override (repeatable)")
    ap.add_argument("--chaos", action="append", default=[],
                    metavar="FAULT@STEP", help="inject a fault (repeatable)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


# ------------------------------------------------------------------ worker

def _worker(args) -> int:
    # heavy imports only in the worker: the parent stays a thin respawner
    from repro_torch.rl import presets
    from repro_torch.rl.experiment import Experiment, parse_overrides
    from repro_torch.rl.sweep import Fleet

    run_dir = Path(args.dir)
    spec = presets.get(args.preset)
    if args.override:
        spec = spec.override(**parse_overrides(args.override))
    total = args.steps or spec.execution.total_steps
    save_every = args.save_every or spec.eval.every
    faults = [_parse_chaos(c, run_dir) for c in args.chaos]

    store = DurableStore(str(run_dir / "ckpts"), keep=args.keep)
    store.clean_staging()
    bad: List[dict] = []
    path = store.restore_latest(
        on_bad=lambda b: bad.append({"path": str(b.path),
                                     "reason": b.reason}))
    resumed_from = DurableStore.step_of(path) if path is not None else None
    fleet = args.seeds > 1
    if fleet:
        handle = (Fleet.restore(store.payload(path), device=args.device)
                  if path is not None
                  else Fleet([spec.override(seed=spec.execution.seed + i)
                              for i in range(args.seeds)],
                             device=args.device))
    else:
        handle = (Experiment.restore(store.payload(path), device=args.device)
                  if path is not None
                  else Experiment.from_spec(spec, device=args.device))
    handle.attach_guard(store)
    note = {"resumed_from": resumed_from, "bad_checkpoints": bad}

    try:
        while handle.step < total:
            target = min(total,
                         (handle.step // save_every + 1) * save_every)
            handle.run(target - handle.step)
            for f in faults:                       # pre-save: lost segment
                if f.kind == "kill" and f.due(handle.step) \
                        and f.latch.fire():
                    chaos.kill_now()
            for f in faults:                       # torn-commit window
                if f.kind == "kill-in-save" and f.due(handle.step) \
                        and f.latch.fire():
                    chaos.arm_kill_mid_save(store)
            store.save(lambda p: handle.save(p), handle.step)
            for f in faults:                       # post-save faults
                if not f.due(handle.step):
                    continue
                if f.kind == "corrupt-latest" and f.latch.fire():
                    chaos.corrupt_checkpoint(store.checkpoints()[-1])
                elif f.kind == "nan" and f.latch.fire():
                    chaos.poison_params(handle,
                                        member=f.member if fleet else None)
    except GuardViolation as gv:
        (run_dir / WORKER_INCIDENT).write_text(json.dumps(dict(
            note, step=int(handle.step), error=str(gv),
            recoveries=gv.recoveries,
            violations=[v.as_dict() for v in gv.violations]), indent=1))
        return EXIT_GUARD
    finally:
        handle.close()

    params = (handle._fls.agent["params"] if fleet
              else handle._ls.agent["params"])
    mon = handle._guard if fleet else handle._monitor
    (run_dir / RESULT).write_text(json.dumps(dict(
        note, step=int(handle.step), returns=list(handle.returns),
        params_sha256=_digest(params),
        recoveries=mon.recoveries if mon is not None else 0), indent=1))
    return 0


# -------------------------------------------------------------- supervisor

def _worker_argv(args) -> List[str]:
    argv = [sys.executable, "-m", "repro_torch.guard.supervise",
            args.preset, "--dir", args.dir, "--steps", str(args.steps),
            "--save-every", str(args.save_every),
            "--seeds", str(args.seeds), "--keep", str(args.keep)]
    if args.device is not None:
        argv += ["--device", args.device]
    for o in args.override:
        argv += ["--override", o]
    for c in args.chaos:
        argv += ["--chaos", c]
    return argv + ["--worker"]


def _supervise(args) -> int:
    run_dir = Path(args.dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    attempts: List[dict] = []
    status = "failed"
    for attempt in range(args.retries + 1):
        t0 = time.time()
        proc = subprocess.run(_worker_argv(args))
        rec = {"attempt": attempt, "exit_code": proc.returncode,
               "wall_s": round(time.time() - t0, 3)}
        if proc.returncode < 0:
            rec["signal"] = signal.Signals(-proc.returncode).name
        wi = run_dir / WORKER_INCIDENT
        if wi.exists():
            try:
                rec.update(json.loads(wi.read_text()))
            finally:
                wi.unlink()
        attempts.append(rec)
        if proc.returncode == 0:
            status = "ok"
            break
        print(f"supervise: attempt {attempt} exited "
              f"{rec.get('signal', proc.returncode)}; "
              f"{args.retries - attempt} retr"
              f"{'y' if args.retries - attempt == 1 else 'ies'} left",
              file=sys.stderr)
        if attempt < args.retries:
            time.sleep(args.backoff * (2 ** attempt))
    (run_dir / INCIDENT).write_text(json.dumps(
        {"status": status, "preset": args.preset, "steps": args.steps,
         "save_every": args.save_every, "seeds": args.seeds,
         "retries": args.retries, "backoff_s": args.backoff,
         "chaos": list(args.chaos), "attempts": attempts}, indent=1))
    if status == "ok":
        return 0
    print(f"supervise: retry budget spent after {len(attempts)} attempts "
          f"— see {run_dir / INCIDENT}", file=sys.stderr)
    return EXIT_BUDGET_SPENT


def main(argv: Optional[List[str]] = None) -> int:
    args = _parse(argv)
    return _worker(args) if args.worker else _supervise(args)


if __name__ == "__main__":
    sys.exit(main())
