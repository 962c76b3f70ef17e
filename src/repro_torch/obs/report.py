"""Run-report CLI: summarize a run directory's metric stream (copy of
``repro/obs/report.py``).

    python -m repro_torch.obs.report <run_dir> [--json]

Reads ``<run_dir>/metrics.jsonl`` (the JSONL sink's output, of either
package; see ``repro_torch.obs`` for the row schema) and prints a
diagnostic summary:

* throughput        — gradient steps/sec from the per-chunk timing events
* grad norms        — first/last/peak per network (actor/critics/OFENet),
                      plus the update/param-norm ratios
* staleness         — replay priority-staleness trajectory (device backend)
* losses / TD error — trajectory stats
* eval              — best/final return
* instability flags — spikes (value > SPIKE_FACTOR x run median), non-finite
                      values, and srank collapse (final < 1/2 peak): the
                      paper's large-network failure modes, caught from the
                      stream instead of a debugger

Rows are deduplicated by (kind, step[, event]) keeping the LAST occurrence,
so a directory that was resumed from an earlier checkpoint (replaying some
steps) still reports each step once. ``summarize`` returns the summary as a
dict (the CI smoke asserts on it); ``--json`` prints that dict instead of
the human-readable report.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.obs.writers import METRICS_JSONL

SPIKE_FACTOR = 10.0          # value > factor x run median => instability flag
SRANK_COLLAPSE = 0.5         # final srank < this fraction of peak => flag

_NON_METRIC = ("kind", "step", "event", "member")


def load_rows(run_dir: str) -> List[dict]:
    """Parse the directory's metric stream, validating the schema (kind +
    step per row) and deduplicating replayed steps (last occurrence wins,
    keyed per fleet member when rows carry a ``member`` tag).

    Accepts a solo run directory (``<run_dir>/metrics.jsonl``) or a fleet
    sweep directory (``<run_dir>/<member>/metrics.jsonl``, as either
    package's ``rl.sweep`` writes it): the member streams are merged and
    kept apart by their ``member`` field."""
    paths = [Path(run_dir) / METRICS_JSONL]
    if not paths[0].exists():
        paths = sorted(Path(run_dir).glob(f"*/{METRICS_JSONL}"))
    if not paths:
        raise FileNotFoundError(
            f"{Path(run_dir) / METRICS_JSONL}: no metric stream here (nor "
            f"any member subdir streams) — was the run configured with "
            f"the jsonl sink (ObsSpec(sinks=('jsonl',), log_dir=...))?")
    rows: Dict[tuple, dict] = {}
    for path in paths:
        for ln, line in enumerate(path.read_text().splitlines(), 1):
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: not valid JSONL: {e}") from e
            if not isinstance(row, dict) or "kind" not in row \
                    or "step" not in row:
                raise ValueError(
                    f"{path}:{ln}: row missing kind/step: {row!r}")
            member = row.get("member", path.parent.name
                             if path.parent != Path(run_dir) else None)
            rows[(row["kind"], row["step"], row.get("event"), member)] = row
    return sorted(rows.values(), key=lambda r: (r["step"], r["kind"]))


def _series(rows: List[dict], key: str) -> List[tuple]:
    return [(r["step"], r[key]) for r in rows
            if key in r and isinstance(r[key], (int, float))]


def _traj(series: List[tuple]) -> Optional[dict]:
    if not series:
        return None
    vals = [v for _, v in series]
    peak_step, peak = max(series, key=lambda sv: sv[1])
    return {"first": vals[0], "last": vals[-1], "max": peak,
            "max_step": peak_step, "n": len(vals)}


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _flag_spikes(series: List[tuple], key: str, out: List[dict]) -> None:
    finite = [(s, v) for s, v in series if math.isfinite(v)]
    for s, v in series:
        if not math.isfinite(v):
            out.append({"step": s, "metric": key, "value": v,
                        "why": "non-finite"})
    if len(finite) < 4:
        return
    med = _median([abs(v) for _, v in finite])
    if med <= 0:
        return
    for s, v in finite:
        if abs(v) > SPIKE_FACTOR * med:
            out.append({"step": s, "metric": key, "value": v,
                        "why": f"spike >{SPIKE_FACTOR:.0f}x median "
                               f"({med:.3g})"})


def summarize(rows: List[dict]) -> dict:
    train = [r for r in rows if r["kind"] == "train"]
    evals = [r for r in rows if r["kind"] == "eval"]
    events = [r for r in rows if r["kind"] == "event"]
    chunks = [r for r in events if r.get("event") == "chunk"]
    runs = [r for r in events if r.get("event") == "run"]
    sranks = _series([r for r in events if r.get("event") == "srank"],
                     "srank")

    # throughput from chunk timing events (scan driver), else run summaries
    timing = chunks or runs
    steps = sum(r.get("steps", 0) for r in timing)
    wall = sum(r.get("wall_s", 0.0) for r in timing)
    throughput = {"steps": int(steps), "wall_s": wall,
                  "steps_per_sec": steps / wall if wall > 0 else None,
                  "chunks": len(chunks)}

    metric_keys = sorted({k for r in train for k in r if k not in
                          _NON_METRIC})
    grad_norms = {k: _traj(_series(train, k)) for k in metric_keys
                  if k.startswith("grad_norm_")}
    ratios = {k: _traj(_series(train, k)) for k in metric_keys
              if k.startswith("update_ratio_")}
    staleness = {k: _traj(_series(train, k)) for k in metric_keys
                 if k.startswith("staleness_")}
    losses = {k: _traj(_series(train, k)) for k in metric_keys
              if k.endswith("_loss") or k == "td_error"}

    flags: List[dict] = []
    for k in list(grad_norms) + list(losses):
        _flag_spikes(_series(train, k), k, flags)
    for k in list(ratios):
        for s, v in _series(train, k):
            if not math.isfinite(v):
                flags.append({"step": s, "metric": k, "value": v,
                              "why": "non-finite"})
    if sranks:
        peak = max(v for _, v in sranks)
        if peak > 0 and sranks[-1][1] < SRANK_COLLAPSE * peak:
            flags.append({"step": sranks[-1][0], "metric": "srank",
                          "value": sranks[-1][1],
                          "why": f"srank collapse: final "
                                 f"{sranks[-1][1]:.0f} < "
                                 f"{SRANK_COLLAPSE:.0%} of peak {peak:.0f}"})
    flags.sort(key=lambda f: f["step"])

    eval_rets = _series(evals, "return")
    return {
        "counts": {"train": len(train), "eval": len(evals),
                   "event": len(events)},
        "steps": {"first": train[0]["step"] if train else None,
                  "last": train[-1]["step"] if train else None},
        "throughput": throughput,
        "grad_norms": grad_norms,
        "update_ratios": ratios,
        "staleness": staleness,
        "losses": losses,
        "srank": _traj(sranks),
        "eval": {"best_return": max((v for _, v in eval_rets),
                                    default=None),
                 "final_return": eval_rets[-1][1] if eval_rets else None,
                 "n": len(eval_rets)},
        "instability": flags,
    }


def _fmt_traj(t: Optional[dict]) -> str:
    if t is None:
        return "n/a"
    return (f"first {t['first']:11.4g}  last {t['last']:11.4g}  "
            f"peak {t['max']:11.4g} @ step {t['max_step']}")


def format_report(s: dict, run_dir: str) -> str:
    L = [f"run report: {run_dir}",
         f"  rows: {s['counts']['train']} train / {s['counts']['eval']} "
         f"eval / {s['counts']['event']} event "
         f"(steps {s['steps']['first']}..{s['steps']['last']})"]
    tp = s["throughput"]
    if tp["steps_per_sec"] is not None:
        L.append(f"  throughput: {tp['steps_per_sec']:.0f} steps/s "
                 f"({tp['steps']} steps / {tp['wall_s']:.2f}s over "
                 f"{tp['chunks']} chunks)")
    else:
        L.append("  throughput: n/a (no timing events)")
    for title, group in (("grad norms", s["grad_norms"]),
                         ("update/param ratios", s["update_ratios"]),
                         ("staleness", s["staleness"]),
                         ("losses", s["losses"])):
        L.append(f"  {title}:" + ("" if group else " n/a"))
        for k in sorted(group):
            L.append(f"    {k:<24} {_fmt_traj(group[k])}")
    L.append(f"  srank: {_fmt_traj(s['srank'])}")
    ev = s["eval"]
    if ev["n"]:
        L.append(f"  eval: best return {ev['best_return']:.1f}, final "
                 f"{ev['final_return']:.1f} over {ev['n']} points")
    if s["instability"]:
        L.append(f"  instability events ({len(s['instability'])}):")
        for f in s["instability"][:20]:
            L.append(f"    step {f['step']:>8}  {f['metric']:<20} "
                     f"= {f['value']:.4g}  [{f['why']}]")
        if len(s["instability"]) > 20:
            L.append(f"    ... and {len(s['instability']) - 20} more")
    else:
        L.append("  instability events: none")
    return "\n".join(L)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a run directory's metric stream "
                    "(metrics.jsonl).")
    ap.add_argument("run_dir", help="directory holding metrics.jsonl "
                                    "(ObsSpec.log_dir)")
    ap.add_argument("--json", action="store_true",
                    help="print the summary dict as JSON")
    args = ap.parse_args(argv)
    summary = summarize(load_rows(args.run_dir))
    if args.json:
        print(json.dumps(summary, indent=1, default=str))
    else:
        print(format_report(summary, args.run_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
