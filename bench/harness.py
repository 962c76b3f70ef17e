"""One run of one cell: set-up, a measured window, with ``--trace 1`` a
profiled sub-window and the per-layer readers, then the comparison with
the plain reference, and one line of JSON.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``) runs from the process's start to the first timed
superstep: imports, the cell's kernel libraries (built in parallel
threads the first time, loaded from ``build/kernels/`` after), the
start that the reference makes from the seed (weights and the replay's
warm-up, on the device) handed to the system, the system's first three
supersteps through the timed path (the first captures the CUDA graph;
the comparison judges these three), and the epilogue's first call. The
window is whole ``run`` calls of ``call_steps`` supersteps until
``--seconds`` have passed, ended by a synchronize: all of its work over
all of its time.

With ``--trace 1`` two short captures follow the window: one of the
device (``torch.profiler`` with CUDA activity, started once) over
``profile_steps`` supersteps, then over the calls that the per-layer
readers' ``probes`` ask to have timed; and one of the host alone over
``profile_steps`` more, whose program spans are not slowed by the device
tracing.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import torch

from bench import drive, registry
from bench import trace as tr
from bench.reference import judge
from bench.reference import sac_ref as ref

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROBE_REPS = 10


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def build_libraries(names: List[str]) -> None:
    """Load (the first time: build) the cell's kernel libraries, each
    ``module:function``, all at once in threads."""
    import importlib
    errors: List[Exception] = []

    def load(ref: str) -> None:
        mod, fn = ref.split(":")
        try:
            getattr(importlib.import_module(mod), fn)()
        except Exception as e:               # re-raised below
            errors.append(e)
    threads = [threading.Thread(target=load, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Phases:
    """Seconds of each set-up phase, for the run's standard error."""

    def __init__(self, device: torch.device):
        self.device, self.t, self.spent = device, time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.spent[name] = now - self.t
        self.t = now


def set_up(config: dict, cell: dict, seed: int, device: torch.device,
           phase=None):
    """The system built, handed the reference's start, and its first
    ``judge.STEPS`` supersteps through the timed path with what they
    produced: ``(driver, outputs)``. The start is dropped once handed
    over, and the device's peak counted from there."""
    phase = phase or (lambda name: None)
    drv = drive.make(config, cell, seed, device)
    starts = ref.init_starts(ref.RefConfig.from_files(config, cell),
                             drv.seeds, device)
    phase("start")
    drv.load(starts)
    ptr0 = [s["ptr"] for s in starts]
    del starts
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    phase("load")
    steps, grads = [], None
    for k in range(judge.STEPS):
        steps.append(drv.check_step())
        if k == 0:
            grads = drv.grads()
        phase(f"checked_step_{k + 1}")
    finals = drv.finals(ptr0)
    phase("finals")
    outs = [{"steps": [s[m] for s in steps], "grad1": grads[m], **finals[m]}
            for m in range(drv.members)]
    return drv, outs


def window(drv, seconds: float, call_steps: int) -> Dict[str, float]:
    sync(drv.device)
    t0 = time.perf_counter()
    steps = 0
    while True:
        drv.run(call_steps)
        steps += call_steps
        if time.perf_counter() - t0 >= seconds:
            break
    sync(drv.device)
    wall = time.perf_counter() - t0
    return {"supersteps": steps, "updates": steps * drv.members,
            "wall_s": wall}


def probes(ctx, readers: Dict[str, Any]) -> Dict[str, Dict[str, dict]]:
    """``{metric: {key: {"fn", "least_s", "calls"}}}``: the calls that the
    readers with ``probes`` want timed on the device trace, each called
    once here, before the capture, to warm it."""
    out = {}
    for name, mod in readers.items():
        got = mod.probes(ctx) if hasattr(mod, "probes") else None
        if got:
            out[name] = got
            for p in got.values():
                p["fn"]()
    sync(ctx.device)
    return out


def probed(calls: Dict[str, Dict[str, dict]], metric: str,
           profile: dict) -> Dict[str, dict]:
    """``{key: {"least_s", "calls", "device_s"}}`` of ``metric``'s probes:
    ``device_s`` the device's busy seconds a call in the capture (None
    where it saw no operation)."""
    return {k: {"least_s": p["least_s"], "calls": p["calls"],
                "device_s": profile["probes"].get(f"{metric}/{k}")}
            for k, p in calls.get(metric, {}).items()}


def profiled(drv, steps: int, calls: Dict[str, Dict[str, dict]],
             device: bool) -> dict:
    """One ``torch.profiler`` capture of ``steps`` supersteps, then of
    ``PROBE_REPS`` of each probe's call, each in a span of its own between
    synchronizes; of the card too with ``device`` (one such capture a
    process: the profiler drops device events after many), else of the
    host alone, whose spans the device tracing then does not slow."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device and drv.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(drv.device)
    with profile(activities=acts) as prof:
        with record_function(tr.WINDOW):
            t0 = time.perf_counter()
            drv.run(steps)
            sync(drv.device)
            wall = time.perf_counter() - t0
        for metric, got in calls.items():
            for key, p in got.items():
                with record_function(f"{tr.PROBE}{metric}/{key}"):
                    for _ in range(PROBE_REPS):
                        p["fn"]()
                    sync(drv.device)
    return tr.read(prof, wall, steps, PROBE_REPS)


def run_cell(args: argparse.Namespace, t0: float, device: torch.device,
             bench: dict, bench_dir: Path = registry.BENCH_DIR) -> dict:
    """Everything but the printing: ``{"result": line, "checks": [...]}``."""
    cell = registry.workload(args.workload, bench_dir)
    config = registry.config(cell["config"], bench_dir)
    metrics = registry.cell_metrics(bench, cell["name"])
    phase = Phases(device)
    phase.spent["imports"] = phase.t - t0
    if device.type == "cuda":
        build_libraries(cell.get("libraries", []))
    phase("libraries")
    drv, outs = set_up(config, cell, args.seed, device, phase)
    drv.warm_epilogue()
    phase("epilogue")
    setup_s = time.perf_counter() - t0
    win = window(drv, args.seconds, int(cell["call_steps"]))
    ctx = SimpleNamespace(cell=cell, config=config, device=device,
                          driver=drv, window=win, setup_s=setup_s,
                          profile=None, host_profile=None, probed={})
    out: Dict[str, Any] = {}
    if args.trace:
        readers = {m["name"]: registry.reader("layer_metrics", m["name"],
                                              bench_dir)
                   for m in metrics["per_layer"]}
        calls = probes(ctx, readers)
        steps = int(cell["profile_steps"])
        ctx.profile = profiled(drv, steps, calls, device=True)
        ctx.host_profile = profiled(drv, steps, {}, device=False)
        for m in metrics["per_layer"]:
            ctx.probed = probed(calls, m["name"], ctx.profile)
            value = readers[m["name"]].read(ctx)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        del calls
    else:
        for m in metrics["end_to_end"]:
            value = registry.reader("end_to_end", m["name"],
                                    bench_dir).read(ctx)
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_line: Dict[str, Any] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": int(cell["chips"]),
        "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                              if device.type == "cuda" else 0)}
    if args.trace:
        dev_line.update(busy_s=ctx.profile["busy_s"],
                        window_s=ctx.profile["window_s"])
    failed = sum(win["supersteps"] for ok in drv.finite() if not ok)
    brk = tr.breakdown(ctx.profile) if args.trace else None
    seeds = drv.seeds
    rcfg = ref.RefConfig.from_files(config, cell)
    del drv, ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge.judge(ref.init_starts(rcfg, seeds, device), outs, rcfg,
                          device)
    limits = cell.get("limits", {})
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    result = {"correct": correct, "attempted": win["updates"],
              "failed": failed, "metrics": out, "device": dev_line}
    if brk is not None:
        result["breakdown"] = brk
    return {"result": result, "checks": checks, "numbers": numbers,
            "setup": phase.spent}


def main(argv: List[str], t0: float, bench_dir: Path = registry.BENCH_DIR,
         root: Path = registry.ROOT, device: Optional[str] = None) -> int:
    args = parse(argv)
    bench = registry.benchmark(root)
    cell = registry.workload(args.workload, bench_dir)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(cell["chips"]):
            print(f"bench: the cell needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
    got = run_cell(args, t0, torch.device(device), bench, bench_dir)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    result, checks = got["result"], got["checks"]
    result["checks"] = checks
    for k, v in got["setup"].items():
        print(f"setup {k} {v!r} s", file=sys.stderr)
    for k, v in got["numbers"].items():
        if k not in checks:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
