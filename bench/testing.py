"""A small copy of the benchmark for the CPU tests: every cell and reader
as they are, the configurations cut to a width and replay a test run can
hold (the same connectivities, depths and algorithm), the windows and
fleets shortened."""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from bench import harness, registry

SMALL = {"network.num_units": 16, "ofenet.num_units": 8,
         "ofenet.num_layers": 2, "replay.capacity": 512,
         "execution.warmup_steps": 64, "execution.batch_size": 32}


def small_bench(dst: Path, members: int = 2) -> Path:
    """``dst`` laid out as ``bench/``: the cells with fleets of
    ``members`` and calls of 2 supersteps, the configurations at
    ``SMALL`` sizes with 4 actors where the spec has an actor pool."""
    src = registry.BENCH_DIR
    dst = Path(dst)
    for sub in ("end_to_end", "layer_metrics"):
        shutil.copytree(src / sub, dst / sub)
    (dst / "workloads").mkdir()
    for f in (src / "workloads").glob("*.json"):
        cell = json.loads(f.read_text())
        cell.update(call_steps=2, profile_steps=2)
        if cell["kind"] == "fleet":
            cell["members"] = members
        (dst / "workloads" / f.name).write_text(json.dumps(cell))
    (dst / "configs").mkdir()
    for f in (src / "configs").glob("*.json"):
        config = json.loads(f.read_text())
        spec = config["spec"]
        for path, value in SMALL.items():
            section, key = path.split(".")
            spec[section][key] = value
        if spec["execution"]["distributed"]:
            spec["execution"].update(n_core=1, n_env=4)
        (dst / "configs" / f.name).write_text(json.dumps(config))
    return dst


def run_small(bench_dir: Path, cell: str, seed: int = 2147483661,
              trace: int = 0, seconds: float = 0.2,
              bench: Optional[dict] = None) -> Dict[str, Any]:
    """One run of ``cell`` on the CPU, as ``bench/run.py`` would make it
    but for the look for a card; returns ``harness.run_cell``'s dict."""
    args = harness.parse(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)])
    return harness.run_cell(args, time.perf_counter(), torch.device("cpu"),
                            bench or registry.benchmark(), Path(bench_dir))


def with_limits(result: Dict[str, Any], cell: str,
                limits: Optional[Dict[str, float]] = None) -> bool:
    """Whether ``result``'s numbers are all within the real cell's
    limits (the run's own ``correct``, but against ``limits`` when
    given)."""
    limits = limits or registry.workload(cell)["limits"]
    return all(result["numbers"][k] <= v for k, v in limits.items())
