"""Finds every piece of the benchmark by its name: ``BENCHMARK.json`` at
the checkout's root, ``configs/<config>.json``, ``workloads/<cell>.json``,
and the readers ``end_to_end/<metric>.py`` and
``layer_metrics/<metric>.py``. A new cell, configuration or metric is a
new file; nothing here lists them."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    cell = json.loads((Path(bench_dir) / "workloads" / f"{name}.json")
                      .read_text())
    cell["name"] = name
    return cell


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((Path(bench_dir) / "configs" / f"{name}.json")
                      .read_text())


def reader(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module ``<kind>/<name>.py`` (a metric's reader)."""
    path = Path(bench_dir) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str) -> Dict[str, List[dict]]:
    """``{"end_to_end": [...], "per_layer": [...]}``: the metrics that
    ``cell`` reports: an end-to-end metric in the cells its ``workloads``
    lists (every cell without the key), a per-layer metric in the cells
    its ``workloads`` lists."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    layer = [m for m in bench["per_layer"] if cell in m["workloads"]]
    return {"end_to_end": e2e, "per_layer": layer}
