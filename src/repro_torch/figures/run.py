"""The figure harness (port of ``benchmarks/run.py``): one module a paper
table or figure, and the kernel micro-benchmark.

    python -m repro_torch.figures.run [--scale quick|paper] [--only fig5]
        [--smoke] [--device cpu]

Prints ``name,us_per_call,derived`` CSV and merges the full rows into
``experiments/torch_bench_results.json`` (``--smoke``:
``experiments/torch_bench_smoke.json``) under the working directory: a
row replaces the stored row of its name and the others stay, so
``--only`` reruns drop nothing. Every stored row carries a ``host``
fingerprint (platform, CPUs, Python, torch and its CUDA, the device and,
on the card, ``nvidia-smi``'s name and power limit) and ``recorded_at``.

``--smoke`` builds every preset on the device (``presets_smoke``), then
runs the kernel micro-benchmark; a failure there is fatal, where the full
run prints an ``ERROR`` row and goes on.
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import platform
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

from repro_torch import DeviceLike, resolve_device

KERNELS_MICRO = "repro_torch.launch.kernels_micro"

MODULES = [
    "repro_torch.figures.presets_smoke",
    "repro_torch.figures.fig1_depth",
    "repro_torch.figures.fig3_width",
    "repro_torch.figures.fig4_grid",
    "repro_torch.figures.fig5_connectivity",
    "repro_torch.figures.fig6_ofenet",
    "repro_torch.figures.fig8_distributed",
    "repro_torch.figures.fig10_ablation",
    "repro_torch.figures.fig13_activation",
    "repro_torch.figures.table1_final",
    "repro_torch.figures.loss_landscape_bench",
    KERNELS_MICRO,
]

SMOKE_MODULES = ["repro_torch.figures.presets_smoke", KERNELS_MICRO]


def card_line() -> str:
    """``nvidia-smi``'s ``name, power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def host_fingerprint(device: DeviceLike = None) -> Dict:
    """The box and build a row was measured on (stamped into every row)."""
    dev = resolve_device(device)
    fp = {"platform": platform.platform(),
          "machine": platform.machine(),
          "cpus": os.cpu_count(),
          "python": platform.python_version(),
          "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": str(dev)}
    if dev.type == "cuda":
        fp["device_name"] = torch.cuda.get_device_name(dev)
        fp["card"] = card_line()
    return fp


def merge_write(path: Path, rows: List[Dict]) -> None:
    """Replace same-name rows, keep the rest: ``--only`` reruns add."""
    existing = []
    if path.exists():
        try:
            existing = json.loads(path.read_text())
        except ValueError:
            existing = []
    new_names = {r["name"] for r in rows}
    merged = [r for r in existing if r.get("name") not in new_names] + rows
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(merged, indent=1, default=str))


def module_rows(mod_name: str, scale: str, device: DeviceLike) -> List[Dict]:
    mod = importlib.import_module(mod_name)
    if mod_name == KERNELS_MICRO:
        return mod.run(device)
    return mod.run(scale, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="quick", choices=["quick", "paper"])
    ap.add_argument("--only", default="")
    ap.add_argument("--smoke", action="store_true",
                    help="presets and the kernel micro-benchmark, failures "
                         "fatal")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when left out")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    mods = SMOKE_MODULES if args.smoke else MODULES
    if args.only:
        mods = [m for m in mods if args.only in m]
    scale = "smoke" if args.smoke else args.scale
    all_rows = []
    print("name,us_per_call,derived")
    for mod_name in mods:
        try:
            rows = module_rows(mod_name, scale, device)
        except Exception as e:  # the harness goes on to the next driver
            if args.smoke:
                raise
            print(f"{mod_name},0,ERROR:{type(e).__name__}:{e}")
            continue
        for r in rows:
            print(f"{r['name']},{r['us_per_call']:.0f},{r['derived']}")
        all_rows.extend(rows)
    stamp = {"host": host_fingerprint(device),
             "recorded_at": datetime.datetime.now(
                 datetime.timezone.utc).isoformat(timespec="seconds")}
    all_rows = [{**r, **stamp} for r in all_rows]
    out = Path("experiments/torch_bench_smoke.json" if args.smoke
               else "experiments/torch_bench_results.json")
    merge_write(out, all_rows)


if __name__ == "__main__":
    main()
