"""The readings the correctness limits are set from: for each seed, the
cell's set-up and its three checked supersteps (the same path as a run,
without the window), then each number for the system itself (the lower
reading), for the control (the reference in TF32 in the system's place)
and for each planted fault (half the batch, a state left unchanged, a
collected reward altered by 1, every sampled row shifted by one).

    python3 bench/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--variant-seeds <k>]

runs every variant on the card.
Prints one JSON line a seed and variant, and the worst of each number
over the seeds last. The benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from bench import harness, registry  # noqa: E402
from bench.reference import judge, sac_ref as ref  # noqa: E402

VARIANTS = {"sound": ref.SOUND, "control": ref.Variant(tf32=True),
            "half": ref.Variant(half_batch=True),
            "frozen": ref.Variant(frozen=True),
            "reward": ref.Variant(reward_shift=1.0),
            "sample": ref.Variant(sample_shift=1)}


def readings(cell_name: str, seeds, variants, device,
             bench_dir=registry.BENCH_DIR, variant_seeds: int = 0):
    """``{variant: [numbers of each seed]}``; variants other than
    ``sound`` on the first ``variant_seeds`` seeds only (0: all)."""
    cell = registry.workload(cell_name, bench_dir)
    config = registry.config(cell["config"], bench_dir)
    rcfg = ref.RefConfig.from_files(config, cell)
    if device.type == "cuda":
        harness.build_libraries(cell.get("libraries", []))
    out = {v: [] for v in variants}
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        drv, outs = harness.set_up(config, cell, seed, device)
        seeds = drv.seeds
        del drv
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        starts = ref.init_starts(rcfg, seeds, device)
        for v in variants:
            if v != "sound" and variant_seeds and i >= variant_seeds:
                continue
            nums = judge.judge(starts, outs, rcfg, device, VARIANTS[v])
            out[v].append(nums)
            print(json.dumps({"cell": cell_name, "seed": seed, "variant": v,
                              **nums, "s": time.perf_counter() - t0}),
                  flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant-seeds", type=int, default=0)
    a = ap.parse_args(argv)
    got = readings(a.workload, a.seeds, list(VARIANTS),
                   torch.device("cuda"), variant_seeds=a.variant_seeds)
    for v, rows in got.items():
        if not rows:
            continue
        print(json.dumps({"cell": a.workload, "variant": v, "worst": {
            k: max(r[k] for r in rows) for k in judge.NUMBERS},
            "least": {k: min(r[k] for r in rows) for k in judge.NUMBERS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
