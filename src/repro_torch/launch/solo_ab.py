"""The solo training superstep of two checkouts of the port on one card.

    python src/repro_torch/launch/solo_ab.py <other checkout>

Run from the root of one checkout ("change") with the path of another
("parent", e.g. a ``git archive`` of the commit before). It builds both
checkouts' stack and tree kernels at once, compares the machine code
(``cuobjdump -sass``) of every kernel of the two stack libraries by name,
then runs the training cell's solo SAC superstep under the graph
(``fig10-ablation``, 2048 units, fused blocks, the device replay) in one
process a checkout, in turns (parent, change, change, parent). Each
process prints its launches at the warm-up and the capture (forward,
stream^T, backward), its wall per replay (host clock, 7 runs of 40
replays), its device time per replay (CUDA events, the card held busy)
and its device time by kernel (``torch.profiler``, 20 replays). The last
line is one JSON object of those numbers.

``--graph`` runs one such process on the ``repro_torch`` its path gives.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

_BUILD = ("import threading; from repro_torch.kernels.dense_block import "
          "stack; from repro_torch.kernels.replay_tree import ops; "
          "th = [threading.Thread(target=f) for f in (stack._library, "
          "stack._bwd_library, ops.library)]; [t.start() for t in th]; "
          "[t.join() for t in th]")


def graph(tag: str) -> dict:
    """The solo superstep under the graph of the imported checkout."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.dense_block import stack
    from repro_torch.rl import presets
    from repro_torch.rl.experiment import Experiment
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = presets.get("fig10-ablation").override(
        total_steps=1_000_000, warmup_steps=10_000, num_units=2048,
        block_backend="fused", replay_backend="device", loop="scan")
    exp = Experiment.from_spec(spec)
    stack.reset_launch_count()
    exp.run(1)
    torch.cuda.synchronize()
    launches = [stack.launch_count(), stack.transpose_count(),
                stack.bwd_launch_count()]
    g = exp.trainer.graph
    walls, events = [], []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.replay(40)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0) / 40)
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4e7))
        start.record()
        g.replay(20)
        end.record()
        torch.cuda.synchronize()
        events.append(start.elapsed_time(end) / 20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.replay(20)
        torch.cuda.synchronize()
    by_kernel: dict = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = re.sub(r"\(anonymous namespace\)::", "", ev.key)
        name = re.sub(r"^void ", "", name).split("(")[0][:70]
        ms, n = by_kernel.get(name, (0.0, 0.0))
        by_kernel[name] = (ms + ev.self_device_time_total / 20 / 1e3,
                           n + ev.count / 20)
    out = dict(tag=tag, launches=launches, wall_ms=float(np.median(walls)),
               walls=walls, events_ms=float(np.median(events)),
               by_kernel=by_kernel)
    print(f"[solo-ab] {tag}: launches at warm-up + capture (fwd, stream^T, "
          f"bwd) {launches}; wall per replay {out['wall_ms']:.4f} ms ("
          + ", ".join(f"{w:.3f}" for w in walls) + f"); device "
          f"{out['events_ms']:.4f} ms", flush=True)
    for name, (ms, n) in sorted(by_kernel.items(),
                                key=lambda kv: -kv[1][0])[:12]:
        print(f"[solo-ab] {tag}   {ms:.4f} ms {n:5.1f}x {name}", flush=True)
    return out


def _sass(path: str) -> dict:
    """``{kernel: [instructions]}`` of a library (``cuobjdump -sass``)."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin" / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", path],
                          capture_output=True, text=True, check=True).stdout
    funcs: dict = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            # an anonymous namespace's name carries a hash of the build
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__",
                          m.group(1))
            funcs[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            funcs[name].append(" ".join(line.split()))
    return funcs


def sass_diff(parent: str) -> dict:
    """Per stack library: the parent's kernels whose machine code is the
    same in this checkout, differs, or is missing, and the kernels only
    this checkout has."""
    out = {}
    for lib in ("dense_stack_fwd", "dense_stack_bwd"):
        new = _sass(glob.glob(f"build/kernels/lib{lib}-*.so")[0])
        old = _sass(glob.glob(f"{parent}/build/kernels/lib{lib}-*.so")[0])
        rec = dict(same=[n for n in old if new.get(n) == old[n]],
                   different=[n for n in old if n in new
                              and new[n] != old[n]],
                   missing=[n for n in old if n not in new],
                   added=[n for n in new if n not in old])
        out[lib] = {k: len(v) for k, v in rec.items()}
        out[lib]["different_names"] = rec["different"] + rec["missing"]
        print(f"[solo-ab] sass {lib}: parent kernels {len(old)}: "
              f"{len(rec['same'])} the same in this checkout, "
              f"{len(rec['different'])} different, {len(rec['missing'])} "
              f"missing; {len(rec['added'])} kernels only here", flush=True)
        for n in out[lib]["different_names"]:
            print(f"[solo-ab]   not the same: {n}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", nargs="?", help="the other checkout's root")
    ap.add_argument("--graph", metavar="TAG",
                    help="one solo-superstep process of the checkout on "
                         "the path, printing its numbers under TAG")
    args = ap.parse_args()
    if args.graph:
        print(json.dumps(graph(args.graph)), flush=True)
        return
    parent = os.path.abspath(args.parent)
    roots = {"parent": parent, "change": os.getcwd()}
    env = {k: dict(os.environ, PYTHONPATH=os.path.join(r, "src"))
           for k, r in roots.items()}
    builds = [subprocess.Popen([sys.executable, "-c", _BUILD], cwd=r,
                               env=env[k]) for k, r in roots.items()]
    if any([p.wait() for p in builds]):
        raise RuntimeError("a checkout's kernels did not build")
    result = {"sass": sass_diff(parent), "runs": []}
    for tag in ("parent", "change", "change", "parent"):
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--graph", tag], env=env[tag], check=True,
                             capture_output=True, text=True)
        lines = run.stdout.strip().splitlines()
        print("\n".join(lines[:-1]), flush=True)
        result["runs"].append(json.loads(lines[-1]))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
