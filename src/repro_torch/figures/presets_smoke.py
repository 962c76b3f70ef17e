"""Preset-registry smoke (port of ``benchmarks/presets_smoke.py``): every
paper scenario builds its ``Experiment`` (the ``Trainer`` and its replay)
on the device without running a step, and its spec round-trips through
``to_dict``. One row a preset (the build's wall time). On the card this
builds ``rl-distributed`` and ``fleet-smoke`` as shipped: the device
replay with the default ``replay.kernel="xla"``."""
from __future__ import annotations

import time

from repro_torch import DeviceLike, resolve_device
from repro_torch.rl import presets
from repro_torch.rl.experiment import Experiment


def run(scale: str = "quick", *, device: DeviceLike = None):
    device = resolve_device(device)
    rows = []
    for name in presets.names():
        t0 = time.time()
        spec = presets.get(name)
        exp = Experiment.from_spec(spec, device=device)
        if exp.step != 0 or exp._ls is not None:
            raise RuntimeError(f"preset {name}: building ran a step")
        if type(spec).from_dict(spec.to_dict()) != spec:
            raise RuntimeError(f"preset {name}: the spec does not "
                               f"round-trip through to_dict")
        rows.append({"name": f"preset_build_{name}",
                     "us_per_call": 1e6 * (time.time() - t0),
                     "derived": spec.execution.loop,
                     "env": spec.env, "algo": spec.algo})
    return rows


if __name__ == "__main__":
    from repro_torch.figures.common import print_rows
    print_rows(run())
