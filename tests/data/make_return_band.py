"""Make ``return_band.json``: the JAX package's return curves for the
return-band check of the PyTorch port (``tests/test_torch_return_band.py``,
``chip_smoke.py``'s ``phase_band``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/data/make_return_band.py

Runs ``BAND_PRESET`` with ``BAND_OVERRIDE`` (a budget override only) for
each of ``BAND_SEEDS`` through ``repro.rl.experiment.Experiment`` on the
CPU, one process a seed, and records every eval point's return. It also
records an untrained agent's returns: the same spec's policy after the
warm-up, with no update, evaluated once per eval point (each eval its own
key). Takes about a minute and a half on 5 cores.
"""
import json
import os
import sys
from concurrent.futures import ProcessPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from return_band import BAND_OVERRIDE, BAND_PRESET, BAND_SEEDS  # noqa: E402


def one_seed(seed: int):
    import jax
    from repro.rl import presets
    from repro.rl.experiment import Experiment
    spec = presets.get(BAND_PRESET).override(seed=seed, **BAND_OVERRIDE)
    exp = Experiment.from_spec(spec)
    exp._ensure_init()
    params = exp._ls.agent["params"]
    n = spec.execution.total_steps // spec.eval.every
    untrained = [float(jax.numpy.mean(exp.trainer.eval_j(
        params, jax.random.fold_in(jax.random.key(seed), t))))
        for t in range(n)]
    res = exp.run()
    return res.eval_steps, [float(r) for r in res.returns], untrained


def main() -> None:
    with ProcessPoolExecutor(len(BAND_SEEDS)) as pool:
        runs = list(pool.map(one_seed, BAND_SEEDS))
    steps = runs[0][0]
    assert all(r[0] == steps for r in runs)
    out = {"preset": BAND_PRESET, "override": BAND_OVERRIDE,
           "seeds": list(BAND_SEEDS), "eval_steps": steps,
           "returns": [r[1] for r in runs],
           "untrained": [r[2] for r in runs],
           "source": "repro.rl.experiment.Experiment (the JAX package) on "
                     "the CPU, made by tests/data/make_return_band.py"}
    with open(os.path.join(HERE, "return_band.json"), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
