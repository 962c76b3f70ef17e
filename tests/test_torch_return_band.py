"""Whole training runs held statistically (ROADMAP A.11).

The band is the JAX package's return curves of one host-replay preset
(``table1-orig`` at a budget that learns pendulum, 5 seeds, every eval
point), committed as ``tests/data/return_band.json`` by
``tests/data/make_return_band.py``. The rule, in
``tests/data/return_band.py``: each seed's curve is summed up by its mean
over the second half of the eval points; the port's 5 late means and the
reference's 5 must not differ by more than ``Z_MAX`` = 3 standard errors
of the difference (a two-sample z). Seeds are not matched across the
packages: only these statistics are compared.

The port's 5 runs take 10,000 supersteps each: about 8 minutes on a
CPU core (~10 ms a superstep), so they are held on the card, where the two
graphs of a host superstep run them in about a minute
(``chip_smoke.py`` ``phase_band``, and the card-gated test here). On the
CPU: the data is the reference's 5 seeds at every eval point, the band's
spec is the same in both packages, and the rule is not vacuous: it fails
for an untrained agent, the reference's and the port's.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.rl import presets
from repro_torch.rl.envs import eval_returns
from repro_torch.rl.experiment import Experiment

_DATA = Path(__file__).resolve().parent / "data"


def _band_module():
    spec = importlib.util.spec_from_file_location(
        "return_band", _DATA / "return_band.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rb = _band_module()


def _spec(seed):
    return presets.get(rb.BAND_PRESET).override(seed=seed,
                                                **rb.BAND_OVERRIDE)


def test_band_is_the_references_five_seeds_at_every_eval_point():
    band = rb.load()
    assert band["preset"] == rb.BAND_PRESET
    assert band["override"] == rb.BAND_OVERRIDE
    assert set(band["override"]) <= {"total_steps", "eval_every", "loop"}
    assert band["seeds"] == list(rb.BAND_SEEDS)
    every, total = rb.BAND_OVERRIDE["eval_every"], \
        rb.BAND_OVERRIDE["total_steps"]
    assert rb.eval_steps(band) == list(range(every, total + 1, every))
    for key in ("returns", "untrained"):
        r = np.asarray(band[key])
        assert r.shape == (5, total // every) and np.isfinite(r).all()
    spec = presets.get(rb.BAND_PRESET)
    assert spec.replay.backend == "host" and not spec.execution.distributed
    # the reference learned: its late means all above the untrained's
    assert rb.late_means(band["returns"]).min() \
        > rb.late_means(band["untrained"]).max()


def test_band_spec_is_the_same_in_both_packages():
    from repro.rl import presets as jpresets
    for seed in rb.BAND_SEEDS:
        ours = _spec(seed).to_dict()
        ref = jpresets.get(rb.BAND_PRESET).override(
            seed=seed, **rb.BAND_OVERRIDE).to_dict()
        assert ours == ref


def test_rule_passes_the_reference_and_fails_untrained_agents():
    band = rb.load()
    own = rb.check(band["returns"], band)
    assert own["ok"] and own["z"] == 0.0
    ref_untrained = rb.check(band["untrained"], band)
    assert not ref_untrained["ok"] and ref_untrained["z"] > 2 * rb.Z_MAX
    # the port's untrained agents: each seed's policy after the warm-up,
    # evaluated once per eval point, on the CPU
    untrained = []
    for seed in rb.BAND_SEEDS:
        exp = Experiment.from_spec(_spec(seed), device="cpu")
        exp._ensure_init()
        pol, gen = exp.trainer.policy(exp._ls.agent["params"]), \
            torch.Generator().manual_seed(10_000 + seed)
        untrained.append([float(eval_returns(
            exp.trainer.env, pol, exp.spec.eval.episodes, gen).mean())
            for _ in band["eval_steps"]])
    got = rb.check(untrained, band)
    assert not got["ok"] and got["z"] > 2 * rb.Z_MAX
    # one curve a seed at the band's eval points, or the rule refuses
    with pytest.raises(ValueError):
        rb.check(untrained[:4], band)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: 5 runs of 10,000 supersteps")
    return torch.device("cuda")


def test_port_curves_hold_the_band_on_the_card(cuda_device):
    band = rb.load()
    curves = []
    for seed in band["seeds"]:
        res = Experiment.from_spec(_spec(seed), device=cuda_device).run()
        assert res.eval_steps == rb.eval_steps(band)
        curves.append(res.returns)
    got = rb.check(curves, band)
    assert got["ok"], got
