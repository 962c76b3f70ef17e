"""The return-band check of whole training runs (ROADMAP A.11): the
reference's curves (``return_band.json``, made by
``make_return_band.py``) and the rule a port's curves are held to.
NumPy only: ``chip_smoke.py`` loads it on the card, and the CPU tests.

The rule. Each seed's curve is summed up by its late mean: the mean of
its returns at the eval points of the run's second half. The port's 5
late means and the reference's 5 are compared as two samples: with
means m_p, m_r and sample standard deviations s_p, s_r,

    z = |m_p - m_r| / sqrt(s_p**2 / n_p + s_r**2 / n_r)

and the port passes when z <= ``Z_MAX``. Seeds are not matched across
the packages (their random streams differ), so only these statistics
are compared. The rule is not vacuous: an untrained agent's returns
(``untrained`` in the data) fail it.
"""
import json
import os
from typing import Dict, List, Sequence

import numpy as np

BAND_PRESET = "table1-orig"
# a budget override only: table1-orig's one actor and batch 128 learn
# pendulum within it (its quick budget of 500 steps does not)
BAND_OVERRIDE = {"total_steps": 10_000, "eval_every": 500,
                 "loop": "scan"}
BAND_SEEDS = (0, 1, 2, 3, 4)
Z_MAX = 3.0
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "return_band.json")


def load(path: str = PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def late_means(returns: Sequence[Sequence[float]]) -> np.ndarray:
    """Each curve's mean over the eval points of its second half."""
    r = np.asarray(returns, np.float64)
    return r[:, r.shape[1] // 2:].mean(axis=1)


def z_score(port: Sequence[Sequence[float]],
            ref: Sequence[Sequence[float]]) -> float:
    a, b = late_means(port), late_means(ref)
    se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
    return float(abs(a.mean() - b.mean()) / se)


def check(port: Sequence[Sequence[float]], band: dict) -> Dict[str, float]:
    """The rule's numbers for ``port`` (one curve a seed, at the band's
    eval points); ``ok`` when it passes."""
    port = np.asarray(port, np.float64)
    if port.shape != np.asarray(band["returns"]).shape:
        raise ValueError(f"curves {port.shape}, the band's "
                         f"{np.asarray(band['returns']).shape}")
    z = z_score(port, band["returns"])
    return {"z": z, "ok": z <= Z_MAX,
            "port_late_mean": float(late_means(port).mean()),
            "ref_late_mean": float(late_means(band["returns"]).mean())}


def eval_steps(band: dict) -> List[int]:
    return [int(s) for s in band["eval_steps"]]
