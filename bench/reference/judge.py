"""The comparison that decides a run's ``correct``.

Both sides start from one start that the reference makes from the seed
(``sac_ref.init_starts``), handed to the system at set-up. From it the
system runs its first three supersteps through its timed path;
``follow`` runs the reference's three from the same start with the same
draws, and ``compare`` turns the two sides' outputs into the numbers each
cell holds to a limit:

- ``loss_gap``: each step's critic, actor and OFENet losses, the gap as a
  share of the reference's magnitude of that loss (at least 1e-3): the
  loss itself, but for the actor's, whose per-row terms have either sign
  and may cancel, the mean magnitude of its terms;
- ``sample_gap``: how far a draw lies outside the row the system sampled
  for it, as a share of the total priority (1: a row the reference does
  not have there);
- ``replay_gap``: the sampled rows and their importance weights against
  the reference's, as a share of each field's largest value;
- ``prio_gap``: each step's refreshed priorities (|TD|), as a share of
  the reference's mean;
- ``grad_gap``: the first gradient as AdamW got it (its first moment after
  one step over 1 - b1), by the worst leaf: the gap between the two
  norms over the reference's norm of that leaf or the median leaf's,
  whichever is larger;
- ``change_gap``: the parameters' change over the three steps, by the
  worst leaf, measured as ``grad_gap``; a leaf whose reference gradient is
  under a thousandth of the median leaf's moves under Adam by rounding
  alone and is left out;
- ``collect_gap``: the rows the three collects wrote and the actors'
  observations after them.

A fleet's numbers are the worst over its members. Outputs are host
arrays: ``{"steps": [{"losses", "batch", "priorities"}] * 3, "grad1",
"params3", "store3", "obs3"}``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bench.reference import sac_ref as ref

STEPS = 3
LOSS_KEYS = ("critic_loss", "actor_loss", "aux_loss")
NUMBERS = ("loss_gap", "sample_gap", "replay_gap", "prio_gap", "grad_gap",
           "change_gap", "collect_gap")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def follow(S0: Dict[str, Any], cfg: ref.RefConfig, device,
           var: ref.Variant = ref.SOUND,
           sys_out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """``STEPS`` reference supersteps from ``S0``, in the outputs' layout
    (with ``var``: the control or a planted fault in the system's place).
    With ``sys_out`` the sampler judges the system's rows (``sample_gap``)
    and takes a row that a float32 tie put on the other side."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = ref.start_state(S0, cfg, torch.device(device))
    ptr0 = st.ptr
    steps, grad1 = [], None
    for k in range(STEPS):
        sb = None
        if sys_out is not None:
            sb = {f: torch.as_tensor(v, device=st.prio.device)
                  for f, v in sys_out["steps"][k]["batch"].items()}
        o = ref.superstep(st, cfg, var, sb)
        steps.append({"losses": o["losses"], "scales": o["scales"],
                      "batch": {f: _np(v) for f, v in o["batch"].items()},
                      "priorities": _np(o["priorities"]),
                      "sample_gap": o["sample_gap"]})
        if k == 0:
            grad1 = {ref.opt_param_path(p): _np(v) / (1.0 - cfg.b1)
                     for p, v in st.O.items() if ref.opt_param_path(p)}
    n = STEPS * cfg.n_actors
    rows = (ptr0 + np.arange(n)) % cfg.capacity
    return {"steps": steps, "grad1": grad1,
            "params3": {p: _np(v) for p, v in st.P.items()},
            "store3": {f: _np(v)[rows] for f, v in st.data.items()},
            "obs3": _np(ref.pendulum_obs(st.q, st.qd))}


def _leaf_gap(sys: Dict[str, np.ndarray], rf: Dict[str, np.ndarray],
              keep: Optional[List[str]] = None) -> float:
    norms = {p: float(np.linalg.norm(v.astype(np.float64)))
             for p, v in rf.items()}
    paths = keep if keep is not None else sorted(rf)
    med = float(np.median([norms[p] for p in paths])) if paths else 0.0
    worst = 0.0
    for p in paths:
        if p not in sys:
            return 1.0
        s = float(np.linalg.norm(np.asarray(sys[p], np.float64)))
        denom = max(norms[p], med)
        if denom == 0.0:
            continue
        worst = max(worst, abs(s - norms[p]) / denom)
    return worst if math.isfinite(worst) else 1.0


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1.0


def compare(sys: Dict[str, Any], rf: Dict[str, Any],
            params0: Dict[str, np.ndarray]) -> Dict[str, float]:
    """One member's numbers, from the start's params ``params0``; larger
    is worse."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for k in range(STEPS):
        s, r = sys["steps"][k], rf["steps"][k]
        for key in LOSS_KEYS:
            if key in r["losses"]:
                a, b = s["losses"].get(key, float("nan")), r["losses"][key]
                out["loss_gap"] = max(out["loss_gap"], _finite(
                    abs(a - b) / max(r["scales"][key], 1e-3)))
        out["sample_gap"] = max(out["sample_gap"], r.get("sample_gap", 0.0))
        for f, rv in r["batch"].items():
            sv = np.asarray(s["batch"][f], np.float64).reshape(rv.shape)
            scale = max(float(np.abs(rv).max()), 1e-6)
            out["replay_gap"] = max(out["replay_gap"], _finite(
                float(np.abs(sv - rv).max()) / scale))
        sp, rp = np.asarray(s["priorities"], np.float64), r["priorities"]
        out["prio_gap"] = max(out["prio_gap"], _finite(
            float(np.abs(sp - rp).max()) / max(float(rp.mean()), 1e-6)))
    out["grad_gap"] = _leaf_gap(sys["grad1"], rf["grad1"])
    gnorm = {p: float(np.linalg.norm(v)) for p, v in rf["grad1"].items()}
    gmed = float(np.median(list(gnorm.values())))
    keep = [p for p in rf["params3"]
            if p not in gnorm or gnorm[p] >= 1e-3 * gmed]
    delta = lambda o: {p: np.asarray(o["params3"][p], np.float64)
                       - np.asarray(params0[p], np.float64)
                       for p in keep if p in o["params3"]}
    out["change_gap"] = _leaf_gap(delta(sys), delta(rf), keep)
    gap = 0.0
    for f, rv in rf["store3"].items():
        gap = max(gap, float(np.abs(np.asarray(sys["store3"][f]) - rv).max()))
    gap = max(gap, float(np.abs(np.asarray(sys["obs3"]) - rf["obs3"]).max()))
    out["collect_gap"] = _finite(gap)
    return out


def judge(S0s: List[Dict[str, Any]], sys_outs: List[Dict[str, Any]],
          cfg: ref.RefConfig, device, var: ref.Variant = ref.SOUND
          ) -> Dict[str, float]:
    """Every member's numbers from its start, the worst of each; ``var``
    puts the control or a fault in the system's place (``sys_outs`` then
    unused and may be None)."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    for m, S0 in enumerate(S0s):
        sys_out = sys_outs[m] if var == ref.SOUND else follow(S0, cfg,
                                                             device, var)
        rf = follow(S0, cfg, device, ref.SOUND, sys_out)
        params0 = {p: _np(v) for p, v in S0["params"].items()}
        for k, v in compare(sys_out, rf, params0).items():
            worst[k] = max(worst[k], v)
    return worst
