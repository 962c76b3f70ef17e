"""In-loop health guards: detect divergence, decide halt / skip / rollback
(port of ``repro/guard/monitor.py``; a fleet keeps one ``Monitor`` a member
and checks its member-stacked params with ``check_member_params``).

``GuardSpec`` is the ``guard`` section of ``ExperimentSpec``. When enabled,
the loops record the per-step scalar stream (the one obs writes; recording
it is bitwise-invisible to training) and hand each chunk's stream plus the
live state to a ``Monitor``:

* **non-finite stream**  — any watched scalar (losses, alpha, grad norms,
  ...) going NaN/inf; caught at the exact offending step, one step after a
  NaN first enters the params (the update that poisons them still computes
  finite losses from the old values).
* **non-finite params** — ``all_finite``: one device-side reduction over
  every floating leaf of the agent params, read once per chunk.
* **loss spikes**       — ``spike_key`` exceeding ``spike_factor`` x the
  rolling-window median (host-side, absolute values).
* **srank collapse**    — latest effective rank below ``srank_collapse`` x
  the run's peak (needs ``eval.srank_every`` > 0).

Detection is pure observation: a guarded run with no violations is
bitwise-identical to an unguarded one. On violation the loop applies
``GuardSpec.policy``: ``halt`` raises ``GuardViolation``; ``skip`` restores
the pre-segment snapshot, perturbs the run's generator with
``fold_in(gen, ordinal)`` and re-runs the segment; ``rollback`` restores
the newest GOOD checkpoint of the attached ``DurableStore`` and perturbs
the generator the same way. ``max_recoveries`` bounds the budget; once
spent, the next violation raises regardless of policy.

Recovery contract: the trajectory after the n-th recovery is a pure
function of (restored state, n) through ``fold_in`` below, the port's twin
of the reference's ``jax.random.fold_in(key, n)`` — tests rebuild it
exactly.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import deque
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.common import tree_leaves

POLICIES = ("halt", "skip", "rollback")

_MIN_SPIKE_HISTORY = 8           # median needs some history before judging


@dataclasses.dataclass(frozen=True)
class GuardSpec:
    """The ``guard`` section of ``ExperimentSpec`` (validated standalone so
    ``repro_torch.guard`` never imports ``repro_torch.rl``; the spec tree
    turns its ``ValueError`` into a ``SpecError``)."""
    enabled: bool = False
    policy: str = "halt"           # halt | skip | rollback
    check_params: bool = True      # all-finite reduction on agent params
    spike_factor: float = 0.0      # >0: flag spike_key > factor x median
    spike_key: str = "critic_loss"
    spike_window: int = 64         # rolling median window (host-side)
    srank_collapse: float = 0.0    # >0: flag srank < frac x run peak
    max_recoveries: int = 3        # skip/rollback budget per run

    def __post_init__(self):
        if not isinstance(self.enabled, (bool, np.bool_)):
            raise ValueError(f"guard.enabled={self.enabled!r} must be a "
                             f"bool")
        if self.policy not in POLICIES:
            raise ValueError(f"guard.policy={self.policy!r} is not one of "
                             f"{POLICIES}")
        if not isinstance(self.check_params, (bool, np.bool_)):
            raise ValueError(f"guard.check_params={self.check_params!r} "
                             f"must be a bool")
        if not self.spike_key or not isinstance(self.spike_key, str):
            raise ValueError(f"guard.spike_key={self.spike_key!r} must be "
                             f"a non-empty metric-stream key")
        for f in ("spike_factor", "srank_collapse"):
            v = getattr(self, f)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v < 0:
                raise ValueError(f"guard.{f}={v!r} must be a number >= 0")
        if self.srank_collapse >= 1.0:
            raise ValueError(f"guard.srank_collapse={self.srank_collapse!r} "
                             f"must be < 1 (a fraction of the peak)")
        for f, lo in (("spike_window", 2), ("max_recoveries", 0)):
            v = getattr(self, f)
            if not isinstance(v, (int, np.integer)) or isinstance(v, bool) \
                    or v < lo:
                raise ValueError(f"guard.{f}={v!r} must be an int >= {lo}")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One detected health violation (a member of ``GuardViolation`` and of
    the supervisor's incident report)."""
    step: int                      # absolute learner step of detection
    reason: str                    # nonfinite_stream|nonfinite_params|
                                   # spike|srank_collapse
    detail: str = ""
    member: Optional[int] = None   # fleet member index (None: solo)
    value: Optional[float] = None

    def as_dict(self) -> Dict[str, Any]:
        d = {"step": self.step, "reason": self.reason, "detail": self.detail}
        if self.member is not None:
            d["member"] = self.member
        if self.value is not None and np.isfinite(self.value):
            d["value"] = float(self.value)
        return d


class GuardViolation(RuntimeError):
    """Raised when policy is ``halt``, when the recovery budget is spent,
    or when skip/rollback cannot proceed (no good checkpoint). Carries the
    violations for the incident report."""

    def __init__(self, message: str, violations: List[Violation],
                 recoveries: int = 0):
        super().__init__(message)
        self.violations = list(violations)
        self.recoveries = recoveries

    @property
    def step(self) -> Optional[int]:
        return self.violations[0].step if self.violations else None


# ------------------------------------------------------------ health fns

def all_finite(tree) -> bool:
    """True when every floating leaf of ``tree`` is finite everywhere.

    One device-side pass per leaf group and one host read: each leaf times
    0 is 0 where it is finite and NaN where it is not (IEEE: 0 x inf is
    NaN), their L2 norms (``torch._foreach_norm``: additions, which carry a
    NaN through) are summed, and the sum is finite exactly when every leaf
    is. Integer leaves are skipped."""
    leaves = [x for x in tree_leaves(tree)
              if torch.is_tensor(x) and x.is_floating_point()]
    if not leaves:
        return True
    zeros = torch._foreach_mul(leaves, 0.0)
    total = torch.stack(torch._foreach_norm(zeros)).sum()
    return bool(torch.isfinite(total))


def member_finite(tree) -> np.ndarray:
    """Per-member all-finite over a member-stacked tree: ``(E,)`` bool,
    reducing every axis of each floating leaf but the leading member axis
    (one device pass a leaf, one host read)."""
    leaves = [x for x in tree_leaves(tree)
              if torch.is_tensor(x) and x.is_floating_point()]
    if not leaves:
        raise ValueError("member_finite: tree has no floating leaves")
    ok = torch.stack([torch.isfinite(x.reshape(x.shape[0], -1)).all(dim=1)
                      for x in leaves]).all(dim=0)
    return ok.cpu().numpy()


def fold_in(gen: torch.Generator, ordinal: int) -> None:
    """Perturb ``gen`` in place as the ``ordinal``-th guard recovery does
    (the port's twin of ``jax.random.fold_in(key, ordinal)``).

    The contract: ``s = gen.get_state()`` (a uint8 tensor: the Mersenne
    Twister state on the CPU, Philox seed and offset on a card);
    ``seed = int.from_bytes(sha256(bytes(s) + ordinal.to_bytes(8,
    "little")).digest()[:8], "little") >> 1``; then ``gen`` takes the state
    of a fresh generator on its device seeded with ``seed``, through
    ``gen.set_state`` — the path a generator registered with a CUDA graph
    loads a state by. A deterministic function of the generator's state and
    the ordinal, so a recovered run is rebuilt exactly from the state it
    restarted from."""
    h = hashlib.sha256(gen.get_state().numpy().tobytes()
                       + int(ordinal).to_bytes(8, "little"))
    seed = int.from_bytes(h.digest()[:8], "little") >> 1
    fresh = torch.Generator(device=gen.device).manual_seed(seed)
    gen.set_state(fresh.get_state())


# --------------------------------------------------------------- monitor

class Monitor:
    """Host-side detection state for one run: the rolling spike window, the
    srank peak, and the recovery budget. The loops call the ``check_*``
    methods after each segment and route any returned violations through
    their policy handler."""

    def __init__(self, spec: GuardSpec):
        self.spec = spec
        self.recoveries = 0
        self._spike_hist: deque = deque(maxlen=spec.spike_window)

    # ------------------------------------------------------------ checks
    def check_stream(self, start_step: int,
                     stream: Mapping[str, np.ndarray],
                     member: Optional[int] = None) -> List[Violation]:
        """Scan one segment's per-step scalar stream (host arrays covering
        absolute steps ``start_step+1 .. start_step+n``) for non-finite
        values and spikes."""
        out: List[Violation] = []
        for key in sorted(stream):
            v = np.asarray(stream[key], np.float64)
            bad = ~np.isfinite(v)
            if bad.any():
                i = int(np.argmax(bad))
                out.append(Violation(
                    step=start_step + i + 1, reason="nonfinite_stream",
                    detail=f"{key} is {v[i]!r}", member=member,
                    value=float(v[i])))
        spec = self.spec
        if spec.spike_factor and spec.spike_key in stream:
            vals = np.abs(np.asarray(stream[spec.spike_key], np.float64))
            for i, v in enumerate(vals):
                if not np.isfinite(v):
                    continue       # already reported above
                if len(self._spike_hist) >= _MIN_SPIKE_HISTORY:
                    med = float(np.median(self._spike_hist))
                    if med > 0 and v > spec.spike_factor * med:
                        out.append(Violation(
                            step=start_step + i + 1, reason="spike",
                            detail=f"{spec.spike_key}={v:.4g} > "
                                   f"{spec.spike_factor:g} x median "
                                   f"{med:.4g}", member=member,
                            value=float(v)))
                        continue   # a spike does not poison the window
                self._spike_hist.append(v)
        return out

    def check_scalars(self, step: int, scalars: Mapping[str, float],
                      member: Optional[int] = None) -> List[Violation]:
        """Single-step variant (python loop): the same checks over one row
        of scalars."""
        return self.check_stream(
            step - 1, {k: np.asarray([v]) for k, v in scalars.items()},
            member=member)

    def check_params(self, step: int, params,
                     member: Optional[int] = None) -> List[Violation]:
        if not self.spec.check_params:
            return []
        if not all_finite(params):
            return [Violation(step=step, reason="nonfinite_params",
                              detail="non-finite value in agent params",
                              member=member)]
        return []

    def check_member_params(self, step: int, params) -> List[Violation]:
        """Fleet variant: one violation per member with non-finite params
        (params stacked on a leading member axis)."""
        if not self.spec.check_params:
            return []
        ok = member_finite(params)
        return [Violation(step=step, reason="nonfinite_params",
                          detail="non-finite value in agent params",
                          member=int(m))
                for m in np.nonzero(~ok)[0]]

    def check_srank(self, step: int, sranks,
                    member: Optional[int] = None) -> List[Violation]:
        frac = self.spec.srank_collapse
        if not frac or len(sranks) < 2:
            return []
        peak, last = max(sranks), sranks[-1]
        if peak > 0 and last < frac * peak:
            return [Violation(step=step, reason="srank_collapse",
                              detail=f"srank {last} < {frac:g} x peak "
                                     f"{peak}", member=member,
                              value=float(last))]
        return []

    # ---------------------------------------------------------- recovery
    def spend_recovery(self, violations: List[Violation]) -> int:
        """Consume one unit of the recovery budget; returns the recovery
        ORDINAL (1-based — the ``fold_in`` perturbation value). Raises
        ``GuardViolation`` when the budget is already spent."""
        if self.recoveries >= self.spec.max_recoveries:
            raise GuardViolation(
                f"guard: recovery budget spent "
                f"({self.spec.max_recoveries} {self.spec.policy}(s)); "
                f"latest: {[v.as_dict() for v in violations]}",
                violations, self.recoveries)
        self.recoveries += 1
        return self.recoveries
