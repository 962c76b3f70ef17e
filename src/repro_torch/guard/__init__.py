"""repro_torch.guard — fault tolerance for long training runs (port of
``repro.guard``, for solo runs and for fleets: a fleet rolls back only the
violating members, ``repro_torch.rl.sweep``).

Large-network RL runs are unstable: divergence, rank collapse and long
runs on lost machines are the failure modes the paper's method exists to
tame. This package makes a run survive them. Four pieces:

* ``guard.store``   — ``DurableStore``: staged write + sha256 manifest +
  one directory rename a commit, keep-last-K retention, and
  ``restore_latest()`` that verifies checksums and falls back past a
  torn/corrupt checkpoint to the previous good one (the reference's
  on-disk layout, so either package lists the other's store).
* ``guard.monitor`` — ``GuardSpec`` (the ``guard`` section of
  ``ExperimentSpec``) + ``Monitor``: checks over the per-step scalar
  stream and a device-side all-finite reduction over the params, with a
  policy — ``halt`` (raise ``GuardViolation``), ``skip`` (discard the bad
  segment, perturb the generator, retry) or ``rollback`` (restore the last
  good durable checkpoint, perturb the generator) — and ``fold_in``, the
  generator perturbation of the n-th recovery.
* ``guard.supervise`` — ``python -m repro_torch.guard.supervise <preset>``:
  a crash-safe supervisor running an ``Experiment`` in worker subprocesses
  with periodic durable saves, auto-resuming after any crash with bounded
  retries + exponential backoff, and exiting non-zero with an
  ``incident.json`` once the retry budget is spent.
* ``guard.chaos``   — deterministic, step-addressed fault injection (NaN
  into the update at step k, SIGKILL at step k, crash mid-save, checkpoint
  bit-flip/truncation, transient sink IO errors).

Recovery is exact by construction: auto-resume rides the bitwise resume
contract (``run(N); save; restore; run(M)`` == ``run(N + M)``), so a
supervised run that crashed and recovered ends with the same params as an
uninterrupted one; a skip or rollback is a documented function of
(restored state, recovery ordinal), pinned by tests/test_torch_guard.py.
"""
from repro_torch.guard.monitor import (GuardSpec, GuardViolation, Monitor,
                                       Violation, all_finite, fold_in,
                                       member_finite)
from repro_torch.guard.store import CheckpointCorrupt, DurableStore
