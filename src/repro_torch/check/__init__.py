"""repro_torch.check — static and dynamic gates for the port's contract
(port of ``repro/check``; its own copy, importing nothing of it).

Two halves, one finding format (:mod:`repro_torch.check.report`):

* ``python -m repro_torch.check lint [paths]`` — AST rules R001-R006
  rewritten for torch (a clock or host RNG in a captured scope, a draw
  without an explicit generator, Python control flow on a tensor's value,
  hidden host syncs, dead modules, unvalidated ``*Spec`` fields), diffed
  against ``check_baseline.json`` so only NEW findings fail.
* ``python -m repro_torch.check dynamic --preset smoke`` — runs a short
  preset twice: the second pass under
  ``torch.cuda.set_sync_debug_mode("error")`` (D001), its CUDA graph
  captures and dispatched chunks against the schedule (D002), then one
  eager superstep for finite parameters and clean tree writes (D003).
"""
from repro_torch.check.report import Finding, RULES, render, to_json

__all__ = ["Finding", "RULES", "render", "to_json"]
