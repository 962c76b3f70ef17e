"""The superstep's phases on the card, from the system's phase stamps
(``Experiment.trace_phases`` / ``Fleet.trace_phases`` and ``phases``),
read once a traced run, after the harness's captures, and kept on its
``ctx``: stamps on (the graph is captured anew with them), one
``call_steps`` call to capture and settle, two more, then ``phases`` over
those two calls' supersteps, or as many as the system's ring holds (ms
a superstep; a fleet's: all members).

Nothing is read on the CPU, or from a system without phase stamps (an
older one): every reader then reports nothing."""
from __future__ import annotations

from typing import Optional

_KEY = "phase_table"


def table(ctx) -> Optional[dict]:
    """``phases`` of the last two calls with stamps on, or None."""
    if _KEY not in vars(ctx):
        setattr(ctx, _KEY, _read(ctx))
    return getattr(ctx, _KEY)


def _read(ctx) -> Optional[dict]:
    drv = ctx.driver
    system = getattr(drv, "fleet", None) or getattr(drv, "exp", None)
    if drv.device.type != "cuda" or not hasattr(system, "trace_phases"):
        return None
    steps = int(ctx.cell["call_steps"])
    system.trace_phases()
    for _ in range(3):
        drv.run(steps)
    return system.phases(2 * steps)


def ms(ctx, phase: str) -> Optional[float]:
    """``phase``'s device ms a superstep, or None."""
    got = table(ctx)
    return None if got is None else got[phase]
