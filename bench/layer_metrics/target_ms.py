"""The target networks' EMA (``rl.sac``; OFENet's in ``core.ofenet``):
device ms a superstep of the ``target`` intervals (a fleet's: all
members), read from the system's phase stamps (``bench.phases``). A part
of ``update_ms``, not added to it again. Nothing where the system stamps
no ``target`` phase."""
from bench import phases

UNIT = "ms"
LAYER = "rl.sac: the target networks' EMA"
MOVES = "updates_per_s"


def read(ctx):
    got = phases.table(ctx)
    return None if got is None else got.get("target")
