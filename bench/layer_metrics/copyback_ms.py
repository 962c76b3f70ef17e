"""The copy-back of ``rl.runner``'s ``StepGraph``: device ms a superstep of
the copy of its results into the static state (with the obs stream's row
when obs is on), read from the system's phase stamps (``bench.phases``)."""
from bench import phases

UNIT = "ms"
LAYER = "rl.runner StepGraph: the copy-back"
MOVES = "updates_per_s"


def read(ctx):
    return phases.ms(ctx, "copyback")
