"""The device replay (``replay.device``): device ms a superstep of its add
and sample, then of its refresh with the sampled rows' staleness, the two
intervals summed, read from the system's phase stamps
(``bench.phases``)."""
from bench import phases

UNIT = "ms"
LAYER = "replay.device: add, sample and refresh"
MOVES = "updates_per_s"


def read(ctx):
    return phases.ms(ctx, "replay")
