"""The card between supersteps (``rl.experiment`` / ``rl.sweep``): ms a
superstep from one superstep's last phase stamp to the next one's first,
the chunk epilogues' device work and the card waiting on the host, read
from the system's phase stamps (``bench.phases``)."""
from bench import phases

UNIT = "ms"
LAYER = "rl.experiment / rl.sweep: the device between supersteps"
MOVES = "updates_per_s"


def read(ctx):
    return phases.ms(ctx, "step_gap")
