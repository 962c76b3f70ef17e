"""The actors' collect (``rl.apex``) and the n-step ring: device ms a
superstep from the superstep's first phase stamp to the replay add's (the
superstep's draws included), read from the system's phase stamps
(``bench.phases``)."""
from bench import phases

UNIT = "ms"
LAYER = "rl.apex: the collect and n-step ring"
MOVES = "updates_per_s"


def read(ctx):
    return phases.ms(ctx, "collect")
