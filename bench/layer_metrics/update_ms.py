"""The SAC update (``rl.sac``): device ms a superstep from the end of the
sample to the start of the refresh, less the AdamW calls: the losses, the
forward and backward of every net, the target update and the priorities,
read from the system's phase stamps (``bench.phases``)."""
from bench import phases

UNIT = "ms"
LAYER = "rl.sac: losses, forward and backward, less AdamW"
MOVES = "updates_per_s"


def read(ctx):
    return phases.ms(ctx, "update")
