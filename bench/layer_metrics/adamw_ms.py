"""AdamW (``optim.adamw``) as the superstep runs it: device ms a superstep
of its ``adamw_update`` calls (actor, critics, temperature, OFENet),
summed, read from the system's phase stamps (``bench.phases``)."""
from bench import phases

UNIT = "ms"
LAYER = "optim.adamw"
MOVES = "updates_per_s"


def read(ctx):
    return phases.ms(ctx, "adamw")
