"""The target networks' EMA (``rl.sac``; OFENet's in ``core.ofenet``): the
least time of a superstep's averaging, 12 bytes an element of every
target network, a member each, at the HBM rate (``bench.count.targets``),
over ``target_ms``'s device time from the phase stamps. Nothing where
``target_ms`` reads nothing."""
from bench import count, phases
from bench.count import targets

UNIT = "%"
LAYER = "rl.sac: the target networks' EMA"
MOVES = "updates_per_s"


def read(ctx):
    got = phases.table(ctx)
    ms = None if got is None else got.get("target")
    if not ms:
        return None
    members = int(ctx.cell.get("members", 1))
    least = targets.ema_bytes(ctx.config, members) / count.HBM_BYTES_PER_S
    return 100.0 * least / (ms / 1e3)
