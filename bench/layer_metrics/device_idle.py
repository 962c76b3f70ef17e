"""The device (one H100): the share of the profiled sub-window in which
no operation ran on it, 1 - (the union of its operations' intervals) /
(the sub-window's wall)."""
UNIT = "%"
LAYER = "device: one H100"
MOVES = "updates_per_s"


def read(ctx):
    p = ctx.profile
    if not p["kernels"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
