"""The host NumPy replay (``rl.replay``): the spans of its add, sample
and priority refresh per superstep, over the capture of the host alone
(the device untraced). A run on the device replay opens none of them and
reports nothing."""
from bench import trace

UNIT = "ms"
LAYER = "rl.replay: the host NumPy replay"
MOVES = "updates_per_s.host_replay"
SPANS = ("repro.replay.host_add", "repro.replay.host_sample",
         "repro.replay.host_update_prio")


def read(ctx):
    p = ctx.host_profile
    if not any(n in SPANS for n, _, _ in p["spans"]):
        return None
    return 1e3 * trace.span_seconds(p, SPANS) / p["supersteps"]
