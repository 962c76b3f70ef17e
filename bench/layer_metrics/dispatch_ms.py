"""The host's chunk dispatch (``rl.experiment`` / ``rl.sweep``): self
time per superstep of the span the run opens around each chunk
(``repro.chunk_dispatch``, a fleet's ``repro.fleet_chunk_dispatch``),
less the program spans nested in it (the host replay's, srank, eval),
over the capture of the host alone: the device is not traced there, so a
graph's launch costs what it costs in the window."""
from bench import trace

UNIT = "ms"
LAYER = "rl.experiment / rl.sweep: the host's chunk dispatch"
MOVES = "updates_per_s"
SPANS = ("repro.chunk_dispatch", "repro.fleet_chunk_dispatch")


def read(ctx):
    p = ctx.host_profile
    if not any(n in SPANS for n, _, _ in p["spans"]):
        return None
    total = sum(trace.self_seconds(p, name) for name in SPANS)
    return 1e3 * total / p["supersteps"]
