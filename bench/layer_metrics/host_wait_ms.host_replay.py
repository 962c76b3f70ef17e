"""The host replay's waits on the card (``rl.runner``'s ``StepGraph``):
ms a superstep of the host blocked in the synchronize after segment A
(``repro_torch.replay.wait_rows``) and after segment B
(``repro_torch.replay.wait_prio``), over the capture of the host alone. A
system without these spans reports nothing."""
from bench import trace

UNIT = "ms"
LAYER = "rl.runner StepGraph: the host replay's waits on the card"
MOVES = "updates_per_s.host_replay"
SPANS = ("repro_torch.replay.wait_rows", "repro_torch.replay.wait_prio")


def read(ctx):
    p = ctx.host_profile
    if not any(n in SPANS for n, _, _ in p["spans"]):
        return None
    return 1e3 * trace.span_seconds(p, SPANS) / p["supersteps"]
