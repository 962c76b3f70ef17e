"""AdamW (``optim.adamw``): the least time of one update's four
``adamw_update`` calls (actor, critics, temperature, OFENet), 7 float32
read or written an element at the HBM rate (``bench.count``), over the
device's busy time in the trace, called on the run's own trees and state
(a fleet's: the vmapped call the fleet makes)."""
import torch

from bench import count, probe

UNIT = "%"
LAYER = "optim.adamw"
MOVES = "updates_per_s"


def probes(ctx):
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_update
    drv = ctx.driver
    if drv.device.type != "cuda":
        return None
    agent = drv.state().agent
    p, opt = agent["params"], agent["opt"]
    groups = [(p["actor"], opt["actor"]), (p["critics"], opt["critics"]),
              (p["log_alpha"], opt["alpha"])]
    if "ofenet" in opt:
        groups.append((p["ofenet"]["online"], opt["ofenet"]))
    cfg = AdamWConfig(lr=ctx.config["constants"]["lr"])
    gen = torch.Generator(device=drv.device).manual_seed(0)
    grads = [tree_map(lambda t: 1e-3 * torch.randn(
        t.shape, generator=gen, device=t.device), q) for q, _ in groups]
    step = (torch.func.vmap(lambda g, s, q: adamw_update(cfg, g, s, q))
            if drv._stacked else
            (lambda g, s, q: adamw_update(cfg, g, s, q)))

    def fn():
        return [step(g, s, q) for g, (q, s) in zip(grads, groups)]
    elements = sum(t.numel() for q, _ in groups for t in tree_leaves(q))
    least = count.least_seconds(count.adamw_flops(elements),
                                count.adamw_bytes(elements))
    return {"update": {"fn": fn, "calls": 1, "least_s": least}}


def read(ctx):
    return probe.share(ctx.probed)

