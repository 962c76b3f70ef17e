"""The whole update (``rl.runner``'s ``StepGraph``): the product
operations of the window's member-updates (``bench.count.update_flops``,
from the configuration's shapes) over the window's wall times the TF32
tensor-core peak, 495 TFLOP/s."""
from bench import count

UNIT = "%"
LAYER = "rl.runner StepGraph: the whole update"
MOVES = "updates_per_s"


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    w = ctx.window
    return 100.0 * count.update_flops(ctx.config) * w["updates"] / (
        w["wall_s"] * count.TF32_FLOPS_PER_S)
