"""The fused stack's backward (``kernels.dense_block.stack``): as
``stack_fwd_roofline``, for the forward and backward (dW, db and dx of
every layer, the input's too) of the block calls one update
differentiates, through autograd (a fleet's: ``torch.func.vjp`` vmapped
over its members)."""
from bench import probe

UNIT = "%"
LAYER = "kernels.dense_block.stack: the fused stack, backward"
MOVES = "updates_per_s"


def probes(ctx):
    return probe.stack_probes(ctx, backward=True)


def read(ctx):
    return probe.share(ctx.probed)
