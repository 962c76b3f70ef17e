"""The fused stack's forward (``kernels.dense_block.stack``): the least
time of the block calls one update makes (operations at the TF32 peak or
bytes at the HBM rate, whichever is larger, counted by ``bench.count``
from the configuration's shapes) over the device's busy time in the
trace, each call made alone through ``core.blocks.mlp_block_apply`` under
``no_grad`` at its shape (a fleet's: vmapped over its members). Nothing
on ``jnp`` blocks."""
from bench import probe

UNIT = "%"
LAYER = "kernels.dense_block.stack: the fused stack, forward"
MOVES = "updates_per_s"


def probes(ctx):
    return probe.stack_probes(ctx, backward=False)


def read(ctx):
    return probe.share(ctx.probed)
