"""Seconds from the process's start to the first timed superstep:
imports, loading (the first time in a checkout: building) the kernel
libraries, the start that the reference makes from the seed handed to the
system, the three checked supersteps (the first captures the CUDA graph)
and the epilogue's first call (host clock, after a synchronize)."""
UNIT = "s"


def read(ctx) -> float:
    return ctx.setup_s
