"""Member-updates completed in the window over the window's wall (host
clock, ended by a synchronize): all the work over all the time. One
update is one SAC gradient step at the configuration's batch with the
collect of its actors; a fleet of E members makes E a superstep."""
UNIT = "updates/s"


def read(ctx) -> float:
    return ctx.window["updates"] / ctx.window["wall_s"]
