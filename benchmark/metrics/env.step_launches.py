"""Device operations (kernels, copies, sets) that one ``env.step`` call
launches: the host's dispatch work per step."""

COUNTS = ()


def read(ctx):
    return ctx.launches_per_call("env.step")
