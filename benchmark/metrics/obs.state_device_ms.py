"""Device time of the operations launched inside ``obs.state_observation``,
per call (ms)."""

COUNTS = ()


def read(ctx):
    return ctx.per_call_ms("obs") if ctx.observation == "state" else None
