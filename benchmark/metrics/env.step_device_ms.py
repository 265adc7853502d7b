"""Device time of the operations launched inside ``env.step`` (controls,
the island kernel with its pack and unpack, the track pass, ``_post_step``),
per call (ms)."""

COUNTS = ()


def read(ctx):
    return ctx.per_call_ms("env.step")
