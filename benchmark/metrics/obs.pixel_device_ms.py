"""Device time of the operations launched inside
``obs.pixel_observation_batched`` (``render/pixels.view_inputs`` and the
painter K6), per call (ms)."""

COUNTS = ()


def read(ctx):
    return ctx.per_call_ms("obs") if ctx.observation == "pixels" else None
