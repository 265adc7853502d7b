"""Device time of the operations launched inside ``env.reset_done_envs``
(the draws, the spawn tick of fresh episodes for every env, the selection),
per call (ms)."""

COUNTS = ()


def read(ctx):
    return ctx.per_call_ms("reset")
