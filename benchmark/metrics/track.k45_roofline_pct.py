"""K4/K5's (``csrc/track_pass.cu``) share of its roofline in ``env.step`` (%):
the least time of the work the traced steps needed (``counts/k45.py``) over
the kernel's device time."""

COUNTS = ("k45",)


def read(ctx):
    return ctx.roofline_pct("k45")
