"""K1's (``csrc/joints_island.cu``) share of its roofline in ``env.step`` (%):
the least time of the work the traced steps needed (``counts/k1.py``) over
the kernel's device time."""

COUNTS = ("k1",)


def read(ctx):
    return ctx.roofline_pct("k1")
