"""K2's (``csrc/contact_island.cu``, far and near pass) share of its roofline
in ``env.step`` (%): the least time of the work the traced steps needed
(``counts/k2.py``) over the kernels' device time."""

COUNTS = ("k2",)


def read(ctx):
    return ctx.roofline_pct("k2")
