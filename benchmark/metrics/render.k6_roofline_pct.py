"""K6's (``csrc/paint_view.cu``) share of its roofline in the pixel
observation (%): the least time of the work the traced observations needed
(``counts/k6.py``) over the kernel's device time."""

COUNTS = ("k6",)


def read(ctx):
    return ctx.roofline_pct("k6")
