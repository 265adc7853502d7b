"""Share of two whole chunks in which the card ran no operation (%): 100 x
(1 - busy / window), busy the union of the device events' intervals, from a
profile of device activity alone, so the host runs at its own pace."""

COUNTS = ()


def read(ctx):
    if ctx.busy_window_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.busy_window_s)
