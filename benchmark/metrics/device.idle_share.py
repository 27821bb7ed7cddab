"""The share of the traced stretch in which no operation ran on the
device: 1 minus the union of the device events' intervals over the
stretch's length."""


def read(ctx):
    if not ctx.window_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
