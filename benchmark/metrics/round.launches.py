"""Kernel launches per round: the profiler's host-side launch records over
the traced rounds, divided by their count."""


def read(ctx):
    if not ctx.traced_rounds:
        return None
    return ctx.launches / ctx.traced_rounds
