"""Milliseconds a round spends in the runner's ``evaluate.eval`` phase,
from the same series as ``runner.select_ms``."""


def read(ctx):
    return ctx.phase_ms("evaluate", "eval")
