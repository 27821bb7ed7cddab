"""Milliseconds a round spends in the runner's ``train.select`` phase
(dispatch-trace compile, scenario masks, quarantine), from the runner's
``ols_engine_round_phase_duration_seconds`` series: its sum over its count
for the traced rounds."""


def read(ctx):
    return ctx.phase_ms("train", "select")
