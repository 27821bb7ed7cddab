"""Seconds ``build_runner_from_taskconfig`` took on the cell's task JSON
(host clock around the call; the task bridge's share of set-up)."""


def read(ctx):
    return ctx.bridge_build_s
