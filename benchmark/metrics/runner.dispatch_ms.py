"""Milliseconds a round spends compiling the dispatch trace
(``compile_trace``): the runner's ``round.train.select.dispatch`` spans
over the traced rounds, summed, over the rounds' ``round.train.select``
spans; a part of ``runner.select_ms``."""

from benchmark.spans import traced_phases, under


def read(ctx):
    spans = under(ctx, "select", "round.train.select.dispatch")
    if not spans:
        return None
    return 1e3 * sum(s.duration_s for s in spans) / len(traced_phases(ctx, "select"))
