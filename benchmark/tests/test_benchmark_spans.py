"""The readers of the program's spans (``round.useful_share``,
``runner.dispatch_ms``): nothing from a program without the spans, and
from a tiny traced run of the spike-trace cell, the share the frozen
availability gives and a dispatch time inside ``runner.select_ms``."""

import pytest
import torch

from benchmark import inputs, run
from benchmark.reference import availability
from olearning_sim_tpu_torch.telemetry import default_tracer
from tinycells import shrink, tiny_cell

NEW = ("round.useful_share", "runner.dispatch_ms")


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_without_the_spans(name):
    """A program that records no such span (the tracer holds only the
    runner's phases) reads nothing, and raises nothing."""
    tracer = default_tracer()
    tracer.clear()
    for r in range(run.SETUP_ROUNDS + 2):
        for phase in ("select", "train"):
            with tracer.span(f"round.train.{phase}", task_id="t", round_idx=r):
                pass
    ctx = run.Trace()
    ctx.traced_rounds = 2
    try:
        assert run.load_reader(run.ROOT, name)(ctx) is None
        ctx.traced_rounds = 0
        assert run.load_reader(run.ROOT, name)(ctx) is None
    finally:
        tracer.clear()


def test_tiny_traced_run_prints_the_span_metrics():
    cell = tiny_cell("distilbert_fedadam.spike_trace", nums=[4, 4])
    cell.traffic["trace_rounds"] = 2
    seed = 2**31 + 23
    res = run.run_cell(run.ROOT, cell, seed, 1e9, True, torch.device("cpu"), shrink=shrink())
    metrics = res["metrics"]
    assert set(NEW) <= set(metrics)
    _, task = shrink()(cell.config, inputs.make_task(cell.config, cell.traffic, seed))
    avail = availability.from_task(task)
    traced = range(run.SETUP_ROUNDS, run.SETUP_ROUNDS + 2)
    released = sum(int(avail.round(r)[0].sum()) for r in traced)
    assert metrics["round.useful_share"]["value"] == 100.0 * released / (8 * len(traced))
    assert 0 < metrics["runner.dispatch_ms"]["value"] <= metrics["runner.select_ms"]["value"]
