"""The window is the workload's fixed range of rounds, whatever the
program's speed: ``window_rounds`` rounds when ``--seconds`` leave room,
fewer only when ``--seconds`` pass first; the round after it is checked and
not counted."""

import pytest
import torch

from benchmark import run
from tinycells import shrink, tiny_cell


@pytest.mark.parametrize("seconds,rounds", [(1e9, 3), (0.0, 1)])
def test_window_holds_the_workloads_rounds(seconds, rounds):
    cell = tiny_cell("distilbert_fedadam.spike_trace", nums=[4, 4])
    cell.traffic["window_rounds"] = 3
    res = run.run_cell(run.ROOT, cell, 2**31 + 21, seconds, False, torch.device("cpu"),
                       shrink=shrink())
    assert res["attempted"] == rounds
    assert res["checks"]["trained_mismatch"]["value"] == 0
