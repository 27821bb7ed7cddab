"""The reference against the port at tiny widths on the CPU. The test may
import the port; the reference may not (``test_benchmark_modules``)."""

import json

import numpy as np
import pytest
import torch
from torch.func import functional_call

from benchmark import inputs, run
from benchmark.reference import availability, data, models
from tinycells import round_images_like_the_port, shrink, tiny_cell

from olearning_sim_tpu_torch.deviceflow.trace_compiler import combine_traces, compile_trace
from olearning_sim_tpu_torch.engine import client_data
from olearning_sim_tpu_torch.engine.scenario import ScenarioConfig, ScenarioModel
from olearning_sim_tpu_torch.models import get_model


def test_populations_equal_the_ports():
    x, y, ns = data.text_population(11, 6, 5, 8, 2, 97, 0.8)
    ds = client_data.make_synthetic_text_dataset(11, 6, 5, 8, 2, 97, 0.8)
    assert np.array_equal(x, ds.x) and np.array_equal(y, ds.y)
    assert np.array_equal(ns, ds.num_samples)
    ex, ey = data.text_eval_set(11, 16, 8, 2, 97)
    px, py = client_data.make_central_text_eval_set(11, 16, 8, 2, 97)
    assert np.array_equal(ex, px) and np.array_equal(ey, py)
    x, y, ns = data.blob_population(12, 5, 4, (6, 6, 1), 62, 0.3)
    ds = client_data.make_synthetic_dataset(12, 5, 4, (6, 6, 1), 62, 0.3)
    assert np.array_equal(x, ds.x) and np.array_equal(y, ds.y)
    ex, ey = data.blob_eval_set(12, 16, (6, 6, 1), 62)
    px, py = client_data.make_central_eval_set(12, 16, (6, 6, 1), 62)
    assert np.array_equal(ex, px) and np.array_equal(ey, py)


def test_availability_equals_the_ports_traces():
    """Dispatch trace and scenario, intersected, and the drift: every round
    of the spike cell's task, past the spike and the first drift period."""
    cell = tiny_cell("distilbert_fedadam.spike_trace")
    task = inputs.make_task(cell.config, cell.traffic, 5)
    ref = availability.from_task(task)
    op = inputs.train_operator(task)
    strategy = json.loads(op["operation_behavior_controller"]["strategy_gradient_house"])
    params = inputs.engine_params(task)
    nums = cell.traffic["nums"]
    cls = np.repeat(np.arange(len(nums)), nums)
    scen = ScenarioModel(ScenarioConfig.from_dict(params["scenario"]), sum(nums), seed=0,
                         class_of_client=cls, device_classes=cell.traffic["devices"])
    for r in range(0, 30):
        trace = combine_traces(compile_trace(strategy, sum(nums), r, task_id=task["task_id"],
                                             operator="train", seed=0),
                               scen.round_trace(r).as_client_trace())
        train, shift = ref.round(r)
        assert np.array_equal(train, trace.participate > 0), r
        port_shift = scen.round_trace(r).label_shift
        if shift is None:
            assert not port_shift.any()
        else:
            assert np.array_equal(shift, port_shift)


@pytest.mark.parametrize("family,overrides,shape", [
    ("distilbert", {"width": 16, "depth": 2, "heads": 2, "mlp_dim": 32, "vocab_size": 97,
                    "max_len": 8, "num_classes": 2}, (8,)),
    ("resnet18", {"stage_features": [16, 16, 16, 32], "num_classes": 62}, (16, 16, 1)),
])
def test_forward_equals_the_ports_in_float32(family, overrides, shape):
    cell = tiny_cell("distilbert_fedadam.spike_trace" if family == "distilbert"
                     else "resnet18_fedprox.full")
    task = inputs.make_task(cell.config, cell.traffic, 3)
    config, _ = shrink()(cell.config, task)
    arch = config["architecture"]
    w = inputs.make_weights(config, 3, torch.device("cpu"))
    spec_name = "distilbert" if family == "distilbert" else "resnet18"
    m = get_model(spec_name).build(input_shape=shape, dtype="float32", **overrides)
    g = torch.Generator().manual_seed(0)
    x = (torch.randint(1, 97, (5,) + shape, generator=g) if family == "distilbert"
         else torch.randn((5,) + shape, generator=g))
    _, logits = models.ARCHITECTURES[family]
    assert torch.allclose(functional_call(m, w, (x,)), logits(w, x, arch), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,tol", [
    # Integer tokens: the two sides differ by the order of float32 sums.
    ("distilbert_fedadam.spike_trace", 1e-4),
    # The port's vmapped grouped convolutions on the CPU: after two local
    # steps one client of eight (seed 8) differed from plain per-client
    # convolutions by 0.6% in one GroupNorm leaf, the others by 2e-5.
    ("resnet18_fedprox.full", 2e-2),
])
def test_harness_run_in_float32_follows_the_port(name, tol, monkeypatch):
    """A whole run of the harness on the CPU, the program computing in
    float32: every compared number is near 0 and the availability exact.
    The reference's images are rounded as the port stores them."""
    round_images_like_the_port(monkeypatch)
    cell = tiny_cell(name, nums=[4, 4])
    res = run.run_cell(run.ROOT, cell, 7, 0.0, False, torch.device("cpu"),
                       shrink=shrink("float32"))
    nums = {k: c["value"] for k, c in res["checks"].items()}
    assert nums["trained_mismatch"] == 0
    for k in ("loss_gap", "eval_loss_gap", "grad1_gap", "change_gap"):
        assert nums[k] < tol, (k, nums[k])
