"""The spans inside the port's round, on the CPU: a tiny mlp2 task of 8
clients in blocks of 4, half of them released (four preseeded into
quarantine, one of the first block and three of the second left), through
the task bridge and the runner.

- Each block of ``_train_block`` is a ``round.block`` span (``block``,
  ``clients``, ``released``) holding one ``round.local_steps`` and one
  ``round.aggregate``; the round's close is one ``round.server_update``;
  all under the runner's ``round.train.train``, on the resident, the
  streamed and the async path.
- ``round.train.select`` holds ``.dispatch``, ``.scenario`` and, where the
  round plans arrivals, ``.pacing``.
- The bridge's build is ``bridge.build`` over ``bridge.model``,
  ``bridge.populations`` and ``bridge.runner``.
- A disabled tracer records nothing and the round's outputs are bitwise
  those of an enabled one."""

import json

import pytest
import torch

from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
from olearning_sim_tpu_torch.telemetry import SpanTracer, set_default_tracer

import torch_threads  # noqa: F401

QUARANTINED = [0, 1, 2, 7]
RELEASED = [1, 3]
ASYNC = {"buffer_size": 2, "max_staleness": 2, "schedule": "polynomial",
         "staleness_alpha": 0.5, "speed_profiles": {"high": 0.05, "low": 0.3},
         "default_step_s": 0.1}
PATHS = {
    "resident": {"scenario": {"online_base": 1.0}},
    "streamed": {"scenario": {"stream_block_rows": 4}},
    "async": {"scenario": {"online_base": 1.0}, "async": ASYNC},
}
SELECT = {"resident": {"dispatch", "scenario"}, "streamed": {"dispatch", "scenario"},
          "async": {"dispatch", "scenario", "pacing"}}


def tiny_task(task_id, rounds=1, **blocks):
    params = {
        "model": {"name": "mlp2", "overrides": {"hidden": [16], "num_classes": 3},
                  "input_shape": [6]},
        "algorithm": {"name": "fedavg", "local_lr": 0.1},
        "fedcore": {"batch_size": 4, "max_local_steps": 2, "block_clients": 4},
        "data": {"synthetic": {"seed": 5, "n_local": 6, "num_classes": 3}},
        "quarantine": {"preseed": {"data_0": QUARANTINED}},
        **blocks,
    }
    cond = {"logical_simulation": {"strategy": "", "wait_interval": 0, "total_timeout": 0}}
    train = {"name": "train", "input": [],
             "operation_behavior_controller": {"use_gradient_house": False,
                                               "strategy_gradient_house": "",
                                               "outbound_service": ""},
             "model": {"use_model": False, "model_transfer_type": "FILE"},
             "logical_simulation": {"operator_transfer_type": "FILE",
                                    "operator_code_path": "builtin:train",
                                    "operator_params": json.dumps(params)}}
    return {
        "user_id": "u", "task_id": task_id,
        "target": {"data": [{"name": "data_0", "data_transfer_type": "FILE",
                             "total_simulation": {"devices": ["high", "low"], "nums": [4, 4],
                                                  "dynamic_nums": [0, 0]},
                             "allocation": {"logical_simulation": [4, 4]}}]},
        "operatorflow": {"flow_setting": {"round": rounds, "start": cond, "stop": cond},
                         "operators": [train]},
    }


def run_task(task, tracer):
    """The task's rounds with ``tracer`` as the default tracer; returns the
    runner."""
    old = set_default_tracer(tracer)
    try:
        runner = build_runner_from_taskconfig(task, device="cpu")
        runner.run()
    finally:
        set_default_tracer(old)
    return runner


def children(tracer, parent, name=None):
    return [s for s in tracer.spans(name) if s.parent_id == parent.span_id]


def under(tracer, span, ancestor) -> bool:
    """Whether ``ancestor`` encloses ``span`` (the streamed round's blocks
    sit in its ``stream_step`` spans)."""
    by_id = {s.span_id: s for s in tracer.spans()}
    while span.parent_id is not None:
        span = by_id[span.parent_id]
        if span is ancestor:
            return True
    return False


@pytest.mark.parametrize("path", sorted(PATHS))
def test_round_span_tree(path):
    tracer = SpanTracer()
    runner = run_task(tiny_task(f"spans_{path}", **PATHS[path]), tracer)
    assert runner.history[-1]["train"]["data_0"]["clients_trained"] == sum(RELEASED)
    (train,) = tracer.spans("round.train.train")
    assert train.attrs["round_idx"] == 0
    blocks = sorted(tracer.spans("round.block"), key=lambda s: s.attrs["block"])
    assert all(under(tracer, s, train) for s in blocks)
    assert [s.attrs for s in blocks] == [
        {"block": b, "clients": 4, "released": n} for b, n in enumerate(RELEASED)]
    for blk in blocks:
        assert len(children(tracer, blk, "round.local_steps")) == 1
        assert len(children(tracer, blk, "round.aggregate")) == 1
    assert len(tracer.spans("round.local_steps")) == len(tracer.spans("round.aggregate")) == 2
    (close,) = tracer.spans("round.server_update")
    assert close.parent_id == train.span_id
    inner = ("round.block", "round.local_steps", "round.aggregate", "round.server_update")
    assert all(under(tracer, s, train) for s in tracer.spans() if s.name in inner)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_select_child_spans(path):
    tracer = SpanTracer()
    run_task(tiny_task(f"select_{path}", **PATHS[path]), tracer)
    (select,) = tracer.spans("round.train.select")
    prefix = "round.train.select."
    got = {s.name[len(prefix):] for s in tracer.spans() if s.parent_id == select.span_id}
    assert got == SELECT[path]
    for s in children(tracer, select):
        assert select.start_s <= s.start_s
        assert s.start_s + s.duration_s <= select.start_s + select.duration_s


def test_bridge_stage_spans():
    tracer = SpanTracer()
    run_task(tiny_task("bridge_spans", **PATHS["resident"]), tracer)
    (build,) = tracer.spans("bridge.build")
    assert build.parent_id is None
    stages = [s.name for s in sorted(children(tracer, build), key=lambda s: s.start_s)]
    assert stages == ["bridge.model", "bridge.populations", "bridge.runner"]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_disabled_tracer_records_nothing_and_changes_no_bit(path):
    on, off = SpanTracer(), SpanTracer(enabled=False)
    task = tiny_task(f"off_{path}", rounds=2, **PATHS[path])
    a, b = run_task(task, on), run_task(task, off)
    assert on.spans("round.block") and not off.spans()
    for k, v in a.states["data_0"].params.items():
        assert torch.equal(v, b.states["data_0"].params[k]), k
    assert ([h["train"]["data_0"]["mean_loss"] for h in a.history]
            == [h["train"]["data_0"]["mean_loss"] for h in b.history])


def _span_device_time():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    import span_device_time as sdt
    return sdt


def _synthetic_trace(mark):
    """A profiler file's events and a span file's, on one time base."""
    def host(corr, ts):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "dur": 1, "args": {"correlation": corr}}

    def kernel(corr, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    spans = [{"ph": "X", "name": "round.train.train", "ts": 100, "dur": 100},
             {"ph": "X", "name": "round.block", "ts": 110, "dur": 60},
             {"ph": "X", "name": "round.local_steps", "ts": 120, "dur": 20},
             {"ph": "X", "name": "round.aggregate", "ts": 150, "dur": 10}]
    trace = [{"ph": "X", "cat": "user_annotation", "name": mark, "ts": 50, "dur": 250},
             host(1, 125), kernel(1, 400, 7),     # runs long after its span closed
             host(2, 155), kernel(2, 410, 5),
             host(3, 115), kernel(3, 420, 3),     # the block, between its children
             host(4, 180), kernel(4, 430, 2),     # the round, after the block
             host(5, 60), kernel(5, 440, 11),     # inside the mark, outside every span
             host(6, 10), kernel(6, 450, 13)]     # before the mark: left out
    return trace, spans


def test_device_time_goes_to_the_innermost_span_by_launch():
    """``scripts/span_device_time.py``: a device event counts under the
    innermost span holding its host call's start, whenever it ran; one
    launched outside every span is unattributed; one launched outside the
    mark is left out."""
    sdt = _span_device_time()
    trace, spans = _synthetic_trace(sdt.MARK)
    got = sdt.attribute(trace, spans, sdt.MARK)
    assert got == {"round.local_steps": 7, "round.aggregate": 5, "round.block": 3,
                   "round.train.train": 2, sdt.OUTSIDE: 11}
    assert sdt.attribute(trace, spans)[sdt.OUTSIDE] == 24
    assert sdt.busy_us(trace, sdt.MARK) == (28, [None])


def test_span_device_time_reads_a_trace_directory(tmp_path, capsys):
    """``span_device_time.py --logdir`` reads the two files a
    ``PerformanceManager`` trace writes and prints device ms per round by
    span, the share under a span and the busy union."""
    from olearning_sim_tpu_torch.performancemgr import PerformanceManager

    sdt = _span_device_time()
    trace, spans = _synthetic_trace(sdt.MARK)
    (tmp_path / PerformanceManager.TRACE_FILE).write_text(json.dumps({"traceEvents": trace}))
    (tmp_path / PerformanceManager.RUNNER_SPAN_FILE).write_text(
        json.dumps({"traceEvents": spans}))
    assert sdt.main(["--logdir", str(tmp_path)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["rounds"] == 1
    assert got["device_ms_per_round"] == {"round.local_steps": 0.007, sdt.OUTSIDE: 0.011,
                                          "round.aggregate": 0.005, "round.block": 0.003,
                                          "round.train.train": 0.002}
    assert got["under_a_span"] == pytest.approx(17 / 28)
    assert got["device_sum_ms_per_round"] == pytest.approx(0.028)
    assert got["device_busy_ms_per_round"] == pytest.approx(0.028)
