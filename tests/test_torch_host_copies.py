"""The port's copies of the JAX package's host modules against their
originals on the same inputs, with exact equality: the trace compiler, the
quarantine manager, fault plans, the resilience and quarantine parsers, the
operator-flow barriers, the task-JSON codec and the telemetry catalog."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from olearning_sim_tpu.deviceflow import trace_compiler as jtc
from olearning_sim_tpu.resilience import faults as jfaults
from olearning_sim_tpu.resilience import policy as jpolicy
from olearning_sim_tpu.resilience import quarantine as jq
from olearning_sim_tpu.resilience.events import ResilienceLog as JLog
from olearning_sim_tpu.taskmgr import codecs as jcodecs
from olearning_sim_tpu.taskmgr import operator_flow as jflow
from olearning_sim_tpu import telemetry as jtel
from olearning_sim_tpu_torch.deviceflow import trace_compiler as ttc
from olearning_sim_tpu_torch.resilience import faults as tfaults
from olearning_sim_tpu_torch.resilience import policy as tpolicy
from olearning_sim_tpu_torch.resilience import quarantine as tq
from olearning_sim_tpu_torch.resilience.events import ResilienceLog as TLog
from olearning_sim_tpu_torch.taskmgr import codecs as tcodecs
from olearning_sim_tpu_torch.taskmgr import operator_flow as tflow
from olearning_sim_tpu_torch import telemetry as ttel

import torch_threads  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").glob("*.json"))


def _flow(inner):
    return {"flow_dispatch": dict({"use_strategy": True}, **inner)}


def _timing(total, timings, amounts, drop=None, time_type="relative"):
    spec = {"use": True, "time_type": time_type, "timings": timings, "amounts": amounts}
    if drop:
        spec["drop_simulation"] = drop
    return _flow({"total_dispatch_amount": total, "specific_timing": spec})


def _interval(total, intervals, domains, functions, drop=None):
    spec = {"use": True, "time_type": "relative", "intervals": intervals,
            "dispatch_rules": {"domains": domains, "functions": functions}}
    if drop:
        spec["drop_simulation"] = drop
    return _flow({"total_dispatch_amount": total, "specific_interval": spec})


def _distilbert_strategy():
    cfg = json.loads((REPO / "configs/fedadam_sent140_distilbert.json").read_text())
    return cfg["operatorflow"]["operators"][0]["operation_behavior_controller"][
        "strategy_gradient_house"]


STRATEGIES = {
    "none": None,
    "real_time": {"real_time_dispatch": {"use_strategy": True,
                                         "drop_simulation": {"drop_probability": 0.3}}},
    "timing": _timing(60, [0, 5, 10], [10, 20, 30]),
    "timing_drop_amounts": _timing(100, [0], [100], drop={"drop_amounts": [30]}),
    "timing_drop_probability": _timing(40, [0, 1], [20, 20],
                                       drop={"drop_probability": [0.5, 0.5]}),
    "timing_surplus": _timing(200, [0, 1], [100, 100]),
    "interval_sine": _interval(80, [[0, 20]], [[0.0, 20.0]], ["math.sin(t/3.0)+1.1"],
                               drop={"drop_probability": [0.1]}),
    "interval_two_pieces": _interval(50, [[0, 10], [10, 30]], [[0.0, 1.0], [0.0, 2.0]],
                                     ["1.0", "t*t"], drop={"drop_amounts": [3, 5]}),
    "disabled": _flow({"use_strategy": False}),
    "distilbert": _distilbert_strategy(),
}


def _assert_trace_equal(a, b):
    for f in ("participate", "arrival_time", "dropped"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.num_released == b.num_released
    assert a.num_dropped == b.num_dropped
    assert a.round_duration() == b.round_duration()


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_compile_trace_identical(name):
    strategy = STRATEGIES[name]
    rounds = range(5) if name == "distilbert" else range(2)
    for n, r in [(n, r) for n in (0, 7, 100) for r in rounds]:
        kw = dict(task_id="task", operator="train", seed=3)
        _assert_trace_equal(jtc.compile_trace(strategy, n, r, **kw),
                            ttc.compile_trace(strategy, n, r, **kw))


def test_distilbert_strategy_releases_and_drops():
    traces = [ttc.compile_trace(STRATEGIES["distilbert"], 64, r, seed=0) for r in range(5)]
    assert all(t.num_released > 0 and t.num_dropped > 0 for t in traces)


def test_combine_traces_identical():
    a = jtc.compile_trace(STRATEGIES["timing_drop_amounts"], 100, 0, seed=1)
    b = jtc.compile_trace(STRATEGIES["real_time"], 100, 1, seed=2)
    ta = ttc.ClientTrace(a.participate, a.arrival_time, a.dropped)
    tb = ttc.ClientTrace(b.participate, b.arrival_time, b.dropped)
    _assert_trace_equal(jtc.combine_traces(a, b), ttc.combine_traces(ta, tb))
    with pytest.raises(ValueError):
        ttc.combine_traces(ta, ttc.compile_trace(None, 5, 0))


# -------------------------------------------------------------- quarantine
def _quarantine_run(mod, log_cls):
    log = log_cls()
    qm = mod.QuarantineManager(quarantine_after=2, readmit_after=2, log=log, task_id="t")
    qm.preseed("p1", [4], 6, rounds=3)
    rng = np.random.default_rng(0)
    out = []
    for r in range(6):
        part = rng.random(10) < 0.8
        ok = rng.random(10) < 0.6
        flagged = rng.random(10) < 0.1 if r % 2 else None
        newly = qm.observe("p0", r, part, ok, flagged=flagged)
        qm.observe("p1", r, part[:6], ok[:6])
        out.append((newly, qm.active_mask("p0", 10).tolist(), qm.quarantined("p0"),
                    qm.quarantined("p1"), qm.num_quarantined(),
                    json.dumps(qm.state_json(), sort_keys=True)))
        if r == 2:
            snap = qm.snapshot()
    qm.restore(snap)
    out.append(json.dumps(qm.state_json(), sort_keys=True))
    fresh = mod.QuarantineManager(log=log_cls())
    fresh.load_json(qm.state_json())
    out.append(json.dumps(fresh.state_json(), sort_keys=True))
    events = [(e.kind, e.round_idx, json.dumps(e.detail, sort_keys=True))
              for e in log.events()]
    return out, events, log.counters("t")


def test_quarantine_manager_identical():
    assert _quarantine_run(jq, JLog) == _quarantine_run(tq, TLog)


# ------------------------------------------------------------------ faults
PLAN = {"seed": 11, "specs": [
    {"point": "runner.round_begin", "times": 2, "after": 1},
    {"point": "runner.poison_clients", "times": -1, "probability": 0.4,
     "error": "nan", "payload": {"clients": [1, 2]}},
    {"point": "storage.upload", "match": "model", "rounds": [1, 3], "times": -1},
    {"point": "runner.pre_checkpoint", "error": "preempt"},
]}


def _fire_sequence(mod, log_cls):
    log = log_cls()
    inj = mod.FaultInjector(mod.FaultPlan.from_dict(PLAN), log=log)
    seq = []
    for r in range(6):
        for point, ctx in (("runner.round_begin", str(r)), ("runner.poison_clients", ""),
                           ("storage.upload", "model.bin"), ("storage.upload", "data"),
                           ("runner.pre_checkpoint", str(r))):
            spec = inj.fire(point, context=ctx, round_idx=r, task_id="t")
            seq.append(None if spec is None else (spec.point, spec.error, spec.payload))
    return seq, log.counters(), mod.FaultPlan.from_dict(PLAN).to_json()


def test_fault_plan_firing_identical():
    assert _fire_sequence(jfaults, JLog) == _fire_sequence(tfaults, TLog)


def test_fault_exceptions_and_global_injector():
    spec = tfaults.FaultSpec(point="x", error="preempt")
    assert isinstance(tfaults.exception_for(spec, "x", ""), tfaults.HostPreemption)
    assert type(jfaults.exception_for(jfaults.FaultSpec(point="x"), "x", "")).__name__ \
        == type(tfaults.exception_for(tfaults.FaultSpec(point="x"), "x", "")).__name__
    plan = tfaults.FaultPlan([tfaults.FaultSpec(point="runner.round_begin")])
    with tfaults.chaos(plan, log=TLog()):
        with pytest.raises(tfaults.FaultError):
            tfaults.inject("runner.round_begin")
        # A plan armed in the port does not reach the JAX package's injector.
        assert jfaults.active_injector() is None
    assert tfaults.active_injector() is None


# ------------------------------------------------------------------ parsers
RESILIENCE_OK = [
    {},
    {"failure_policy": "retry", "max_round_retries": 3, "round_backoff_s": 0.5},
    {"failure_policy": "skip_round", "quarantine_after": None, "readmit_after": 5},
    {"failure_policy": "fail_task", "snapshot_rounds": False,
     "rpc_retry": {"max_attempts": 4, "base_delay": 0.01}},
]
RESILIENCE_BAD = [{"failure_policy": "explode"}, {"max_round_retries": "x"},
                  {"rpc_retry": {"nope": 1}}]


def _resilience_view(cfg):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["failure_policy"] = cfg.failure_policy.value
    rpc = d.pop("rpc_retry")
    d["rpc_retry"] = None if rpc is None else (rpc.max_attempts, rpc.base_delay,
                                               list(rpc.delays()))
    return d


@pytest.mark.parametrize("obj", RESILIENCE_OK)
def test_resilience_config_identical(obj):
    assert (_resilience_view(jpolicy.ResilienceConfig.from_dict(obj))
            == _resilience_view(tpolicy.ResilienceConfig.from_dict(obj)))


@pytest.mark.parametrize("obj", RESILIENCE_BAD)
def test_resilience_config_rejects_as_jax(obj):
    errors = []
    for mod in (jpolicy, tpolicy):
        with pytest.raises(Exception) as e:
            mod.ResilienceConfig.from_dict(obj)
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("obj", [
    {}, {"preseed": {}}, {"preseed": {"data_0": [3, 7], "data_1": []}},
    [], {"blocklist": {}}, {"preseed": []}, {"preseed": {"": [1]}},
    {"preseed": {"d": 3}}, {"preseed": {"d": [True]}}, {"preseed": {"d": [-1]}},
])
def test_parse_quarantine_params_identical(obj):
    outs = []
    for mod in (jq, tq):
        try:
            outs.append(("ok", mod.parse_quarantine_params(obj)))
        except (TypeError, ValueError) as e:
            outs.append((type(e).__name__, str(e)))
    assert outs[0] == outs[1]


# ---------------------------------------------------------- operator flow
def _flag_barrier_run(mod, flag):
    flag.write_text("done")
    flow = mod.OperatorFlowController(
        "t", 1, start_params={"strategy": "sample_and_aggregation"},
        stop_params={"strategy": "sample_and_aggregation",
                     "wait_interval": 0.01, "total_timeout": 1},
        strategy_kwargs={"flag_path": str(flag)})
    out = [flow.start(), flow.stop(), flag.exists()]
    flow.stop_params["total_timeout"] = 0.03
    out.append(flow.stop())
    return out


def _polling_barrier_run(mod):
    rounds = iter([5, None, 5, 6])
    flow = mod.OperatorFlowController(
        "t", 1,
        start_params={"strategy": "waiting_for_global_aggregation",
                      "wait_interval": 0.001, "total_timeout": 1},
        stop_params={"strategy": "waiting_for_global_aggregation",
                     "wait_interval": 0.001, "total_timeout": 1},
        strategy_kwargs={"round_provider": lambda: next(rounds)})
    return [flow.start(), flow.current_round, flow.stop(), flow.current_round]


def _other_barriers_run(mod):
    out = []
    flow = mod.OperatorFlowController("t", 3)
    out += [flow.start(), flow.stop(), flow.current_round]
    unknown = mod.OperatorFlowController("t", 3, start_params={"strategy": "bogus"})
    out.append(unknown.start())
    return out


def test_operator_flow_barriers_identical(tmp_path):
    assert (_flag_barrier_run(jflow, tmp_path / "a.txt")
            == _flag_barrier_run(tflow, tmp_path / "b.txt") == [True, True, False, False])
    assert _polling_barrier_run(jflow) == _polling_barrier_run(tflow) == [True, 5, True, 6]
    assert _other_barriers_run(jflow) == _other_barriers_run(tflow) == [True, True, 0, False]


def test_operator_flow_stop_event_and_websocket_refusal():
    import threading

    ev = threading.Event()
    ev.set()
    flow = tflow.OperatorFlowController(
        "t", 1, stop_params={"strategy": "waiting_for_global_aggregation",
                             "wait_interval": 0.01, "total_timeout": 5},
        strategy_kwargs={"round_provider": lambda: None}, stop_event=ev)
    assert flow.stop() is False
    # A selection service that does not answer (the websocket provider,
    # item A16): both packages' barriers give up at the timeout.
    started = [mod.OperatorFlowController(
        "t", 1, start_params={"strategy": "waiting_for_global_aggregation"},
        strategy_kwargs={"selection_url": "ws://localhost:1"}).start()
        for mod in (jflow, tflow)]
    assert started == [False, False]


# ------------------------------------------------------------------ codec
def _compare_config(port, ref, path="tc"):
    """Every field of the port's dataclass against the protobuf's."""
    if dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            _compare_config(getattr(port, f.name), getattr(ref, f.name), f"{path}.{f.name}")
    elif isinstance(port, list):
        ref = list(ref)
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _compare_config(a, b, f"{path}[{i}]")
    else:
        assert type(port) is type(ref) and port == ref, (path, port, ref)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_json2taskconfig_matches_jax(path):
    text = path.read_text()
    port = tcodecs.json2taskconfig(text)
    _compare_config(port, jcodecs.json2taskconfig(text))
    assert tcodecs.json2taskconfig(json.loads(text)) == port


def test_json2taskconfig_defaults_match_jax():
    obj = {"task_id": "bare", "operatorflow": {"operators": [{"name": "op", "input": ""}]},
           "target": {"data": [{}]}}
    _compare_config(tcodecs.json2taskconfig(obj), jcodecs.json2taskconfig(obj))


# -------------------------------------------------------------- telemetry
def test_catalog_entries_identical_to_jax():
    assert ttel.CATALOG
    for name, spec in ttel.CATALOG.items():
        assert jtel.CATALOG[name] == spec, name


def test_port_instruments_a_jax_registry():
    """A JAX registry handed in receives the port's series (duck typing)."""
    reg = jtel.MetricsRegistry()
    ttel.instrument("ols_engine_rounds_total", reg).labels(task_id="t", status="ok").inc()
    jtel.instrument("ols_engine_rounds_total", reg).labels(task_id="t", status="ok").inc()
    ttel.instrument("ols_engine_round_phase_duration_seconds", reg).labels(
        task_id="t", operator="train", phase="train").observe(0.2)
    assert reg.get("ols_engine_rounds_total").labels(task_id="t", status="ok").value == 2
    assert reg.get("ols_engine_round_phase_duration_seconds").buckets == tuple(
        sorted(ttel.CATALOG["ols_engine_round_phase_duration_seconds"][3]))
