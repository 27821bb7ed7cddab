"""Convergence tracking in the port, after tests/test_convergence.py: the
port's ConvergenceTracker fed JAX's observations gives JAX's record and
history states, ConvergenceConfig parses and refuses as JAX's does, the port
runner on a narrowed fedavg_mnist_mlp_convergence evaluates at the JAX
runner's rounds with the same record keys (no simulated clock, so no
simulated time to target), and a resumed or rolled-back run gives the
uninterrupted run's record under strip_wall."""

import dataclasses
import json
import threading

import pytest

import torch_threads  # noqa: F401
from test_torch_runner import EVAL_N, _run_jax, _run_port, _series
from test_torch_task_bridge import engine_params, load, set_engine_params, shrink

from olearning_sim_tpu_torch.engine import convergence as tconv
from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
from olearning_sim_tpu_torch.resilience import faults as tfaults

# (method, args) sequences fed to both trackers.
SCRIPTS = {
    "no_sim_clock": [("round", 0, 0.0, 0.5), ("round", 1, 0.0, 0.25), ("eval", 1, 1.2, 0.4),
                     ("round", 2, 0.0, 0.5), ("round", 3, 0.0, 0.5), ("eval", 3, 0.9, 0.95)],
    "sim_clock": [("round", 0, 30.0, 0.5), ("eval", 0, None, 0.2), ("round", 1, 45.5, 0.5),
                  ("eval", 1, 0.7, 0.93), ("round", 2, 12.0, 0.1), ("eval", 2, 0.6, 0.97)],
    "never_reached": [("round", r, 10.0, 0.1) for r in range(3)] + [("eval", 2, 1.0, 0.5)],
    "empty": [("round", 0, 0.0, 0.1)],
}
CONFIGS = {
    "no_sim_clock": {"target_accuracy": 0.9, "eval_every": 2, "round_budget": 2,
                     "sim_seconds_budget": 50.0, "wall_seconds_budget": 1.0},
    "sim_clock": {"target_accuracy": 0.9, "round_budget": 2, "sim_seconds_budget": 80.0},
    "never_reached": {"target_accuracy": 0.9, "eval_every": 3},
    "empty": {},
}


def _feed(module, name):
    tracker = module.ConvergenceTracker(module.ConvergenceConfig.from_dict(CONFIGS[name]))
    states, hits = [], []
    for op, r, a, b in SCRIPTS[name]:
        if op == "round":
            tracker.observe_round(r, a, b)
            states.append(tracker.state_json())
        else:
            hits.append(tracker.observe_eval(r, a, b))
    return tracker, states, hits


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_tracker_matches_jax(name):
    from olearning_sim_tpu.engine import convergence as jconv

    jt, jstates, jhits = _feed(jconv, name)
    tt, tstates, thits = _feed(tconv, name)
    assert tt.record() == jt.record()
    assert tconv.strip_wall(tt.record()) == jconv.strip_wall(jt.record())
    assert tstates == jstates and thits == jhits
    assert [tt.should_eval(r, 4) for r in range(4)] == [jt.should_eval(r, 4) for r in range(4)]
    # Each rebuilds the other's record from the other's history states.
    jback, tback = jconv.ConvergenceTracker(jt.config), tconv.ConvergenceTracker(tt.config)
    jback.load_history(tstates)
    tback.load_history(jstates)
    assert tback.record() == jback.record()


@pytest.mark.parametrize("obj", [
    {"target_accuracy": "0.5", "eval_every": "3", "round_budget": 4.0},
    {"eval_every": 0}, {"target_accuracy": 1.5}, {"round_budget": -1},
    {"sim_seconds_budget": 0}, {"every": 2}, {"enabled": False},
])
def test_config_parses_as_jax(obj):
    from olearning_sim_tpu.engine import convergence as jconv

    try:
        want = jconv.ConvergenceConfig.from_dict(obj)
    except ValueError:
        with pytest.raises(ValueError):
            tconv.ConvergenceConfig.from_dict(obj)
        return
    got = tconv.ConvergenceConfig.from_dict(obj)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _convergence_task(task_id, rounds=6, evaluate=True, **conv):
    """The config narrowed to 8 clients and ``rounds`` rounds, evaluating
    every second round."""
    task = shrink(load("fedavg_mnist_mlp_convergence"), rounds=rounds)
    task["task_id"] = task_id
    params = engine_params(task)
    params["convergence"].update(dict({"eval_every": 2}, **conv))
    params["data"]["eval_n"] = EVAL_N
    if not evaluate:
        task["operatorflow"]["operators"] = task["operatorflow"]["operators"][:1]
    return set_engine_params(task, params)


@pytest.mark.parametrize("evaluate", [True, False], ids=["eval_operator", "direct_eval"])
def test_runner_record_matches_jax(evaluate):
    """The JAX runner and the port's on the same task (the port from JAX's
    init parameters and minibatch draws): eval points at the same rounds,
    the same record keys and series, accuracy within two of EVAL_N rows,
    and no simulated clock (no pacing), so no simulated time to target."""
    from olearning_sim_tpu.engine.convergence import strip_wall
    from olearning_sim_tpu.telemetry import MetricsRegistry

    registry = MetricsRegistry()
    jtask = _convergence_task("conv_jax", evaluate=evaluate, target_accuracy=0.05)
    ttask = _convergence_task("conv_port", evaluate=evaluate, target_accuracy=0.05)
    jrunner, _, jhist, init = _run_jax(jtask, registry)
    trunner, _, thist = _run_port(ttask, registry, init)
    jrec, trec = jrunner.convergence_record(), trunner.convergence_record()
    assert sorted(trec) == sorted(jrec)
    assert [e["round"] for e in trec["evals"]] == [e["round"] for e in jrec["evals"]] == [1, 3, 5]
    for je, te in zip(jrec["evals"], trec["evals"]):
        assert sorted(te) == sorted(je)
        assert abs(te["acc"] - je["acc"]) <= 2 / EVAL_N
    for rec in (jrec, trec):
        assert rec["sim_seconds_to_target"] is None and rec["accuracy_at_sim_budget"] is None
        assert rec["reached"] and rec["rounds_to_target"] == 2
    stripped = {k for k in strip_wall(trec) if k != "evals"}
    for k in stripped - {"final_accuracy", "best_accuracy", "final_loss",
                         "accuracy_at_round_budget"}:
        assert trec[k] == jrec[k], k
    assert [sorted(h["convergence_state"]) for h in thist] == \
        [sorted(h["convergence_state"]) for h in jhist]
    jseries, tseries = _series(registry, "conv_jax"), _series(registry, "conv_port")
    assert sorted(tseries) == sorted(jseries)
    key = ("ols_engine_rounds_to_target", ())
    assert tseries[key] == jseries[key] == 2
    assert ("ols_engine_time_to_target_seconds", (("clock", "sim"),)) not in tseries


def test_resumed_run_gives_the_same_record(tmp_path):
    """Stopped after round 3 (the stop fence commits it) and resumed by a
    fresh runner: the record equals the uninterrupted run's under
    strip_wall, and the committed rounds' wall clocks are the first run's."""
    straight = build_runner_from_taskconfig(_convergence_task("conv_resume"), device="cpu")
    straight.run()
    task = _convergence_task("conv_resume")
    params = engine_params(task)
    params["checkpoint"] = {"directory": str(tmp_path / "{task_id}"), "every": 5}
    set_engine_params(task, params)
    stop = threading.Event()
    first = build_runner_from_taskconfig(task, stop_event=stop, device="cpu")
    first.begin()
    for _ in range(4):
        first.step()
    stop.set()
    assert not first.step()
    first.finish()
    committed = first.convergence_record()
    resumed = build_runner_from_taskconfig(task, device="cpu")
    resumed.begin()
    assert resumed._loop["round_idx"] == 4
    assert resumed.convergence_record() == committed
    while resumed.step():
        pass
    resumed.finish()
    record = resumed.convergence_record()
    assert tconv.strip_wall(record) == tconv.strip_wall(straight.convergence_record())
    assert record["evals"][:2] == committed["evals"]


def test_rolled_back_round_replays_the_record():
    """A preemption after round 3's eval point (before its checkpoint)
    rolls back to the round's snapshot: the replayed round re-emits its
    point once, and the record equals a clean run's under strip_wall."""
    clean = build_runner_from_taskconfig(_convergence_task("conv_rb"), device="cpu")
    clean.run()
    task = _convergence_task("conv_rb")
    params = engine_params(task)
    params["resilience"] = {"failure_policy": "retry"}
    set_engine_params(task, params)
    runner = build_runner_from_taskconfig(task, device="cpu")
    plan = {"seed": 0, "specs": [{"point": "runner.pre_checkpoint", "rounds": [3],
                                  "error": "preempt"}]}
    with tfaults.chaos(tfaults.FaultPlan.from_dict(plan)):
        runner.run()
    record = runner.convergence_record()
    assert [e["round"] for e in record["evals"]] == [1, 3, 5]
    assert tconv.strip_wall(record) == tconv.strip_wall(clean.convergence_record())


def test_no_eval_data_leaves_the_series_empty():
    task = _convergence_task("conv_none", rounds=2, evaluate=False)
    params = engine_params(task)
    params["data"].pop("eval_n")
    runner = build_runner_from_taskconfig(set_engine_params(task, params), device="cpu")
    runner.run()
    record = runner.convergence_record()
    assert record["evals"] == [] and record["rounds_observed"] == 2
    assert json.dumps(record)  # JSON-safe
    assert build_runner_from_taskconfig(shrink(load("fedavg_mnist_mlp")),
                                        device="cpu").convergence_record() is None
