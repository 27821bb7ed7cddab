"""Deadline rounds in the port's runner and bridge, after
tests/test_deadline.py, against the JAX runner on the same small task (the
port from JAX's init parameters and minibatch draws, as in
tests/test_torch_runner.py):

- host outputs agree exactly: the cohort, on-time and straggler counts, the
  deadline, the round close and idle time, the adaptive controller's state,
  the quarantine state, the resilience events and the counters; numbers
  within the mlp2 bounds of tests/test_torch_runner.py;
- a quorum miss (``runner.straggler_spike``) under ``skip_round`` records
  ``deadline_miss`` and skips the round, as in JAX;
- the convergence clock reads ``round_close_s`` before ``sim_duration_s``:
  a deadline task's record has the JAX runner's simulated seconds exactly;
- a defended, attacked and deadlined run that is preempted, or stopped, and
  resumed by a fresh runner from its checkpoints equals the uninterrupted
  run bitwise (params, quarantine and pacing state);
- the bridge hands the deadline and defense blocks to the runner (its
  refusals of malformed ones are in tests/test_torch_task_bridge.py)."""

import json

import jax
import numpy as np
import pytest

import torch_threads  # noqa: F401
from test_torch_checkpoint import _assert_same_state
from test_torch_runner import (
    ACC_ATOL,
    LOSS_ATOL,
    PARAM_ATOL,
    _phase_counts,
    _run_jax,
    _run_port,
    _series,
    task_json,
)
from test_torch_task_bridge import engine_params, set_engine_params

from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
from olearning_sim_tpu_torch.resilience import HostPreemption
from olearning_sim_tpu_torch.resilience import faults as tfaults
from olearning_sim_tpu_torch.weights import params_from_jax

# task_json's 12 clients: 6 "high" running 3 local steps, 6 "low" running
# 1; its dispatch strategy releases 6 at t = 0 and 4 at t = 2 and drops
# some. Over-selection picks 9 of the released, the round closes at the
# earlier of the controller's deadline and the 6th arrival, and a quorum
# of 3 must be on time.
DEADLINE = {"deadline_s": 0.45, "over_selection": 0.5, "target_cohort": 6,
            "quorum_fraction": 0.5, "speed_profiles": {"high": 0.05, "low": 0.3},
            "default_step_s": 0.1, "jitter": 0.2, "adaptive": True,
            "target_completion_fraction": 0.85}
PACE_KEYS = ("selected", "on_time", "stragglers", "deadline_s", "round_close_s", "idle_s")
HOST_KEYS = ("released", "dropped", "clients_trained", "sim_duration_s") + PACE_KEYS + (
    "attacked", "attack_mode", "clipped", "flagged")


def robust_task(task_id, rounds=3, resilience=None, evaluate=True, **blocks):
    """task_json with engine-params blocks added (deadline, defense,
    checkpoint, convergence, quarantine)."""
    task = task_json(task_id, rounds=rounds, resilience=resilience, evaluate=evaluate)
    params = engine_params(task)
    params.update(blocks)
    return set_engine_params(task, params)


def _events(repo, task_id):
    res = json.loads(repo.get_item_value(task_id, "resilience") or '{"counters": {}}')
    events = []
    for e in res.get("recent_events", []):
        detail = dict(e["detail"])
        detail.pop("median_score", None)  # a median of bf16-computed scores
        events.append((e["kind"], e["round_idx"], detail))
    return res["counters"], events


def compare_with_jax(name, chaos=None, rounds=3, resilience=None, **blocks):
    """The task under ``blocks`` and ``chaos`` through the JAX runner and
    the port's; asserts the host outputs equal and the numbers close, and
    returns the port's (runner, history)."""
    from olearning_sim_tpu.telemetry import MetricsRegistry

    registry = MetricsRegistry()
    jtask = robust_task(f"{name}_jax", rounds, resilience, **blocks)
    ttask = robust_task(f"{name}_port", rounds, resilience, **blocks)
    jrunner, jrepo, jhist, init = _run_jax(jtask, registry, chaos)
    trunner, trepo, thist = _run_port(ttask, registry, init, chaos)
    jid, tid = jtask["task_id"], ttask["task_id"]
    for col in ("logical_target", "logical_result", "logical_round", "logical_operator"):
        assert trepo.get_item_value(tid, col) == jrepo.get_item_value(jid, col), col
    assert _events(trepo, tid) == _events(jrepo, jid)
    assert _series(registry, tid) == _series(registry, jid)
    assert _phase_counts(registry, tid) == _phase_counts(registry, jid)
    assert [sorted(h) for h in thist] == [sorted(h) for h in jhist]
    for jr, tr in zip(jhist, thist):
        for k in ("quarantine_state", "pacing", "skipped", "error"):
            assert tr.get(k) == jr.get(k), (jr["round"], k)
        if jr.get("skipped"):
            continue
        j, t = jr["train"]["data_0"], tr["train"]["data_0"]
        assert sorted(t) == sorted(j)
        for k in HOST_KEYS:
            assert t.get(k) == j.get(k), (jr["round"], k)
        assert abs(t["mean_loss"] - j["mean_loss"]) <= LOSS_ATOL
        je, te = jr["evaluate"]["data_0"], tr["evaluate"]["data_0"]
        assert abs(te["eval_loss"] - je["eval_loss"]) <= LOSS_ATOL
        assert abs(te["eval_acc"] - je["eval_acc"]) <= ACC_ATOL
    jparams = params_from_jax(jax.tree.map(np.asarray, jrunner.states["data_0"].params))
    for k, v in jparams.items():
        np.testing.assert_allclose(trunner.states["data_0"].params[k].numpy(), v.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
    return trunner, thist


def test_deadline_rounds_match_jax():
    _, hist = compare_with_jax("deadline", rounds=4, deadline=DEADLINE,
                               resilience={"failure_policy": "skip_round"})
    recs = [h["train"]["data_0"] for h in hist]
    # The fixture exercises what it names: over-selection, stragglers, a
    # binding close, and an adaptive deadline after round 0.
    assert all(r["selected"] <= 9 for r in recs)
    assert sum(r["stragglers"] for r in recs) > 0
    assert recs[0]["deadline_s"] == DEADLINE["deadline_s"]
    assert len({r["deadline_s"] for r in recs}) > 1
    assert all(h["pacing"]["ema"] is not None for h in hist)
    # Every selected client participates: the late ones are the
    # stragglers, the on-time ones train.
    assert all(r["stragglers"] == r["selected"] - r["on_time"] for r in recs)
    assert all(r["clients_trained"] == r["on_time"] for r in recs)


def test_quorum_miss_skips_the_round_as_jax():
    spike = {"seed": 0, "specs": [{"point": "runner.straggler_spike", "rounds": [1],
                                   "payload": {"factor": 100.0}}]}
    runner, hist = compare_with_jax("quorum", chaos=spike, deadline=DEADLINE,
                                    resilience={"failure_policy": "skip_round"})
    assert [bool(h.get("skipped")) for h in hist] == [False, True, False]
    assert hist[1]["error"].startswith("DeadlineMissError: round 1 population data_0: 0 on-time")
    summary = json.loads(runner.task_repo.get_item_value(runner.task_id, "resilience"))
    assert summary["counters"]["deadline_miss"] == 1
    assert summary["counters"]["skip_round"] == 1


def test_convergence_clock_reads_the_round_close():
    """A deadline task's convergence record holds the JAX runner's
    simulated seconds exactly: the sum of the rounds' round_close_s, not of
    their dispatch traces' durations."""
    conv = {"target_accuracy": 0.99, "eval_every": 1}
    jtask = robust_task("clock_jax", deadline=DEADLINE, convergence=conv)
    ttask = robust_task("clock_port", deadline=DEADLINE, convergence=conv)
    jrunner, _, jhist, init = _run_jax(jtask, None)
    trunner, _, thist = _run_port(ttask, None, init)
    closes = traces = 0.0
    for jh, th in zip(jhist, thist):
        rec = th["train"]["data_0"]
        closes += rec["round_close_s"]
        traces += rec["sim_duration_s"]
        ts, js = th["convergence_state"], jh["convergence_state"]
        assert ts["sim_seconds_total"] == js["sim_seconds_total"] == closes
        assert ts["evals_new"][0]["sim_s"] == js["evals_new"][0]["sim_s"] == closes
    assert closes != traces
    trec, jrec = trunner.convergence_record(), jrunner.convergence_record()
    assert [e["sim_s"] for e in trec["evals"]] == [e["sim_s"] for e in jrec["evals"]]


# ------------------------------------------------------------- resume
ROBUST = dict(
    deadline=DEADLINE,
    defense={"clip_norm": 2.0, "aggregator": "trimmed_mean", "trim_fraction": 0.2,
             "anomaly_threshold": 3.0, "quarantine_after": 1, "readmit_after": 2},
)
ATTACK = {"point": "runner.attack_clients", "times": -1,
          "payload": {"mode": "scale", "factor": -8.0, "clients": [0, 4, 8]}}


def _run(task, specs=(), **kw):
    runner = build_runner_from_taskconfig(task, device="cpu", **kw)
    with tfaults.chaos(tfaults.FaultPlan.from_dict({"seed": 1, "specs": list(specs)})):
        runner.run()
    return runner


def _same_run(a, b):
    _assert_same_state(a, b)
    assert a._quarantine.state_json() == b._quarantine.state_json()
    assert a._pacer.state_dict() == b._pacer.state_dict()
    assert a.history == json.loads(json.dumps(b.history, default=float))


@pytest.mark.parametrize("how", ["preempt", "stop"])
def test_robust_run_resumes_bitwise(how, tmp_path):
    import threading

    straight = _run(robust_task("robust_resume", rounds=5, evaluate=False, **ROBUST),
                    [ATTACK])
    hist = straight.history
    assert any(h["train"]["data_0"]["stragglers"] for h in hist)
    assert sum(h["train"]["data_0"]["flagged"] for h in hist) > 0
    assert straight._quarantine.quarantined("data_0")

    ckpt = {"directory": str(tmp_path / "{task_id}"), "every": 1}
    task = robust_task("robust_resume", rounds=5, evaluate=False, checkpoint=ckpt, **ROBUST)
    stop = threading.Event()
    first = build_runner_from_taskconfig(task, device="cpu", stop_event=stop)
    if how == "preempt":
        preempt = {"point": "runner.round_begin", "rounds": [3], "error": "preempt"}
        with tfaults.chaos(tfaults.FaultPlan.from_dict({"seed": 1,
                                                        "specs": [ATTACK, preempt]})):
            with pytest.raises(HostPreemption):
                first.run()
        # The commit thread may still be writing round 2's step.
        assert first.checkpointer.latest_round() == 2
    else:
        with tfaults.chaos(tfaults.FaultPlan.from_dict({"seed": 1, "specs": [ATTACK]})):
            first.begin()
            for _ in range(2):
                first.step()
            stop.set()
            assert not first.step()
            first.finish()
    resumed = build_runner_from_taskconfig(task, device="cpu")
    with tfaults.chaos(tfaults.FaultPlan.from_dict({"seed": 1, "specs": [ATTACK]})):
        resumed.begin()
        assert resumed._loop["round_idx"] == (3 if how == "preempt" else 2)
        while resumed.step():
            pass
        resumed.finish()
    _same_run(resumed, straight)


# ------------------------------------------------------------- the bridge
def test_robust_aggregation_with_scaffold_fails_its_rounds_as_jax():
    # Both bridges build the runner; each round's round_step refuses the
    # gathering defense, and the failure policy skips the round.
    _, hist = compare_with_jax("scaffold_median", rounds=2,
                               resilience={"failure_policy": "skip_round"},
                               defense={"aggregator": "median"},
                               algorithm={"name": "scaffold", "local_lr": 0.1})
    assert len(hist) == 2
    for rec in hist:
        assert rec["skipped"]
        assert "not supported with control-variate algorithms" in rec["error"]


def test_bridge_hands_the_blocks_to_the_runner():
    runner = build_runner_from_taskconfig(robust_task("blocks", **ROBUST), device="cpu")
    assert runner.deadline.target_cohort == 6 and runner.deadline.adaptive
    assert runner.defense.aggregator == "trimmed_mean"
    # No resilience quarantine: the scoring defense brings its own budget.
    assert runner._quarantine.quarantine_after == 1
    assert runner._quarantine.readmit_after == 2
    plain = build_runner_from_taskconfig(
        robust_task("off", deadline={}, defense={"aggregator": "mean"}), device="cpu")
    assert plain.deadline is None and plain.defense is None and plain._quarantine is None
