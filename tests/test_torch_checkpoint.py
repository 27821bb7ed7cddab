"""The port's RoundCheckpointer and the runner's resume path, after
tests/test_checkpoint.py: a port run preempted after round k and resumed by
a fresh runner equals the uninterrupted run bitwise (FedAvg, FedAdam with
its moments, SCAFFOLD's controls, Ditto's personal params; checkpoints
every round and every second round), a cooperative stop fences the last
round, torn steps fall back with the same resilience digest as the JAX
runner under the same chaos plan, and the JAX control plane's
TaskSupervisor relaunches a port task from its checkpoints."""

import json
import os
import threading
import time

import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_runner import task_json

from olearning_sim_tpu_torch.checkpoint import RoundCheckpointer
from olearning_sim_tpu_torch.engine.fedcore import ServerState
from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
from olearning_sim_tpu_torch.resilience import CHECKPOINT_FALLBACK, ROLLBACK, HostPreemption
from olearning_sim_tpu_torch.resilience import faults as tfaults
from olearning_sim_tpu_torch.resilience.events import global_log
from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo

ALGORITHMS = {
    "fedavg": {"name": "fedavg", "local_lr": 0.1},
    "fedadam": {"name": "fedadam", "local_lr": 0.1, "server_lr": 0.01},
    "scaffold": {"name": "scaffold", "local_lr": 0.1},
    "ditto": {"name": "ditto", "local_lr": 0.1, "lam": 0.5},
}


def _task(task_id, algorithm="fedavg", rounds=5, checkpoint=None, resilience=None):
    task = task_json(task_id, rounds=rounds, resilience=resilience)
    info = task["operatorflow"]["operators"][0]["logical_simulation"]
    params = json.loads(info["operator_params"])
    params["algorithm"] = ALGORITHMS[algorithm]
    if checkpoint is not None:
        params["checkpoint"] = checkpoint
    info["operator_params"] = json.dumps(params)
    return task


def _build(task, **kw):
    return build_runner_from_taskconfig(task, device="cpu", **kw)


def _leaves(runner):
    """Every tensor and integer of the runner's state, by path."""
    from olearning_sim_tpu_torch.checkpoint.checkpointer import _flatten

    return _flatten({"states": runner.states, "personal": runner.personal_states,
                     "control": runner.control_states})


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        else:
            assert x == y, path


@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("algorithm", sorted(ALGORITHMS))
def test_preempted_run_resumes_bitwise(algorithm, every, tmp_path):
    """Round 3 dies at its start (a host preemption, no failure policy):
    the fresh runner resumes from the last committed step (round 2 every
    round, round 1 every second round, replaying round 2) and ends with the
    uninterrupted run's state, bit for bit."""
    straight = _build(_task(f"ck_{algorithm}", algorithm))
    straight.run()

    ckpt = {"directory": str(tmp_path / "{task_id}"), "every": every}
    first = _build(_task(f"ck_{algorithm}", algorithm, checkpoint=ckpt))
    plan = {"seed": 0, "specs": [{"point": "runner.round_begin", "rounds": [3],
                                  "error": "preempt"}]}
    with tfaults.chaos(tfaults.FaultPlan.from_dict(plan)):
        with pytest.raises(HostPreemption):
            first.run()
    assert first.checkpointer.latest_round() == (2 if every == 1 else 1)

    resumed = _build(_task(f"ck_{algorithm}", algorithm, checkpoint=ckpt))
    resumed.begin()
    assert resumed._loop["round_idx"] == (3 if every == 1 else 2)
    while resumed.step():
        pass
    history = resumed.finish()
    _assert_same_state(resumed, straight)
    assert [h["round"] for h in history] == [0, 1, 2, 3, 4]
    assert history == json.loads(json.dumps(straight.history, default=float))
    if algorithm == "fedadam":
        opt = resumed.states["data_0"].opt_state
        assert opt["count"] == 5 and any(float(m.abs().sum()) > 0 for m in opt["mu"].values())


def test_stop_fences_the_last_round(tmp_path):
    """A cooperative stop after round 0 force-commits round 0 (the cadence
    would have saved round 1 next); a fresh runner resumes at round 1."""
    straight = _build(_task("fence"))
    straight.run()
    ckpt = {"directory": str(tmp_path / "{task_id}"), "every": 2}
    stop = threading.Event()
    first = _build(_task("fence", checkpoint=ckpt), stop_event=stop)
    first.begin()
    assert first.step()
    stop.set()
    assert not first.step()
    first.finish()
    assert first.stopped and first.checkpointer.latest_round() == 0
    resumed = _build(_task("fence", checkpoint=ckpt))
    history = resumed.run()
    assert [h["round"] for h in history] == [0, 1, 2, 3, 4]
    _assert_same_state(resumed, straight)


def test_finished_run_restores_and_has_nothing_left(tmp_path):
    ckpt = {"directory": str(tmp_path / "{task_id}"), "every": 1, "max_to_keep": 2}
    runner = _build(_task("done", rounds=4, checkpoint=ckpt))
    history = runner.run()
    steps = sorted(int(p.name) for p in (tmp_path / "done").iterdir() if p.name.isdigit())
    assert steps == [2, 3]  # max_to_keep bounds the disk
    manifests = sorted(p.name for p in (tmp_path / "done" / "manifests").iterdir())
    assert manifests == ["step-2.json", "step-3.json"]
    again = _build(_task("done", rounds=4, checkpoint=ckpt))
    assert again.run() == json.loads(json.dumps(history, default=float))
    _assert_same_state(again, runner)


def test_checkpointer_roundtrip_and_template(tmp_path):
    """save -> restore into a template: tensors, ints, floats, the history;
    a leaf of another type is refused at save."""
    ck = RoundCheckpointer(str(tmp_path / "ck"), max_to_keep=3, task_id="tmpl")
    state = ServerState(params={"w": torch.arange(6.0).reshape(2, 3)},
                        opt_state={"count": 3, "mu": {"w": torch.ones(2, 3)}},
                        round_idx=4, seed=9)
    ck.save(3, {"p": state}, {"p": {"c": torch.full((3,), 2.0), "v": [torch.zeros(2), 1.5]}},
            [{"round": 3, "x": 0.25}])
    ck.wait()
    assert ck.latest_round() == 3 and ck.verify_step(3) is True
    template = ServerState(params={"w": torch.zeros(2, 3)},
                           opt_state={"count": 0, "mu": {"w": torch.zeros(2, 3)}},
                           round_idx=0, seed=0)
    last, states, personal, history = ck.restore(
        {"p": template}, {"p": {"c": torch.zeros(3), "v": [torch.ones(2), 0.0]}})
    assert last == 3 and history == [{"round": 3, "x": 0.25}]
    got = states["p"]
    assert torch.equal(got.params["w"], state.params["w"])
    assert torch.equal(got.opt_state["mu"]["w"], state.opt_state["mu"]["w"])
    assert (got.opt_state["count"], got.round_idx, got.seed) == (3, 4, 9)
    assert torch.equal(personal["p"]["c"], torch.full((3,), 2.0))
    assert torch.equal(personal["p"]["v"][0], torch.zeros(2))
    assert personal["p"]["v"][1] == 1.5
    with pytest.raises(TypeError, match="p/g"):
        ck.save(4, {}, {"p": {"g": torch.Generator()}}, [])
    with pytest.raises(FileExistsError):
        ck.save(3, {"p": state}, {}, [])
    wrong = ServerState(params={"w": torch.zeros(3, 2)}, opt_state={}, round_idx=0, seed=0)
    log_before = global_log().count(CHECKPOINT_FALLBACK, "tmpl")
    assert ck.restore({"p": wrong}, {}) is None
    assert global_log().count(CHECKPOINT_FALLBACK, "tmpl") == log_before + 1
    assert ck.discard_steps_after(2) == [3] and ck.latest_round() is None
    ck.close()


def test_corrupt_step_is_skipped_by_its_manifest(tmp_path):
    ck = RoundCheckpointer(str(tmp_path / "ck"), task_id="torn")
    tree = {"p": {"w": torch.ones(64)}}
    ck.save(0, tree, {}, [{"round": 0}])
    plan = {"seed": 0, "specs": [{"point": "checkpoint.corrupt", "rounds": [1],
                                  "error": "corrupt"}]}
    with tfaults.chaos(tfaults.FaultPlan.from_dict(plan)):
        ck.save(1, {"p": {"w": torch.full((64,), 2.0)}}, {}, [{"round": 1}])
    ck.wait()
    assert ck.verify_step(1) is False and ck.verify_step(0) is True
    before = global_log().count(CHECKPOINT_FALLBACK, "torn")
    last, states, _, _ = ck.restore({"p": {"w": torch.zeros(64)}}, {})
    assert last == 0 and torch.equal(states["p"]["w"], torch.ones(64))
    assert global_log().count(CHECKPOINT_FALLBACK, "torn") == before + 1


def test_save_and_restore_series(tmp_path):
    from olearning_sim_tpu_torch.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    ck = RoundCheckpointer(str(tmp_path / "ck"), task_id="series", registry=reg)
    ck.save(0, {"p": {"w": torch.ones(10)}}, {}, [])
    ck.restore({"p": {"w": torch.zeros(10)}}, {})
    lab = {"task_id": "series"}
    assert reg.get("ols_checkpoint_save_bytes_total").labels(**lab).value == 40
    assert reg.get("ols_checkpoint_restore_bytes_total").labels(**lab).value == 40
    assert reg.get("ols_checkpoint_save_duration_seconds").labels(**lab).count == 1
    assert reg.get("ols_checkpoint_restore_duration_seconds").labels(**lab).count == 1


def test_save_failure_fails_the_round(tmp_path):
    """The ``checkpoint.save`` point fails the save inside the round: under
    retry the round rolls back and replays, and the run equals a clean one."""
    straight = _build(_task("savefail", rounds=3))
    straight.run()
    ckpt = {"directory": str(tmp_path / "{task_id}")}
    runner = _build(_task("savefail", rounds=3, checkpoint=ckpt,
                          resilience={"failure_policy": "retry"}))
    plan = {"seed": 0, "specs": [{"point": "checkpoint.save", "after": 1}]}
    before = global_log().count(ROLLBACK, "savefail")
    with tfaults.chaos(tfaults.FaultPlan.from_dict(plan)):
        runner.run()
    assert global_log().count(ROLLBACK, "savefail") == before + 1
    _assert_same_state(runner, straight)


CORRUPT_THEN_PREEMPT = {"seed": 0, "specs": [
    {"point": "checkpoint.corrupt", "rounds": [1], "error": "corrupt"},
    {"point": "runner.pre_checkpoint", "rounds": [2], "error": "preempt"}]}


def test_corrupt_then_preempt_digest_matches_jax(tmp_path):
    """checkpoint.corrupt tears round 1's step; a preemption at round 2
    falls back to round 0's step and replays rounds 1-2. The port's
    resilience digest counts what the JAX runner's does, and the port run
    equals a clean one."""
    import jax

    from olearning_sim_tpu.engine.task_bridge import build_runner_from_taskconfig as jbuild
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu.resilience import faults as jfaults
    from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo as JRepo

    res = {"failure_policy": "retry", "max_round_retries": 2}
    digests = {}
    jrepo = JRepo()
    jtask = _task("digest_jax", rounds=4, resilience=res,
                  checkpoint={"directory": str(tmp_path / "jax" / "{task_id}")})
    jrunner = jbuild(jtask, plan=make_mesh_plan(devices=jax.devices()[:1]), task_repo=jrepo)
    with jfaults.chaos(jfaults.FaultPlan.from_dict(CORRUPT_THEN_PREEMPT)):
        jrunner.run()
    digests["jax"] = json.loads(jrepo.get_item_value("digest_jax", "resilience"))
    trepo = TaskTableRepo()
    ttask = _task("digest_port", rounds=4, resilience=res,
                  checkpoint={"directory": str(tmp_path / "port" / "{task_id}")})
    trunner = _build(ttask, task_repo=trepo)
    with tfaults.chaos(tfaults.FaultPlan.from_dict(CORRUPT_THEN_PREEMPT)):
        history = trunner.run()
    digests["port"] = json.loads(trepo.get_item_value("digest_port", "resilience"))
    assert digests["port"]["counters"] == digests["jax"]["counters"]
    assert digests["port"]["counters"][CHECKPOINT_FALLBACK] == 1
    assert ([e["kind"] for e in digests["port"]["recent_events"]]
            == [e["kind"] for e in digests["jax"]["recent_events"]])
    assert [h["round"] for h in history] == [0, 1, 2, 3]
    clean = _build(_task("digest_port", rounds=4))
    clean.run()
    _assert_same_state(trunner, clean)


def test_supervisor_resumes_a_port_task(tmp_path):
    """The JAX control plane's TaskSupervisor reclaims a RUNNING row whose
    owner died (expired lease) and relaunches the task through its
    runner_factory: the port runner resumes from the checkpoints the dead
    run committed and ends equal to the uninterrupted run."""
    from olearning_sim_tpu.resilience import LEASE_EXPIRED, TASK_RESUMED, ResilienceLog
    from olearning_sim_tpu.supervisor import TaskSupervisor
    from olearning_sim_tpu.taskmgr.status import TaskStatus
    from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo as JRepo

    ckpt = {"directory": str(tmp_path / "{task_id}"), "every": 1}
    task = _task("sup_port", checkpoint=ckpt)
    straight = _build(_task("sup_port"))
    straight.run()
    # The dead owner: two rounds committed, then the process is gone.
    dead = _build(task)
    dead.begin()
    dead.step()
    dead.step()
    dead.checkpointer.wait()

    repo = JRepo()
    repo.add_task("sup_port", task_status=TaskStatus.RUNNING.name)
    for col, value in (("task_params", json.dumps(task)), ("resource_occupied", "1"),
                       ("owner_id", "dead-host:1"), ("lease_expires", repr(time.time() - 100))):
        repo.set_item_value("sup_port", col, value)
    built = []

    def factory(tc, stop_event):
        runner = build_runner_from_taskconfig(tc, task_repo=repo, stop_event=stop_event,
                                              device="cpu")
        built.append(runner)
        return runner

    log = ResilienceLog()
    sup = TaskSupervisor(task_repo=repo, runner_factory=factory, lease_ttl=30.0,
                         backoff_base_s=0.0, log=log)
    assert sup.scan_once()["resumed"] == ["sup_port"]
    job_id = repo.get_item_value("sup_port", "job_id")
    deadline = time.monotonic() + 120
    while (sup.launcher.get_job_status(job_id) != TaskStatus.SUCCEEDED
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert sup.launcher.get_job_status(job_id) == TaskStatus.SUCCEEDED
    assert sup.scan_once()["finalized"] == ["sup_port"]
    assert log.count(LEASE_EXPIRED, "sup_port") == 1 and log.count(TASK_RESUMED, "sup_port") == 1
    runner = built[0]
    assert [h["round"] for h in runner.history] == [0, 1, 2, 3, 4]
    assert repo.get_item_value("sup_port", "logical_round") == 5
    _assert_same_state(runner, straight)
    assert os.path.isdir(tmp_path / "sup_port" / "4")


def test_skip_discards_the_step_of_a_skipped_round(tmp_path):
    """A round that checkpointed and then failed (its stop barrier) is
    skipped: its step is discarded, so a restart cannot resurrect the state
    the skip threw away."""
    ckpt = {"directory": str(tmp_path / "{task_id}")}
    runner = _build(_task("skip_ck", rounds=3, checkpoint=ckpt,
                          resilience={"failure_policy": "skip_round"}))
    stop = runner.operator_flow.stop
    calls = []

    def failing_stop():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("stop barrier lost")
        return stop()

    runner.operator_flow.stop = failing_stop
    history = runner.run()
    assert [h.get("skipped", False) for h in history] == [False, True, False]
    steps = sorted(int(p.name) for p in (tmp_path / "skip_ck").iterdir() if p.name.isdigit())
    assert steps == [0, 2]
    # The state entering round 2 is round 0's: a resume from step 0 replays
    # round 1 as if it had been skipped, not as it ran.
    assert runner.states["data_0"].round_idx == 2
