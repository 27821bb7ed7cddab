"""The port's leases, task manager recovery and TaskSupervisor against the
JAX package's, scenario by scenario (``tests/test_supervisor.py``, those
that need no deviceflow rooms and no session), on the same steps: the
digests, decisions and task rows (timestamps and owner ids left out) must
be equal. Then a supervised resume through the port's manager and
supervisor over one SQLite file, held bitwise against an uninterrupted
port run."""

import json
import threading

import pytest
import torch

import torch_threads  # noqa: F401
from test_taskmgr import make_task_json
from test_torch_taskmgr import both, join, rows, side

NOW = 1.9e9  # every scan and claim of a scenario runs at a fixed wall clock


class OkRunner:
    stopped = False

    def run(self):
        return []


class DyingRunner:
    stopped = False

    def run(self):
        raise RuntimeError("worker died")


class GatedRunner:
    stopped = False

    def __init__(self, stop_event):
        self._stop = stop_event

    def run(self):
        self._stop.wait(30)
        self.stopped = self._stop.is_set()


class Ledger:
    """Resource-manager double recording release/request calls."""

    def __init__(self, grant=True):
        self.grant, self.released, self.requested = grant, [], []

    def get_resource(self):
        return {"logical_simulation": {"cpu": float("inf"), "mem": float("inf")},
                "device_simulation": {}}

    def release_resource(self, task_id):
        self.released.append(task_id)
        return True

    def request_cluster_resource(self, task_id, user_id, cpu, mem):
        self.requested.append(task_id)
        return self.grant


def running_row(s, repo, task_id, occupied="1", **extra):
    repo.add_task(task_id, task_status=s.TaskStatus.RUNNING.name)
    repo.set_item_value(task_id, "task_params", json.dumps(make_task_json(task_id)))
    repo.set_item_value(task_id, "resource_occupied", occupied)
    for k, v in extra.items():
        repo.set_item_value(task_id, k, v)


def orphan_repo(s, task_id="sup1", resumes=None):
    repo = s.Repo()
    extra = {"owner_id": "dead-host:1", "lease_expires": repr(NOW - 100.0)}
    if resumes is not None:
        extra["supervision"] = json.dumps(resumes)
    running_row(s, repo, task_id, **extra)
    return repo


# -------------------------------------------------------------------- leases
@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_lease_protocol_equals_jax(backend, tmp_path):
    def run(s):
        if backend == "memory":
            repo = s.Repo()
        else:
            repo = s.Repo(sqlite_path=str(tmp_path / f"leases_{s.name}.db"))
        repo.add_task("t1")
        t0 = 1000.0
        return [repo.claim_lease("t1", "A", ttl_s=60, now=t0), repo.lease_info("t1"),
                repo.claim_lease("t1", "B", ttl_s=60, now=t0 + 30),
                repo.claim_lease("t1", "A", ttl_s=60, now=t0 + 30),
                repo.claim_lease("t1", "B", ttl_s=60, now=t0 + 89),
                repo.claim_lease("t1", "B", ttl_s=60, now=t0 + 91), repo.lease_info("t1"),
                repo.renew_lease("t1", "A", ttl_s=60, now=t0 + 200),
                repo.renew_lease("t1", "B", ttl_s=60, now=t0 + 200), repo.lease_info("t1"),
                repo.release_lease("t1", "A"), repo.release_lease("t1", "B"),
                repo.lease_info("t1"), repo.renew_lease("t1", "B", ttl_s=60, now=t0 + 300),
                repo.claim_lease("t1", "C", ttl_s=60, now=t0 + 300),
                repo.release_lease("t1", "B"), repo.lease_info("t1"),
                repo.lease_expired({"lease_expires": None}, now=0.0),
                repo.lease_expired({"lease_expires": repr(10.0)}, now=5.0),
                repo.get_task_ids_by_status(None), repo.delete_task("t1"), repo.query_all()]
    got, want = both(run)
    assert got == want
    assert got[0] and got[1] == ("A", 1060.0) and not got[2] and got[5]
    assert got[16] == ("C", 1360.0)


# --------------------------------------------------- TaskManager recovery
def test_recover_legacy_fails_orphaned_running_rows_equal_jax():
    def run(s):
        repo, rm = s.Repo(), Ledger()
        running_row(s, repo, "occupied", occupied="1")
        running_row(s, repo, "launch-window", occupied="0")
        mgr = s.manager(task_repo=repo, resource_manager=rm, schedule_interval=3600)
        out = [rm.released, mgr.get_task_status("occupied").name,
               bool(repo.get_item_value("launch-window", "task_finished_time"))]
        mgr.stop()
        return out, rows(repo)
    got, want = both(run)
    assert got == want
    assert got[0] == [["occupied"], "FAILED", True]
    assert got[1]["launch-window"]["task_status"] == "FAILED"


def test_recover_supervised_leaves_running_rows_equal_jax():
    def run(s):
        repo, rm = s.Repo(), Ledger()
        running_row(s, repo, "orphan", occupied="1", owner_id="dead:1",
                    lease_expires=repr(NOW - 100))
        mgr = s.manager(task_repo=repo, resource_manager=rm, schedule_interval=3600,
                        supervise_orphans=True)
        mgr.stop()
        return rm.released, rows(repo)
    got, want = both(run)
    assert got == want and got[0] == []
    assert got[1]["orphan"]["task_status"] == "RUNNING"


def test_recover_requeues_queued_rows_in_order_equal_jax():
    def run(s):
        repo = s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600)
        mgr.submit_task(s.tc(make_task_json("q2")))
        mgr.submit_task(s.tc(make_task_json("q1")))
        mgr.stop()
        mgr2 = s.manager(task_repo=repo, schedule_interval=3600)
        return mgr2.get_task_queue(), mgr2.get_task_status("q2").name, rows(repo)
    got, want = both(run)
    assert got == want and got[:2] == (["q2", "q1"], "QUEUED")


def test_release_loop_leaves_orphans_for_supervisor_equal_jax():
    def run(s):
        repo, rm = s.Repo(), Ledger()
        running_row(s, repo, "orphan", owner_id="dead:9", lease_expires=repr(NOW - 100),
                    job_id="job-orphan")
        mgr = s.manager(task_repo=repo, resource_manager=rm, schedule_interval=3600,
                        supervise_orphans=True)
        mgr.release_once()
        mgr.stop()
        return rm.released, rows(repo)
    got, want = both(run)
    assert got == want and got[0] == [] and got[1]["orphan"]["resource_occupied"] == "1"


# ------------------------------------------------------ heartbeat & fencing
def test_heartbeat_renews_and_fences_equal_jax():
    def run(s):
        repo = s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600, lease_ttl=60.0,
                        runner_factory=lambda tc, ev: GatedRunner(ev))
        assert mgr.submit_task(s.tc(make_task_json("hb")))
        out = [mgr.schedule_once()]
        owner, expires = repo.lease_info("hb")
        out.append(owner == mgr.owner_id)
        mgr.heartbeat_once(now=expires)
        out.append(repo.lease_info("hb")[1] - expires)
        out.append(repo.claim_lease("hb", "thief", ttl_s=60, now=expires + 120.0))
        repo.set_item_value("hb", "job_id", "job-hb~s1")
        mgr.heartbeat_once(now=expires + 121.0)
        out += [repo.lease_info("hb")[0], join(mgr._launcher, "job-hb").name,
                sorted(mgr._fenced), mgr._own_jobs]
        mgr.release_once()  # a fenced row is the reclaimer's to finalize
        mgr.stop()
        return out, rows(repo)
    got, want = both(run)
    assert got == want
    assert got[0] == ["hb", True, 60.0, True, "thief", "STOPPED", ["hb"], {}]


def test_heartbeat_keeps_lease_warm_until_release_equal_jax():
    def run(s):
        repo = s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600, lease_ttl=60.0,
                        runner_factory=lambda tc, ev: OkRunner())
        assert mgr.submit_task(s.tc(make_task_json("warm")))
        out = [mgr.schedule_once(), join(mgr._launcher, "job-warm").name,
               repo.get_item_value("warm", "resource_occupied")]
        _, e1 = repo.lease_info("warm")
        mgr.heartbeat_once(now=e1 + 1.0)
        out.append(repo.lease_info("warm")[1] - e1)
        mgr.release_once()
        out += [repo.lease_info("warm"), mgr._own_jobs]
        mgr.stop()
        return out, rows(repo)
    got, want = both(run)
    assert got == want and got[0] == ["warm", "SUCCEEDED", "1", 61.0, ("", None), {}]


def test_heartbeat_transient_renew_failure_does_not_fence_equal_jax():
    def run(s):
        repo = s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600, lease_ttl=60.0,
                        runner_factory=lambda tc, ev: GatedRunner(ev))
        assert mgr.submit_task(s.tc(make_task_json("blip")))
        mgr.schedule_once()
        real = repo.renew_lease
        repo.renew_lease = lambda *a, **k: False
        try:
            mgr.heartbeat_once()
        finally:
            repo.renew_lease = real
        out = [mgr._launcher.get_job_status("job-blip").name, "blip" in mgr._own_jobs]
        _, e1 = repo.lease_info("blip")
        mgr.heartbeat_once(now=e1)
        out += [repo.lease_info("blip")[1] - e1, mgr.stop_task("blip"),
                join(mgr._launcher, "job-blip").name]
        mgr.release_once()
        mgr.stop()
        return out, rows(repo)
    got, want = both(run)
    assert got == want and got[0] == ["RUNNING", True, 60.0, True, "STOPPED"]
    assert got[1]["blip"]["task_status"] == "STOPPED"


def test_launch_refused_when_lease_held_elsewhere_equal_jax():
    def run(s):
        launched, repo = [], s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600,
                        runner_factory=lambda tc, ev: launched.append(1) or OkRunner())
        assert mgr.submit_task(s.tc(make_task_json("dbl")))
        assert repo.claim_lease("dbl", "other-proc", ttl_s=3600)
        out = [mgr.schedule_once(), launched, repo.lease_info("dbl")[0]]
        mgr.stop()
        return out, rows(repo)
    got, want = both(run)
    assert got == want and got[0] == ["dbl", [], "other-proc"]
    assert got[1]["dbl"]["task_status"] == "QUEUED"


def test_launch_aborts_when_another_manager_moved_the_row_equal_jax():
    def run(s):
        launched, repo = [], s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600,
                        runner_factory=lambda tc, ev: launched.append(1) or OkRunner())
        assert mgr.submit_task(s.tc(make_task_json("moved")))
        repo.set_item_value("moved", "task_status", s.TaskStatus.SUCCEEDED.name)
        out = [mgr.schedule_once(), launched]
        mgr.stop()
        return out, rows(repo)
    got, want = both(run)
    assert got == want and got[0] == ["moved", []]
    assert got[1]["moved"]["task_status"] == "SUCCEEDED"


def test_terminal_fence_releases_resources_equal_jax():
    def run(s):
        repo, rm = s.Repo(), Ledger()
        mgr = s.manager(task_repo=repo, resource_manager=rm, schedule_interval=3600,
                        lease_ttl=60.0, runner_factory=lambda tc, ev: OkRunner())
        assert mgr.submit_task(s.tc(make_task_json("tfence")))
        out = [mgr.schedule_once(), join(mgr._launcher, "job-tfence").name]
        _, e1 = repo.lease_info("tfence")
        out.append(repo.claim_lease("tfence", "standby", ttl_s=60, now=e1 + 1.0))
        mgr.heartbeat_once(now=e1 + 2.0)
        out += [sorted(mgr._fenced), list(rm.released)]
        mgr.release_once()
        mgr.stop()
        return out, rows(repo)
    got, want = both(run)
    assert got == want and got[0] == ["tfence", "SUCCEEDED", True, ["tfence"], ["tfence"]]
    assert got[1]["tfence"]["task_status"] == "RUNNING"


# --------------------------------------------------------------- supervisor
EMPTY = {"renewed": [], "resumed": [], "failed": [], "finalized": [], "fenced": []}


def test_supervisor_reclaims_and_resumes_equal_jax():
    def run(s):
        log, repo, rm, built = s.ResilienceLog(), orphan_repo(s), Ledger(), []

        def factory(tc, stop_event):
            built.append(tc.taskID.taskID)
            return OkRunner()

        sup = s.supervisor(task_repo=repo, runner_factory=factory, resource_manager=rm,
                           lease_ttl=30.0, backoff_base_s=0.0, log=log)
        out = [sup.scan_once(now=NOW), built, rm.requested, repo.lease_info("sup1"),
               repo.get_item_value("sup1", "job_id")]
        out[3] = (out[3][0] == sup.owner_id, out[3][1])
        out.append(join(sup.launcher, "job-sup1~s1").name)
        out += [sup.scan_once(now=NOW + 1), rm.released, repo.lease_info("sup1"),
                log.count("lease_expired", "sup1"), log.count("task_resumed", "sup1")]
        return out, rows(repo)
    got, want = both(run)
    assert got == want
    out = got[0]
    assert out[0]["resumed"] == ["sup1"] and out[3] == (True, NOW + 30.0)
    assert out[4] == "job-sup1~s1" and out[6]["finalized"] == ["sup1"]
    assert out[7] == ["sup1", "sup1"] and out[8] == ("", None) and out[9:] == [1, 1]
    row = got[1]["sup1"]
    assert row["task_status"] == "SUCCEEDED" and row["resource_occupied"] == "0"
    assert json.loads(row["supervision"]) == {"resumes": 1, "last_resume_ts": NOW}


def test_supervisor_live_lease_left_alone_equal_jax():
    def run(s):
        repo = s.Repo()
        running_row(s, repo, "alive", owner_id="other:1", lease_expires=repr(NOW + 300.0))
        sup = s.supervisor(task_repo=repo, runner_factory=lambda tc, ev: OkRunner(),
                           log=s.ResilienceLog())
        return sup.scan_once(now=NOW), rows(repo)
    got, want = both(run)
    assert got == want and got[0] == EMPTY


def test_supervisor_crash_loop_quarantines_to_failed_equal_jax():
    def run(s):
        log, repo, rm = s.ResilienceLog(), orphan_repo(s, "loop"), Ledger()
        sup = s.supervisor(task_repo=repo, runner_factory=lambda tc, ev: DyingRunner(),
                           resource_manager=rm, resume_budget=2, backoff_base_s=0.0, log=log)
        out = []
        for attempt in (1, 2):
            out.append(sup.scan_once(now=NOW + attempt))
            out.append(join(sup.launcher, repo.get_item_value("loop", "job_id")).name)
        out += [sup.scan_once(now=NOW + 3), log.count("crash_loop", "loop"),
                log.count("task_resumed", "loop"), sup.scan_once(now=NOW + 4)]
        return out, rows(repo)
    got, want = both(run)
    assert got == want
    out = got[0]
    assert out[0]["resumed"] == out[2]["resumed"] == ["loop"] and out[1] == out[3] == "FAILED"
    assert out[4]["failed"] == ["loop"] and out[5:7] == [1, 2] and out[7] == EMPTY
    assert got[1]["loop"]["task_status"] == "FAILED"


def test_supervisor_backoff_spaces_resumes_equal_jax():
    def run(s):
        repo = orphan_repo(s, "bk", resumes={"resumes": 1, "last_resume_ts": NOW})
        sup = s.supervisor(task_repo=repo, runner_factory=lambda tc, ev: OkRunner(),
                           backoff_base_s=50.0, resume_budget=5, log=s.ResilienceLog())
        out = [sup.scan_once(now=NOW + 10.0), repo.lease_info("bk")[0],
               sup.scan_once(now=NOW + 60.0)]
        join(sup.launcher, "job-bk~s2")
        return out, rows(repo)
    got, want = both(run)
    assert got == want
    assert got[0][0] == EMPTY and got[0][1] == "dead-host:1" and got[0][2]["resumed"] == ["bk"]


def test_supervisor_resume_budget_is_durable_equal_jax():
    def run(s):
        log = s.ResilienceLog()
        repo = orphan_repo(s, "dur", resumes={"resumes": 3, "last_resume_ts": 0.0})
        sup = s.supervisor(task_repo=repo, runner_factory=lambda tc, ev: OkRunner(),
                           resume_budget=3, backoff_base_s=0.0, log=log)
        return sup.scan_once(now=NOW), log.count("crash_loop", "dur"), rows(repo)
    got, want = both(run)
    assert got == want and got[0]["failed"] == ["dur"] and got[1] == 1


def test_supervisor_injection_points_equal_jax():
    def run(s):
        log, repo = s.ResilienceLog(), orphan_repo(s, "inj")
        sup = s.supervisor(task_repo=repo, runner_factory=lambda tc, ev: OkRunner(),
                           backoff_base_s=0.0, log=log)
        out = []
        for seed, point in ((9, "supervisor.reclaim"), (10, "supervisor.relaunch")):
            plan = s.faults.FaultPlan(seed=seed, specs=[
                s.faults.FaultSpec(point=point, times=1, error="io")])
            with s.faults.chaos(plan, log=log):
                out += [sup.scan_once(now=NOW), repo.lease_info("inj"),
                        repo.get_item_value("inj", "supervision")]
        out += [sup.scan_once(now=NOW + 1), log.count("fault_injected")]
        join(sup.launcher, repo.get_item_value("inj", "job_id"))
        out[1] = out[1][0]
        return out, rows(repo)
    got, want = both(run)
    assert got == want
    out = got[0]
    assert out[0] == EMPTY and out[1] == "dead-host:1" and out[2] is None
    assert out[3] == EMPTY and out[4] == ("", None)
    assert json.loads(out[5])["resumes"] == 1 and out[6]["resumed"] == ["inj"] and out[7] == 2


def test_supervisor_reregisters_a_flow_task_equal_jax():
    class FakeFlow:
        def __init__(self):
            self.registered = []

        def register_task(self, task_id, resources):
            self.registered.append((task_id, tuple(resources)))
            return True

    def run(s):
        js = make_task_json("df")
        js["operatorflow"]["operators"][0]["operation_behavior_controller"] = {
            "use_gradient_house": True,
            "strategy_gradient_house": json.dumps(
                {"real_time_dispatch": {"use_strategy": True, "dispatch_batch_sizes": [4]}}),
            "outbound_service": ""}
        repo = s.Repo()
        running_row(s, repo, "df", owner_id="dead:2", lease_expires=repr(NOW - 50))
        repo.set_item_value("df", "task_params", json.dumps(js))
        flow = FakeFlow()
        sup = s.supervisor(task_repo=repo, deviceflow=flow,
                           runner_factory=lambda tc, ev: OkRunner(), backoff_base_s=0.0,
                           log=s.ResilienceLog())
        out = [sup.scan_once(now=NOW), flow.registered]
        join(sup.launcher, "job-df~s1")
        return out, rows(repo)
    got, want = both(run)
    assert got == want and got[0][1] == [("df", ("logical_simulation",))]


def test_supervisor_fences_own_job_when_lease_stolen_equal_jax():
    def run(s):
        repo = orphan_repo(s, "steal")
        sup = s.supervisor(task_repo=repo, runner_factory=lambda tc, ev: GatedRunner(ev),
                           backoff_base_s=0.0, lease_ttl=30.0, log=s.ResilienceLog())
        out = [sup.scan_once(now=NOW)]
        job_id = repo.get_item_value("steal", "job_id")
        out.append(sup.launcher.get_job_status(job_id).name)
        real = repo.renew_lease

        def renew_after_steal(task_id, owner_id, ttl_s, now=None):
            _, expires = repo.lease_info(task_id)
            assert repo.claim_lease(task_id, "standby", ttl_s=60, now=(expires or 0.0) + 1.0)
            return real(task_id, owner_id, ttl_s, now=now)

        repo.renew_lease = renew_after_steal
        try:
            out.append(sup.scan_once(now=NOW + 1))
        finally:
            repo.renew_lease = real
        out += [repo.lease_info("steal")[0], join(sup.launcher, job_id).name,
                sup.scan_once(now=NOW + 2)]
        return out, rows(repo)
    got, want = both(run)
    assert got == want
    assert got[0][1] == "RUNNING" and got[0][2]["fenced"] == ["steal"]
    assert got[0][3:5] == ["standby", "STOPPED"] and got[0][5] == EMPTY


def test_two_supervisors_race_one_expired_lease_equal_jax():
    def run(s):
        log, repo, built, lock = s.ResilienceLog(), orphan_repo(s, "race"), [], threading.Lock()

        def factory(tag):
            def make(tc, stop_event):
                with lock:
                    built.append(tag)
                return OkRunner()
            return make

        sups = {t: s.supervisor(task_repo=repo, runner_factory=factory(t), backoff_base_s=0.0,
                                log=log) for t in "AB"}
        start, digests = threading.Barrier(2), {}

        def scan(name):
            start.wait()
            digests[name] = sups[name].scan_once(now=NOW)

        threads = [threading.Thread(target=scan, args=(t,)) for t in "AB"]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        winner = "A" if digests["A"]["resumed"] else "B"
        loser = "B" if winner == "A" else "A"
        join(sups[winner].launcher, "job-race~s1")
        out = [sorted(digests["A"]["resumed"] + digests["B"]["resumed"]), len(built),
               repo.lease_info("race")[0] == sups[winner].owner_id,
               log.count("task_resumed", "race"), sups[loser].scan_once(now=NOW)["resumed"]]
        return out, rows(repo)
    got, want = both(run)
    assert got == want and got[0] == [["race"], 1, True, 1, []]


def test_supervisor_policy_and_identity():
    from olearning_sim_tpu_torch.resilience import FailurePolicy
    from olearning_sim_tpu_torch.supervisor import TaskSupervisor
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo

    with pytest.raises(ValueError):
        TaskSupervisor(task_repo=TaskTableRepo(), failure_policy=FailurePolicy.RETRY,
                       device="cpu")
    with pytest.raises(ValueError):
        TaskSupervisor(device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        TaskSupervisor(task_repo=TaskTableRepo())  # standalone default: the card
    mgr = side("port").manager(schedule_interval=3600, supervise_orphans=True)
    sup = TaskSupervisor(mgr)
    assert sup.owner_id == mgr.owner_id and sup.task_repo is mgr._task_repo
    assert sup.launcher is mgr._launcher and sup._runner_factory == mgr._runner_factory
    assert TaskSupervisor(task_repo=TaskTableRepo(), device="cpu").owner_id.startswith(
        "supervisor:")


def test_supervisor_daemon_starts_and_stops():
    from olearning_sim_tpu_torch.supervisor import TaskSupervisor
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo

    sup = TaskSupervisor(task_repo=TaskTableRepo(), device="cpu", scan_interval=3600)
    sup.start()
    sup.start()  # idempotent
    assert sup._thread.is_alive()
    sup.stop()
    assert sup._thread is None


# --------------------------------------------- a supervised resume, bitwise
def _task(task_id, ckpt_dir=None, rounds=4):
    js = make_task_json(task_id, rounds=rounds, num_clients=8)
    if ckpt_dir is not None:
        info = js["operatorflow"]["operators"][0]["logical_simulation"]
        params = json.loads(info["operator_params"])
        params["checkpoint"] = {"directory": ckpt_dir, "every": 1}
        info["operator_params"] = json.dumps(params)
    return js


def test_supervised_resume_over_sqlite_is_bitwise_the_uninterrupted_run(tmp_path):
    """A port manager over a SQLite task table runs a checkpointed task; after
    round 2 it dies without releasing the lease (its job is stopped and its
    daemons never run again). A port supervisor on the same file reclaims
    the task past the lease's expiry, resumes it from its checkpoint and
    finishes it: the final params equal an uninterrupted run's bitwise."""
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.resilience import ResilienceLog
    from olearning_sim_tpu_torch.supervisor import TaskSupervisor
    from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo
    from olearning_sim_tpu_torch.telemetry import MetricsRegistry

    straight = build_runner_from_taskconfig(_task("sup_bitwise"), device="cpu")
    straight.run()

    db = str(tmp_path / "tasks.db")
    repo = TaskTableRepo(sqlite_path=db)
    reached, gate = threading.Event(), threading.Event()
    rounds_seen = []

    def dying_factory(tc, stop_event):
        runner = build_runner_from_taskconfig(tc, task_repo=repo, stop_event=stop_event,
                                              device="cpu")
        step = runner.step

        def step_then_die():
            more = step()
            rounds_seen.append(1)
            if len(rounds_seen) == 2:
                runner.checkpointer.wait()
                reached.set()
                gate.wait(60)
                raise RuntimeError("owner process died")
            return more
        runner.step = step_then_die
        return runner

    mgr = TaskManager(task_repo=repo, schedule_interval=3600, lease_ttl=30.0,
                      supervise_orphans=True, runner_factory=dying_factory, device="cpu")
    assert mgr.submit_task(_task("sup_bitwise", str(tmp_path / "ckpt")))
    assert mgr.schedule_once() == "sup_bitwise"
    assert reached.wait(120)
    gate.set()
    join(mgr._launcher, "job-sup_bitwise")
    _, expires = repo.lease_info("sup_bitwise")
    assert repo.get_item_value("sup_bitwise", "task_status") == "RUNNING"
    assert repo.get_item_value("sup_bitwise", "logical_round") == "2"

    reg, built = MetricsRegistry(), []

    def factory(tc, stop_event):
        built.append(build_runner_from_taskconfig(
            tc, task_repo=repo2, stop_event=stop_event, registry=reg, device="cpu"))
        return built[-1]

    repo2 = TaskTableRepo(sqlite_path=db)  # the supervisor's own connection
    sup = TaskSupervisor(task_repo=repo2, runner_factory=factory, backoff_base_s=0.0,
                         lease_ttl=30.0, log=ResilienceLog(), registry=reg, device="cpu")
    assert sup.scan_once(now=expires - 1.0)["resumed"] == []  # the lease is still live
    assert sup.scan_once(now=expires + 1.0)["resumed"] == ["sup_bitwise"]
    assert join(sup.launcher, "job-sup_bitwise~s1").name == "SUCCEEDED"
    assert sup.scan_once(now=expires + 2.0)["finalized"] == ["sup_bitwise"]
    assert repo.get_item_value("sup_bitwise", "task_status") == "SUCCEEDED"
    assert repo.get_item_value("sup_bitwise", "logical_round") == "4"
    runner = built[0]
    assert [h["round"] for h in runner.history] == [0, 1, 2, 3]
    for k, v in straight.states["data_0"].params.items():
        assert torch.equal(runner.states["data_0"].params[k], v), k
    assert reg.get("ols_supervisor_resumes_total").labels(task_id="sup_bitwise").value == 1
    assert reg.get("ols_supervisor_lease_age_seconds").labels(
        task_id="sup_bitwise").count == 1
    mgr.stop()
