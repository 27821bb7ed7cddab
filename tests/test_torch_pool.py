"""The port's chip-pool scheduler against the JAX package's, on the same
task JSONs and oracle inputs: every scenario of
``tests/test_scheduler_storm.py`` but its slow-marked storms — cost-oracle
precedence, best-fit placement, admission (decisions, reasons, rows,
events), the packing order, migration (the ``task_preempted`` /
``task_migrated`` events, the migration-storm FAIL_TASK, the fence timeout,
the rebalancer), the FIFO baseline and stranded-row adoption — then the
quick submit storm at the size of the JAX package's tier-1 run, over the
port's managers and supervisors, and a migrated port task bitwise equal to
its uninterrupted run on the CPU.

Host outputs are compared exactly; a task's final parameters bitwise."""

import dataclasses
import importlib.util
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from test_scheduler_storm import sched_task_json
from test_taskmgr import make_task_json, wait_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 1 << 30
UNCOMPARED = {"in_queue_time", "submit_task_time", "task_finished_time", "owner_id",
              "lease_expires", "job_error"}
INF = {"logical_simulation": {"cpu": float("inf"), "mem": float("inf")},
       "device_simulation": {}}


class Pkg:
    def __init__(self, name):
        self.name = name
        if name == "jax":
            from olearning_sim_tpu.resilience import ResilienceLog, faults
            from olearning_sim_tpu.resilience import events
            from olearning_sim_tpu.supervisor import TaskSupervisor
            from olearning_sim_tpu.taskmgr import pool, scheduler
            from olearning_sim_tpu.taskmgr.codecs import json2taskconfig
            from olearning_sim_tpu.taskmgr.status import TaskStatus
            from olearning_sim_tpu.taskmgr.task_manager import TaskManager
            from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo
        else:
            from olearning_sim_tpu_torch.resilience import ResilienceLog, faults
            from olearning_sim_tpu_torch.resilience import events
            from olearning_sim_tpu_torch.supervisor import TaskSupervisor
            from olearning_sim_tpu_torch.taskmgr import pool, scheduler
            from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig
            from olearning_sim_tpu_torch.taskmgr.status import TaskStatus
            from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager
            from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo
        self.ResilienceLog, self.faults, self.events = ResilienceLog, faults, events
        self.TaskSupervisor, self.pool, self.scheduler = TaskSupervisor, pool, scheduler
        self.json2taskconfig, self.TaskStatus = json2taskconfig, TaskStatus
        self.TaskManager, self.TaskTableRepo = TaskManager, TaskTableRepo

    def tc(self, js):
        return self.json2taskconfig(json.loads(json.dumps(js)))

    def manager(self, **kw):
        if self.name == "port":
            kw.setdefault("device", "cpu")
        return self.TaskManager(**kw)

    def supervisor(self, **kw):
        if self.name == "port":
            kw.setdefault("device", "cpu")
        return self.TaskSupervisor(**kw)

    def oracle(self, **kw):
        """A cost oracle over the same static budget: the JAX package's
        blessed HLO budgets, handed to the port as its budgets file."""
        if self.name == "port":
            kw.setdefault("budgets_path", BUDGETS["path"])
        return self.pool.CostOracle(**kw)

    def chip_pool(self, *hbm_gb):
        return self.pool.ChipPool([self.pool.MeshSpec(f"w{i}", hbm_bytes=g * GIB)
                                   for i, g in enumerate(hbm_gb)])


PKGS = {}
BUDGETS = {}


@pytest.fixture(scope="module", autouse=True)
def jax_budgets(tmp_path_factory):
    from olearning_sim_tpu.analysis.hlo_audit import static_hbm_oracle

    path = tmp_path_factory.mktemp("budgets") / "budgets.json"
    path.write_text(json.dumps(static_hbm_oracle()))
    BUDGETS["path"] = str(path)


def pkg(name):
    if name not in PKGS:
        PKGS[name] = Pkg(name)
    return PKGS[name]


def both(fn):
    return fn(pkg("jax")), fn(pkg("port"))


def same(fn):
    jax_out, port_out = both(fn)
    assert port_out == jax_out
    return port_out


def _column(k, v):
    if k == "supervision" and v:
        # The resume counter is compared; its wall-clock stamp is not.
        return {a: b for a, b in json.loads(v).items() if a != "last_resume_ts"}
    return v


def rows(repo):
    return {r["task_id"]: {k: _column(k, v) for k, v in r.items() if k not in UNCOMPARED}
            for r in repo.query_all()}


def events(log, task_id=None):
    return [(e.kind, e.point, e.task_id,
             {k: v for k, v in e.detail.items() if k not in ("job_id", "error")})
            for e in log.events(task_id=task_id)]


def cost(c):
    return dataclasses.asdict(c)


class GatedRunner:
    stopped = False

    def __init__(self, stop_event):
        self._stop = stop_event

    def run(self):
        self._stop.wait(30)
        self.stopped = self._stop.is_set()


# ------------------------------------------------------------ cost oracle
def test_cost_oracle_precedence_equals_jax():
    def run(p):
        oracle = p.oracle()
        out = [cost(oracle.estimate(p.tc(sched_task_json("c1", hbm_gb=3.0, round_time_s=0.5,
                                                         compile_s=2.0, deadline_s=9.0))))]
        plain = p.tc(make_task_json("c2"))
        family = p.pool.CostOracle.family_of(plain)
        out.append((family, cost(oracle.estimate(plain))))
        oracle.record_measurement(family, round_time_s=0.25, compile_s=1.5,
                                  peak_hbm_bytes=123456.0)
        out.append(cost(oracle.estimate(plain)))
        oracle2 = p.oracle(bench_records=[
            {"family": family, "rounds_per_sec": 4.0, "compile_sec": 7.0}, {"no": "family"}])
        out.append(cost(oracle2.estimate(plain)))
        out.append(oracle2.ingest_bench_records([{"family": "x", "round_time_sec": 2.0}]))
        return out
    out = same(run)
    assert out[0]["source"] == "scheduling_params" and out[2]["source"] == "measured"
    assert out[1][0] == "fedavg_mlp2"


def test_cost_oracle_static_budget_equals_jax(tmp_path):
    """The port's static source is a budgets file: given the numbers the
    JAX package's static HBM oracle reads, both estimate alike."""
    from olearning_sim_tpu.analysis.hlo_audit import static_hbm_oracle

    from olearning_sim_tpu_torch.taskmgr.pool import CostOracle

    budgets = static_hbm_oracle()
    path = tmp_path / "budgets.json"
    path.write_text(json.dumps(budgets))
    jax_oracle = pkg("jax").pool.CostOracle()
    port_oracle = CostOracle(budgets_path=str(path))
    for clients in (1, 24, 2400):
        assert port_oracle.static_peak_hbm(clients) == jax_oracle.static_peak_hbm(clients)
        js = make_task_json("c3", num_clients=clients)
        assert cost(port_oracle.estimate(pkg("port").tc(js))) == \
            cost(jax_oracle.estimate(pkg("jax").tc(js)))
    assert port_oracle.estimate(pkg("port").tc(make_task_json("c4"))).source == "static_hbm"
    assert port_oracle.static_peak_hbm(2400) > port_oracle.static_peak_hbm(24)
    # No budgets file (or an unreadable one): defaults, as JAX without one.
    for missing in (CostOracle(), CostOracle(budgets_path=str(tmp_path / "none.json"))):
        assert missing.static_peak_hbm(24) is None
        assert missing.estimate(pkg("port").tc(make_task_json("c5"))).source == "default"


def test_measure_hbm_budget_refuses_the_cpu(tmp_path):
    from olearning_sim_tpu_torch.engine import build_fedcore, fedavg, make_synthetic_dataset
    from olearning_sim_tpu_torch.engine.fedcore import FedCoreConfig
    from olearning_sim_tpu_torch.performancemgr.hbm_budget import measure_hbm_budget

    core = build_fedcore("mlp2", fedavg(0.1), FedCoreConfig(batch_size=4, max_local_steps=2,
                                                            block_clients=2),
                         model_overrides={"hidden": (8,), "num_classes": 3},
                         input_shape=(6,), device="cpu")
    ds = make_synthetic_dataset(0, 4, 8, (6,), 3).pad_for(2).to("cpu")
    with pytest.raises(ValueError, match="CUDA card only"):
        measure_hbm_budget(core, core.init_state(0, "cpu"), ds, str(tmp_path / "b.json"))
    assert not (tmp_path / "b.json").exists()


def test_mesh_spec_takes_the_card_memory_or_refuses():
    from olearning_sim_tpu_torch.taskmgr.pool import DEFAULT_PEAK_HBM_BYTES, MeshSpec

    assert MeshSpec("w", hbm_bytes=8 * GIB).hbm_bytes == 8 * GIB
    if torch.cuda.is_available():
        total = torch.cuda.get_device_properties(0).total_memory
        assert MeshSpec("w").hbm_bytes == total
    else:
        with pytest.raises(ValueError, match="give hbm_bytes"):
            MeshSpec("w")
    assert DEFAULT_PEAK_HBM_BYTES == 1 << 30


# -------------------------------------------------------------- chip pool
def test_chip_pool_best_fit_and_capacity_equals_jax():
    def run(p):
        pool = p.chip_pool(8.0, 4.0)
        small = p.pool.TaskCost(peak_hbm_bytes=3 * GIB)
        big = p.pool.TaskCost(peak_hbm_bytes=6 * GIB)
        out = [pool.best_fit(small), pool.place("t1", "w1", small), pool.free_bytes("w1"),
               pool.best_fit(small), pool.place("t2", "w0", small), pool.best_fit(big),
               pool.place("t3", "w1", big), pool.place("t3", "w1", big, force=True),
               pool.used_bytes("w1"), pool.best_fit(small, exclude=("w0",)),
               pool.move("t3", "w0"), pool.move("t3", "nope"), pool.free_bytes("w0")]
        pool.release("t2")
        out += [pool.best_fit(big), pool.release("missing"),
                sorted((q.task_id, q.worker) for q in pool.placements()),
                pool.max_worker_hbm()]
        try:
            p.pool.ChipPool([])
        except ValueError as e:
            out.append(str(e))
        try:
            p.chip_pool(1.0).place("t", "w9", small)
        except KeyError as e:
            out.append(str(e))
        return out
    out = same(run)
    assert out[:2] == ["w1", True]


# ------------------------------------------------------------- admission
def pool_manager(p, workers=2, hbm_gb=8.0, max_queue=64, log=None, **kw):
    sched = p.pool.PoolScheduler(p.chip_pool(*([hbm_gb] * workers)), p.oracle(),
                                 max_queue=max_queue, log=log)
    return p.manager(schedule_interval=3600, pool=sched, **kw), sched


def test_admission_rejects_oom_placement_equals_jax():
    def run(p):
        log = p.ResilienceLog()
        mgr, _ = pool_manager(p, log=log)
        try:
            ok = mgr.submit_task(p.tc(sched_task_json("oom", hbm_gb=64.0)))
            return ok, mgr.get_task_status("oom").name, rows(mgr._task_repo), events(log)
        finally:
            mgr.stop()
    ok, status, _, ev = same(run)
    assert not ok and status == "FAILED" and ev[0][3]["reason"] == "oom"


def test_admission_backpressure_bounds_queue_equals_jax():
    def run(p):
        log = p.ResilienceLog()
        mgr, _ = pool_manager(p, max_queue=2, log=log)
        try:
            ok = [mgr.submit_task(p.tc(sched_task_json(f"q{i}"))) for i in range(3)]
            return ok, mgr.get_task_queue(), rows(mgr._task_repo), events(log)
        finally:
            mgr.stop()
    ok, queue, _, ev = same(run)
    assert ok == [True, True, False] and queue == ["q0", "q1"]
    assert ev[0][3]["reason"] == "backpressure"


def test_admission_rejects_blown_deadline_equals_jax():
    def run(p):
        log = p.ResilienceLog()
        mgr, sched = pool_manager(p, workers=1, log=log)
        try:
            out = [mgr.submit_task(p.tc(sched_task_json("long", rounds=60, round_time_s=1.0))),
                   sched.estimated_wait_s()]
            out.append(mgr.submit_task(p.tc(sched_task_json(
                "urgent", rounds=1, round_time_s=0.1, deadline_s=5.0))))
            out.append(mgr.submit_task(p.tc(sched_task_json("patient", rounds=1,
                                                            round_time_s=0.1))))
            return out, rows(mgr._task_repo), events(log)
        finally:
            mgr.stop()
    out, _, ev = same(run)
    assert out[0] and not out[2] and out[3] and ev[0][3]["reason"] == "deadline"


def test_scheduler_admit_injection_point_equals_jax():
    def run(p):
        log = p.ResilienceLog()
        mgr, _ = pool_manager(p, log=log)
        try:
            plan = p.faults.FaultPlan(seed=3, specs=[
                p.faults.FaultSpec(point="scheduler.admit", times=1, error="io")])
            tc = p.tc(sched_task_json("adm"))
            with p.faults.chaos(plan, log=log):
                with pytest.raises(p.faults.FaultError):
                    mgr.submit_task(tc)
            return (log.count("fault_injected"), mgr.submit_task(tc),
                    mgr.get_task_status("adm").name, rows(mgr._task_repo))
        finally:
            mgr.stop()
    assert same(run)[:3] == (1, True, "QUEUED")


# ------------------------------------------------------- strategy (packing)
def test_strategy_priority_deadline_then_sjf_equals_jax():
    def run(p):
        mgr, sched = pool_manager(p, workers=1)
        try:
            for tid, rounds, rt, prio, dl in (("slow_low", 50, 1.0, 0, None),
                                              ("fast_low", 1, 0.01, 0, None),
                                              ("slow_high", 50, 1.0, 9, None),
                                              ("urgent_low", 5, 1.0, 0, 300.0)):
                assert mgr.submit_task(p.tc(sched_task_json(tid, rounds=rounds,
                                                            round_time_s=rt, priority=prio,
                                                            deadline_s=dl)))
            queue = mgr._task_queue.get_task_queue()
            picks = []
            while queue:
                pick = sched.schedule_next_task(queue, INF)
                picks.append((pick.task.taskID.taskID, pick.worker,
                              pick.task_request["logical_simulation"]))
                sched.abort_launch(picks[-1][0])
                queue = [tc for tc in queue if tc.taskID.taskID != picks[-1][0]]
            return picks
        finally:
            mgr.stop()
    picks = same(run)
    assert [t for t, _, _ in picks] == ["slow_high", "urgent_low", "fast_low", "slow_low"]


def test_strategy_skips_tasks_that_do_not_fit_now_equals_jax():
    def run(p):
        mgr, sched = pool_manager(p, workers=1)
        try:
            sched.pool.place("resident", "w0", p.pool.TaskCost(peak_hbm_bytes=6 * GIB))
            mgr.submit_task(p.tc(sched_task_json("big", hbm_gb=4.0, priority=7)))
            mgr.submit_task(p.tc(sched_task_json("tiny", hbm_gb=1.0, priority=1)))
            pick = sched.schedule_next_task(mgr._task_queue.get_task_queue(), INF)
            return pick.task.taskID.taskID, sched._starved[0], sched._starved[2]
        finally:
            mgr.stop()
    assert same(run) == ("tiny", "big", 7)


def test_pool_manager_launch_places_and_release_frees_equals_jax():
    def run(p):
        mgr, sched = pool_manager(p, runner_factory=lambda tc, ev: GatedRunner(ev))
        try:
            out = []
            for tid, gb in (("a", 5.0), ("b", 5.0), ("c", 5.0)):
                mgr.submit_task(p.tc(sched_task_json(tid, hbm_gb=gb)))
            for _ in range(3):
                out.append(mgr.schedule_once())
            out.append({t: (sched.pool.placement(t).worker, mgr._task_repo.get_item_value(
                t, "worker_id")) for t in ("a", "b")})
            mgr.stop_task("a")
            assert wait_for(lambda: mgr._launcher.get_job_status("job-a")
                            == p.TaskStatus.STOPPED)
            mgr.release_once()
            out += [sched.pool.placement("a"), mgr.schedule_once(),
                    sched.pool.placement("c").worker, rows(mgr._task_repo)]
            for t in ("b", "c"):
                mgr.stop_task(t)
            return out
        finally:
            mgr.stop()
    out = same(run)
    assert out[:3] == ["a", "b", None] and out[5] == "c"


# -------------------------------------------------------------- migration
def test_migration_storm_degrades_to_fail_task_equals_jax():
    def run(p):
        log = p.ResilienceLog()
        sched = p.pool.PoolScheduler(p.chip_pool(8.0, 8.0), p.oracle(),
                                     resume_budget=2, log=log)
        mgr = p.manager(schedule_interval=3600, pool=sched,
                        runner_factory=lambda tc, ev: GatedRunner(ev))
        try:
            assert mgr.submit_task(p.tc(sched_task_json("thrash")))
            out = [mgr.schedule_once()]
            out += [sched.migrate("thrash") for _ in range(3)]
            out += [mgr.get_task_status("thrash").name, sched.pool.placement("thrash"),
                    rows(mgr._task_repo), events(log, "thrash")]
            return out
        finally:
            mgr.stop()
    out = same(run)
    assert out[:5] == ["thrash", "migrated", "migrated", "failed", "FAILED"]
    assert [e[0] for e in out[-1]] == ["task_preempted", "task_migrated", "task_preempted",
                                       "task_migrated", "crash_loop"]


def test_scheduler_preempt_injection_point_equals_jax():
    def run(p):
        log = p.ResilienceLog()
        sched = p.pool.PoolScheduler(p.chip_pool(8.0, 8.0), p.oracle(), log=log)
        mgr = p.manager(schedule_interval=3600, pool=sched,
                        runner_factory=lambda tc, ev: GatedRunner(ev))
        try:
            mgr.submit_task(p.tc(sched_task_json("pre")))
            out = [mgr.schedule_once()]
            plan = p.faults.FaultPlan(seed=5, specs=[
                p.faults.FaultSpec(point="scheduler.preempt", times=1, error="io")])
            with p.faults.chaos(plan, log=log):
                with pytest.raises(p.faults.FaultError):
                    sched.migrate("pre", "w1")
            out += [sched.pool.placement("pre").worker,
                    mgr._launcher.get_job_status("job-pre").name, events(log),
                    mgr.stop_task("pre")]
            return out
        finally:
            mgr.stop()
    assert same(run)[:3] == ["pre", "w0", "RUNNING"]


def test_migration_fence_timeout_withdraws_stop_equals_jax():
    class StubbornRunner:
        stopped = False

        def __init__(self, stop_event):
            self._stop = stop_event

        def run(self):
            time.sleep(0.6)
            if self._stop.is_set():
                self.stopped = True

    def run(p):
        log = p.ResilienceLog()
        sched = p.pool.PoolScheduler(p.chip_pool(8.0, 8.0), p.oracle(), log=log)
        mgr = p.manager(schedule_interval=3600, pool=sched,
                        runner_factory=lambda tc, ev: StubbornRunner(ev))
        try:
            mgr.submit_task(p.tc(sched_task_json("stub")))
            out = [mgr.schedule_once(), sched.migrate("stub", "w1", fence_timeout_s=0.1),
                   sched.pool.placement("stub").worker, events(log),
                   mgr._task_repo.get_item_value("stub", "supervision")]
            assert wait_for(lambda: mgr._launcher.get_job_status("job-stub")
                            == p.TaskStatus.SUCCEEDED, timeout=30)
            out.append(mgr._launcher.get_job("job-stub").runner.stopped)
            return out
        finally:
            mgr.stop()
    out = same(run)
    assert out[1:3] == ["skipped", "w0"] and out[-1] is False


def test_rebalancer_migrates_victim_for_starved_high_priority_equals_jax():
    def run(p):
        log = p.ResilienceLog()
        sched = p.pool.PoolScheduler(p.chip_pool(8.0, 8.0), p.oracle(), log=log)
        mgr = p.manager(schedule_interval=3600, pool=sched,
                        runner_factory=lambda tc, ev: GatedRunner(ev))
        try:
            out = []
            for tid in ("res0", "res1"):
                mgr.submit_task(p.tc(sched_task_json(tid, hbm_gb=6.0, priority=0)))
                out.append(mgr.schedule_once())
            mgr.submit_task(p.tc(sched_task_json("vip", hbm_gb=4.0, priority=9)))
            out += [mgr.schedule_once(), sched.rebalance_once()]
            mgr.stop_task("res1")
            assert wait_for(lambda: mgr._launcher.get_job_status("job-res1")
                            == p.TaskStatus.STOPPED)
            mgr.release_once()
            out += [sched.pool.placement("res1"), sched.rebalance_once(),
                    sched.pool.placement("res0").worker, mgr.schedule_once(),
                    sched.pool.placement("vip").worker, events(log),
                    rows(mgr._task_repo)]
            for t in ("res0", "vip"):
                mgr.stop_task(t)
            return out
        finally:
            mgr.stop()
    out = same(run)
    assert out[3]["migrated"] == [] and out[5]["migrated"] == ["res0"]
    assert out[6:9] == ["w1", "vip", "w0"]


def test_fifo_pop_strategy_head_of_line_blocks_equals_jax():
    def run(p):
        big = p.tc(make_task_json("big", cpus=10, request_units=10))
        small = p.tc(make_task_json("small", cpus=1, request_units=1))
        strat = p.scheduler.StrategyFactory.create_strategy("fifo")
        tight = {"logical_simulation": {"cpu": 2, "mem": 100}, "device_simulation": {}}
        roomy = {"logical_simulation": {"cpu": 100, "mem": 100}, "device_simulation": {}}
        return (type(strat).__name__, strat.schedule_next_task([big, small], tight),
                strat.schedule_next_task([big, small], roomy).task.taskID.taskID)
    assert same(run) == ("FifoPopStrategy", None, "big")


def test_adopt_stranded_queued_row_equals_jax():
    def run(p):
        repo = p.TaskTableRepo()
        a = p.manager(task_repo=repo, schedule_interval=3600)
        b = p.manager(task_repo=repo, schedule_interval=3600, adopt_stranded_after=0.5)
        try:
            assert a.submit_task(p.tc(make_task_json("stranded")))
            a.stop()
            out = [b.get_task_queue()]
            b._last_adopt_scan = 0.0
            out.append(b.adopt_stranded_once(now=time.time() + 60.0))
            out.append(b.get_task_queue())
            b._last_adopt_scan = 0.0
            out += [b.adopt_stranded_once(now=time.time() + 120.0), b.get_task_queue()]
            return out
        finally:
            a.stop()
            b.stop()
    assert same(run) == [[], 1, ["stranded"], 0, ["stranded"]]


# ------------------------------------- migration of a port task, bitwise
class _SlowStepRunner:
    def __init__(self, inner, round_sleep_s, first_round=None):
        self.inner = inner
        self.round_sleep_s = round_sleep_s
        self.first_round = first_round
        self.start_round = None

    @property
    def stopped(self):
        return self.inner.stopped

    def run(self):
        self.inner.begin()
        self.start_round = self.inner._loop["round_idx"]
        while self.inner.step():
            if self.first_round is not None:
                self.first_round.set()
            time.sleep(self.round_sleep_s)
        return self.inner.finish()


def _port_pool_manager(tmp_path, task_id, rounds, round_sleep_s, first_round=None):
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig

    p = pkg("port")
    js = sched_task_json(task_id, hbm_gb=2.0, rounds=rounds)
    op = js["operatorflow"]["operators"][0]["logical_simulation"]
    params = json.loads(op["operator_params"])
    params["checkpoint"] = {"directory": str(tmp_path / "{task_id}"), "every": 1}
    op["operator_params"] = json.dumps(params)
    repo = p.TaskTableRepo()

    def factory(tc, stop_event):
        inner = build_runner_from_taskconfig(tc, task_repo=repo, stop_event=stop_event,
                                             device="cpu")
        return _SlowStepRunner(inner, round_sleep_s, first_round)

    sched = p.pool.PoolScheduler(p.chip_pool(8.0, 8.0), p.pool.CostOracle())
    mgr = p.manager(task_repo=repo, runner_factory=factory, pool=sched,
                    schedule_interval=0.02, release_interval=0.05, interrupt_interval=3600)
    return mgr, sched, js


def test_planned_migration_resumes_bitwise(tmp_path):
    """A port task preempted at a round boundary and migrated to the other
    worker finishes bitwise equal to its uninterrupted run; the events and
    row columns are those of the JAX package's migration."""
    rounds = 4
    mgr_a, _, js = _port_pool_manager(tmp_path / "clean", "migbit", rounds, 0.0)
    mgr_a.start()
    try:
        assert mgr_a.submit_task(js)
        assert wait_for(lambda: mgr_a.get_task_status("migbit").name == "SUCCEEDED",
                        timeout=120)
        clean = mgr_a._launcher.get_job("job-migbit").runner.inner.states["data_0"].params
    finally:
        mgr_a.stop()

    from olearning_sim_tpu_torch.resilience import ResilienceLog

    log = ResilienceLog()
    first = threading.Event()
    mgr_b, sched_b, js2 = _port_pool_manager(tmp_path / "mig", "migbit", rounds, 0.3, first)
    sched_b.log = log
    mgr_b.start()
    try:
        assert mgr_b.submit_task(js2)
        repo = mgr_b._task_repo
        assert first.wait(120)
        assert repo.get_item_value("migbit", "worker_id") == "w0"
        assert sched_b.migrate("migbit", "w1", reason="test") == "migrated"
        assert repo.get_item_value("migbit", "worker_id") == "w1"
        assert repo.get_item_value("migbit", "job_id") == "job-migbit~m1"
        assert json.loads(repo.get_item_value("migbit", "supervision"))["resumes"] == 1
        # "src" is read from the placement after the pool has moved it, so
        # it names the destination, in the JAX package's events as here.
        assert [(k, d) for k, _, _, d in events(log)] == [
            ("task_preempted", {"worker": "w0", "reason": "test"}),
            ("task_migrated", {"src": "w1", "dst": "w1", "attempt": 1})]
        assert wait_for(lambda: mgr_b.get_task_status("migbit").name == "SUCCEEDED",
                        timeout=120)
        relaunched = mgr_b._launcher.get_job("job-migbit~m1").runner
        migrated = relaunched.inner.states["data_0"].params
        assert relaunched.start_round >= 1  # the relaunch resumed, not restarted
    finally:
        mgr_b.stop()
    assert clean.keys() == migrated.keys()
    for k in clean:
        assert torch.equal(clean[k], migrated[k]), k


# ----------------------------------------------------- quick submit storm
def _bench_module():
    spec = importlib.util.spec_from_file_location(
        "bench_scheduler", os.path.join(REPO, "scripts", "bench_scheduler.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["bench_scheduler"] = mod
    spec.loader.exec_module(mod)
    return mod


class PortStormWorker:
    """The storm harness's worker (scripts/bench_scheduler.py) over the
    port's TaskManager and chip pool: its own SQLite connection, launcher
    and lease identity; ``die()`` stops every daemon and releases nothing."""

    def __init__(self, name, db_path, ledger, log, lease_ttl=1.0, max_queue=512,
                 meshes_per_worker=2, mesh_hbm_gb=8.0):
        p = pkg("port")
        self.name, self.ledger = name, ledger
        self.dead = threading.Event()
        pool = p.pool.ChipPool([p.pool.MeshSpec(f"{name}/mesh{i}", hbm_bytes=mesh_hbm_gb * GIB)
                                for i in range(meshes_per_worker)])
        self.manager = p.manager(
            task_repo=p.TaskTableRepo(sqlite_path=db_path),
            pool=p.pool.PoolScheduler(pool, p.oracle(), max_queue=max_queue, log=log),
            rebalance_interval=0.1, runner_factory=self._runner_factory,
            schedule_interval=0.01, release_interval=0.03, interrupt_interval=3600,
            lease_ttl=lease_ttl, supervise_orphans=True, adopt_stranded_after=2.0)

    def _runner_factory(self, tc, stop_event):
        return PortStormRunner(tc, stop_event, self, self.ledger, self.manager._task_repo)

    def start(self):
        self.manager.start()

    def die(self):
        if self.dead.is_set():
            return
        self.dead.set()
        self.ledger.kills += 1
        self.manager.stop()

    def stop(self):
        self.manager.stop()


class PortStormRunner:
    """The storm's stub engine job (scripts/bench_scheduler.py StormRunner)
    consulting the port's ``runner.round_begin`` fault point."""

    def __init__(self, tc, stop_event, worker, ledger, repo, worker_name=None):
        self.tc, self.stop_event, self.worker = tc, stop_event, worker
        self.worker_name = worker_name or (worker.name if worker else "supervisor")
        self.ledger, self.repo, self.stopped = ledger, repo, False
        self.storm = json.loads(
            tc.operatorFlow.operator[0].logicalSimulationOperatorInfo.operatorParams
        ).get("storm", {})

    def run(self):
        from olearning_sim_tpu_torch.resilience import faults
        from olearning_sim_tpu_torch.resilience.faults import HostPreemption

        task_id = self.tc.taskID.taskID
        rounds = int(self.storm.get("rounds", 1))
        clients = int(self.storm.get("clients", 1))
        with self.ledger.track(task_id):
            for r in range(rounds):
                if self.worker is not None and self.worker.dead.is_set():
                    raise faults.FaultError(f"worker {self.worker_name} is dead")
                if self.stop_event is not None and self.stop_event.is_set():
                    self.stopped = True
                    return
                spec = faults.fire("runner.round_begin", context=f"{self.worker_name}:{task_id}",
                                   round_idx=r, task_id=task_id)
                if spec is not None:
                    if spec.error == "preempt":
                        if self.worker is not None:
                            self.worker.die()
                        raise HostPreemption(f"injected kill of {self.worker_name}")
                    if spec.error == "false":
                        time.sleep(float((spec.payload or {}).get("delay_s", 0.01)))
                    else:
                        with self.ledger.lock:
                            self.ledger.io_faults += 1
                time.sleep(float(self.storm.get("round_s", 0.001)))
                self.ledger.record_round(clients)
        self.repo.set_item_value(task_id, "logical_round", rounds)
        self.repo.set_item_value(task_id, "logical_operator", "train")
        self.repo.set_item_value(task_id, "logical_result", json.dumps({"logical_result": [{
            "name": "data_0", "simulation_target": {"devices": ["high"],
                                                    "success_num": [clients],
                                                    "failed_num": [0]}}]}))


def run_port_storm(bench, tmp_path, n_tasks, seed, n_workers, n_supervisors, n_kills,
                   n_submitters, timeout_s, log):
    """``bench.run_storm(mode="pool", ...)`` over the port's managers,
    supervisors and fault injector, with the same seeded task mix, kills and
    chaos plan, and the same result record."""
    from olearning_sim_tpu_torch.resilience import faults as tfaults

    p = pkg("port")
    rng = np.random.default_rng(seed)
    db_path = str(tmp_path / "tasks.db")
    ledger = bench.StormLedger()
    workers = [PortStormWorker(f"w{i}", db_path, ledger, log) for i in range(n_workers)]
    kill_names = [w.name for w in rng.choice(workers, size=min(n_kills, n_workers),
                                             replace=False)]
    plan = tfaults.FaultPlan.from_dict(json.loads(bench.build_fault_plan(seed, kill_names)
                                                  .to_json()))
    supervisors = []
    for _ in range(n_supervisors):
        repo = p.TaskTableRepo(sqlite_path=db_path)
        supervisors.append(p.supervisor(
            task_repo=repo, lease_ttl=1.0, scan_interval=0.1, backoff_base_s=0.05,
            resume_budget=4, log=log,
            runner_factory=lambda tc, ev, _r=repo: PortStormRunner(tc, ev, None, ledger, _r,
                                                                   "supervisor")))
    fam_names = list(bench.FAMILIES)
    weights = np.array([bench.FAMILIES[f]["weight"] for f in fam_names], float)
    weights /= weights.sum()
    tasks = []
    for i in range(n_tasks):
        fam = str(rng.choice(fam_names, p=weights))
        tasks.append({"task_id": f"storm-pool-{i:04d}", "family": fam,
                      "spec": bench.FAMILIES[fam]})
    oom_ids = []
    for i in range(max(1, n_tasks // 50)):
        oom_ids.append(f"storm-pool-oom{i:02d}")
        tasks.append({"task_id": oom_ids[-1], "family": "oom_bait", "spec": bench.OOM_FAMILY})
    order = rng.permutation(len(tasks))
    rejected, submit_errors, replacements = [], [], []
    stop_replacer = threading.Event()

    def replacer():
        seen = set()
        while not stop_replacer.is_set():
            for w in workers:
                if w.dead.is_set() and w.name not in seen:
                    seen.add(w.name)
                    r = PortStormWorker(f"{w.name}r", db_path, ledger, log)
                    replacements.append(r)
                    r.start()
            stop_replacer.wait(0.2)

    def submitter(idx):
        srng = np.random.default_rng([seed, idx])
        for j in range(idx, len(order), n_submitters):
            entry = tasks[int(order[j])]
            tid = entry["task_id"]
            tc = p.tc(bench.make_storm_task_json(tid, entry["family"], entry["spec"]))
            live = [w for w in workers + replacements if not w.dead.is_set()]
            if not live:
                submit_errors.append((tid, "no live manager"))
                continue
            mgr = live[int(srng.integers(len(live)))].manager
            with ledger.lock:
                ledger.submit_t[tid] = time.monotonic()
            try:
                if not mgr.submit_task(tc):
                    rejected.append(tid)
            except Exception as e:  # noqa: BLE001 — a dying manager's submit errors
                submit_errors.append((tid, str(e)))
            time.sleep(float(srng.uniform(0, 0.004)))

    terminal = {"SUCCEEDED", "FAILED", "STOPPED"}
    with tfaults.chaos(plan, log=log):
        for w in workers:
            w.start()
        for s in supervisors:
            s.start()
        rep = threading.Thread(target=replacer, daemon=True)
        rep.start()
        threads = [threading.Thread(target=submitter, args=(i,), daemon=True)
                   for i in range(n_submitters)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        poll = p.TaskTableRepo(sqlite_path=db_path)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status = {r["task_id"]: r.get("task_status") for r in poll.query_all()}
            pending = [t["task_id"] for t in tasks if status.get(t["task_id"]) not in terminal]
            if not pending:
                break
            time.sleep(0.1)
        stop_replacer.set()
        rep.join(timeout=5)
        for s in supervisors:
            s.stop()
        for w in workers + replacements:
            w.stop()
    status = {r["task_id"]: r.get("task_status") for r in poll.query_all()}
    by_task = {t["task_id"]: status.get(t["task_id"]) for t in tasks}
    waits = ledger.waits()
    return {"pending": pending, "double_runs": ledger.double_runs, "launched": len(waits),
            "rejected": sorted(set(rejected)), "oom_ids": oom_ids,
            "submit_errors": submit_errors, "kills": ledger.kills,
            "resumes": log.count("task_resumed"),
            "admission_rejections": log.count("admission_rejected"),
            "wait_p95_s": float(np.percentile(waits, 95)) if waits else None,
            "statuses_by_task": by_task}


def test_submit_storm_quick(tmp_path):
    """The JAX package's tier-1 storm (48 tasks, seed 11, two workers, one
    supervisor, one kill, six submitters) over the port: no task lost, none
    double-run, every task terminal, the oversized one admission-failed, and
    the kill-orphaned tasks resumed."""
    from olearning_sim_tpu_torch.resilience import ResilienceLog

    bench = _bench_module()
    log = ResilienceLog()
    result = run_port_storm(bench, tmp_path, n_tasks=48, seed=11, n_workers=2,
                            n_supervisors=1, n_kills=1, n_submitters=6, timeout_s=90.0,
                            log=log)
    bench.assert_storm_invariants(result)
    assert result["kills"] == 1
    assert result["admission_rejections"] >= 1
    assert result["resumes"] >= 1, result
    assert result["launched"] > 0 and result["wait_p95_s"] is not None
