"""The port's control plane against the JAX package's, on the same inputs:
the task-JSON codec, the status calculus, submit validation, the
scheduler, the queues and the resource ledger, the hybrid allocator, the
phone farm, the SQLite / MySQL repos (a table written by one package is
read and claimed by the other), and the task manager's scenarios
(``tests/test_taskmgr.py``) driven with port runners on the CPU, whose
task rows must equal the JAX manager's column by column, timestamps and
owner ids left out."""

import copy
import itertools
import json
import pathlib
import sqlite3
import sys
import threading
import time

import numpy as np
import pytest

import torch_threads  # noqa: F401
from test_status_enumeration import ALL_COMBOS
from test_taskmgr import make_task_json

from olearning_sim_tpu_torch.taskmgr import codecs as tcodecs
from olearning_sim_tpu_torch.taskmgr import status as tstatus
from olearning_sim_tpu_torch.taskmgr.task_repo import TASK_COLUMNS, TaskTableRepo

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.stem for p in (REPO / "configs").glob("*.json"))
# Left out of a row comparison: wall-clock stamps, lease owners and their
# expiry, and the port's job_error column (the JAX manager has none).
UNCOMPARED = {"in_queue_time", "submit_task_time", "task_finished_time", "owner_id",
              "lease_expires", "job_error"}


def load(name):
    return json.loads((REPO / "configs" / f"{name}.json").read_text())


class Side:
    """One package's control plane, behind the same names."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            from olearning_sim_tpu.resilience import ResilienceLog, faults
            from olearning_sim_tpu.resourcemgr import ResourceManager
            from olearning_sim_tpu.resourcemgr import TpuTopology as Topology
            from olearning_sim_tpu.supervisor import TaskSupervisor
            from olearning_sim_tpu.taskmgr import queue_repo, scheduler, validation
            from olearning_sim_tpu.taskmgr.codecs import json2taskconfig
            from olearning_sim_tpu.taskmgr.status import TaskStatus
            from olearning_sim_tpu.taskmgr.task_manager import TaskManager
            from olearning_sim_tpu.taskmgr.task_queue import TaskQueue
            from olearning_sim_tpu.taskmgr.task_repo import TASK_COLUMNS as COLUMNS
            from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo as Repo
            from olearning_sim_tpu.utils import repo as repo_mod
        else:
            from olearning_sim_tpu_torch.resilience import ResilienceLog, faults
            from olearning_sim_tpu_torch.resourcemgr import DeviceTopology as Topology
            from olearning_sim_tpu_torch.resourcemgr import ResourceManager
            from olearning_sim_tpu_torch.supervisor import TaskSupervisor
            from olearning_sim_tpu_torch.taskmgr import queue_repo, scheduler, validation
            from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig
            from olearning_sim_tpu_torch.taskmgr.status import TaskStatus
            from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager
            from olearning_sim_tpu_torch.taskmgr.task_queue import TaskQueue
            from olearning_sim_tpu_torch.taskmgr.task_repo import TASK_COLUMNS as COLUMNS
            from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo as Repo
            from olearning_sim_tpu_torch.utils import repo as repo_mod
        self.ResilienceLog, self.faults = ResilienceLog, faults
        self.Topology, self.ResourceManager = Topology, ResourceManager
        self.TaskSupervisor, self.TaskManager = TaskSupervisor, TaskManager
        self.queue_repo, self.scheduler, self.validation = queue_repo, scheduler, validation
        self.json2taskconfig, self.TaskStatus, self.TaskQueue = json2taskconfig, TaskStatus, TaskQueue
        self.COLUMNS, self.Repo, self.repo_mod = COLUMNS, Repo, repo_mod

    def tc(self, js):
        return self.json2taskconfig(copy.deepcopy(js))

    def manager(self, **kw):
        if self.name == "port":
            kw.setdefault("device", "cpu")
        return self.TaskManager(**kw)

    def supervisor(self, *args, **kw):
        if self.name == "port" and not args:
            kw.setdefault("device", "cpu")
        return self.TaskSupervisor(*args, **kw)

    def topology(self, units=8.0):
        return self.Topology(num_chips=1, num_cores=8, platform="cpu", device_kinds=["cpu"],
                             cpu=units, mem=units)


SIDES = {}


def side(name):
    if name not in SIDES:
        SIDES[name] = Side(name)
    return SIDES[name]


def both(fn):
    """``fn(side)`` for the JAX package, then the port."""
    return fn(side("jax")), fn(side("port"))


def rows(repo):
    return {r["task_id"]: {k: v for k, v in r.items() if k not in UNCOMPARED}
            for r in repo.query_all()}


def join(launcher, job_id, timeout=120.0):
    job = launcher.get_job(job_id)
    job.join(timeout)
    return job.status


# --------------------------------------------------------------------- codec
@pytest.mark.parametrize("name", CONFIGS)
def test_codec_round_trip_equals_jax(name):
    from olearning_sim_tpu.taskmgr.codecs import json2taskconfig, taskconfig2json

    js = load(name)
    port = tcodecs.taskconfig2json(tcodecs.json2taskconfig(js))
    assert json.loads(json.dumps(port)) == json.loads(json.dumps(taskconfig2json(json2taskconfig(js))))
    assert tcodecs.json2taskconfig(port) == tcodecs.json2taskconfig(js)
    assert tcodecs.json2taskconfig(json.dumps(js)) == tcodecs.json2taskconfig(js)


def test_codec_defaults_mirror_protobuf_zero_values():
    from olearning_sim_tpu.taskmgr.codecs import json2taskconfig, taskconfig2json

    for js in ({}, {"task_id": "x", "target": {"data": [{}]},
                    "operatorflow": {"operators": [{"input": ""}]},
                    "logical_simulation": {"computation_unit": {"setting": [{}]},
                                           "resource_request": [{}]}}):
        assert tcodecs.taskconfig2json(tcodecs.json2taskconfig(js)) == \
            taskconfig2json(json2taskconfig(js))
    tc = tcodecs.TaskConfig()
    assert tc.target.priority == 0 and tc.userID == ""
    assert tc.target.targetData == [] and tc.logicalSimulation.computationUnit.devicesUnit == []


# -------------------------------------------------------------------- status
@pytest.mark.parametrize("ls,lrf,ds,drf,job_status,dev_finished", ALL_COMBOS)
def test_combine_task_status_equals_jax(ls, lrf, ds, drf, job_status, dev_finished):
    from olearning_sim_tpu.taskmgr import status as jstatus

    args = dict(logical_success=ls, logical_round_failed=lrf, device_success=ds,
                device_round_failed=drf)
    got = tstatus.combine_task_status(tstatus.Conditions(**args),
                                      tstatus.TaskStatus(int(job_status)), dev_finished)
    want = jstatus.combine_task_status(jstatus.Conditions(**args), job_status, dev_finished)
    assert int(got) == int(want) and got.name == want.name


def _half_cases(rng, present):
    """A sample of one half's progress: rounds, operators and per-class
    success/failed counts around the targets."""
    if not present:
        return [dict(present=False)]
    out = []
    for rnd, op in itertools.product((None, 1, 2, 3), (None, "train", "evaluate")):
        s = rng.integers(0, 8, size=2).tolist()
        f = rng.integers(0, 4, size=2).tolist()
        result = ([] if rng.random() < 0.15 else
                  [{"name": "d0", "simulation_target": {"devices": ["a", "b"],
                                                        "success_num": s, "failed_num": f}}])
        out.append(dict(present=True,
                        target=[{"name": "d0", "simulation_target": {"devices": ["a", "b"],
                                                                     "nums": [6, 5]}}],
                        result=result, current_round=rnd, operator_name=op))
    return out


def test_calculate_conditions_equals_jax():
    from olearning_sim_tpu.taskmgr import status as jstatus

    rng = np.random.default_rng(0)
    params = {"max_round": 3, "operator_name_list": ["train", "evaluate"],
              "data_name_list": ["d0"],
              "total_simulation": [{"simulation_target": {"devices": ["a", "b"],
                                                          "nums": [6, 5],
                                                          "dynamic_nums": [2, 1]}}]}
    n = 0
    for lp, dp in itertools.product((False, True), repeat=2):
        for lh, dh in itertools.product(_half_cases(rng, lp), _half_cases(rng, dp)):
            got = tstatus.calculate_conditions(params, tstatus.SimHalfState(**lh),
                                               tstatus.SimHalfState(**dh))
            want = jstatus.calculate_conditions(params, jstatus.SimHalfState(**lh),
                                                jstatus.SimHalfState(**dh))
            assert dataclass_tuple(got) == dataclass_tuple(want), (lh, dh)
            n += 1
    assert n == 1 + 12 + 12 + 144


def dataclass_tuple(c):
    return (c.logical_success, c.logical_round_failed, c.device_success, c.device_round_failed)


# ---------------------------------------------------------------- validation
def _engine(js, **blocks):
    info = js["operatorflow"]["operators"][0]["logical_simulation"]
    params = json.loads(info["operator_params"])
    for k, v in blocks.items():
        if v is None:
            params.pop(k, None)
        else:
            params[k] = v
    info["operator_params"] = json.dumps(params)


STREAM = {"stream_block_rows": 8}
MUTATIONS = {
    # tests/test_taskmgr.py::test_validation_correctness_rejects
    "empty_task_id": lambda j: j.update(task_id=""),
    "non_ascii_user": lambda j: j.update(user_id="中文"),
    "priority_11": lambda j: j["target"].update(priority=11),
    "nums_0": lambda j: j["target"]["data"][0]["total_simulation"].update(nums=[0]),
    "round_0": lambda j: j["operatorflow"]["flow_setting"].update(round=0),
    "op_space": lambda j: j["operatorflow"]["operators"][0].update(name="has space"),
    # ::test_validation_relationship_rules
    "dynamic_ge_nums": lambda j: j["target"]["data"][0]["total_simulation"].update(
        dynamic_nums=[24]),
    "alloc_sum": lambda j: j["target"]["data"][0]["allocation"].update(logical_simulation=[10]),
    "ghost_input": lambda j: j["operatorflow"]["operators"][0].update(input=["ghost"]),
    "rr_names": lambda j: j["logical_simulation"]["resource_request"][0].update(name="other"),
    "controller_strategy": lambda j: j["operatorflow"]["operators"][0].update(
        operation_behavior_controller={"use_gradient_house": True,
                                       "strategy_gradient_house": "",
                                       "outbound_service": ""}),
    # Engine-params refusals, block by block.
    "deadline_unknown_key": lambda j: _engine(j, deadline={"deadline_sec": 3.0}),
    "deadline_not_object": lambda j: _engine(j, deadline="fast"),
    "deadline_bad_value": lambda j: _engine(j, deadline={"deadline_s": "soon"}),
    "defense_bad_aggregator": lambda j: _engine(j, defense={"aggregator": "mode"}),
    "defense_unknown_key": lambda j: _engine(j, defense={"clip": 1.0}),
    "fedcore_unknown_key": lambda j: _engine(j, fedcore={"batch": 4}),
    "quarantine_bad": lambda j: _engine(j, quarantine={"preseed": "x"}),
    "async_unknown_key": lambda j: _engine(j, **{"async": {"buffer": 4}}),
    "async_bad_value": lambda j: _engine(j, **{"async": {"buffer_size": 0}}),
    "parallel_bad": lambda j: _engine(j, parallel={"mp": 0}),
    "parallel_unknown_key": lambda j: _engine(j, parallel={"tp": 2}),
    "scenario_unknown_key": lambda j: _engine(j, scenario={"stream_rows": 8}),
    "scenario_bad_value": lambda j: _engine(j, scenario={"stream_block_rows": -1}),
    "convergence_bad": lambda j: _engine(j, convergence={"target_accuracy": 2.0}),
    "convergence_unknown_key": lambda j: _engine(j, convergence={"target": 0.5}),
    "scenario_with_async": lambda j: _engine(j, scenario=STREAM,
                                             **{"async": {"buffer_size": 4}}),
    "streamed_ditto": lambda j: _engine(j, scenario=STREAM,
                                        algorithm={"name": "ditto", "local_lr": 0.1}),
    "streamed_scaffold": lambda j: _engine(j, scenario=STREAM,
                                           algorithm={"name": "scaffold", "local_lr": 0.1}),
    "streamed_gathering_defense": lambda j: _engine(
        j, scenario=STREAM, defense={"aggregator": "median"}),
    "streamed_parallel": lambda j: _engine(j, scenario=STREAM, parallel={"mp": 2}),
    "streamed_sharded_update": lambda j: _engine(
        j, scenario=STREAM, fedcore={"batch_size": 4, "max_local_steps": 2,
                                     "block_clients": 2, "shard_server_update": True}),
    "async_with_deadline": lambda j: _engine(j, deadline={"deadline_s": 3.0},
                                             **{"async": {"buffer_size": 4}}),
    "async_ditto": lambda j: _engine(j, algorithm={"name": "ditto", "local_lr": 0.1},
                                     **{"async": {"buffer_size": 4}}),
    "defense_scaffold": lambda j: _engine(j, algorithm={"name": "scaffold", "local_lr": 0.1},
                                          defense={"aggregator": "trimmed_mean"}),
    "pp_defense": lambda j: _engine(j, parallel={"pp": 2}, defense={"clip_norm": 1.0}),
    "pp_async": lambda j: _engine(j, parallel={"pp": 2}, **{"async": {"buffer_size": 4}}),
    "mp_gathering_defense": lambda j: _engine(j, parallel={"mp": 2},
                                              defense={"aggregator": "median"}),
    "mp_async": lambda j: _engine(j, parallel={"mp": 2}, **{"async": {"buffer_size": 4}}),
    # Accepted compositions.
    "clip_only_streamed": lambda j: _engine(j, scenario=STREAM, defense={"clip_norm": 1.0}),
    "valid_async": lambda j: _engine(j, **{"async": {"buffer_size": 4}}),
    "valid": lambda j: None,
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_validation_equals_jax(case):
    js = make_task_json()
    MUTATIONS[case](js)
    got, want = both(lambda s: s.validation.validate_task_parameters(s.tc(js)))
    assert got == want
    assert got[0] == case.startswith(("valid", "clip_only")), got


@pytest.mark.parametrize("name", CONFIGS)
def test_validation_of_configs_equals_jax(name):
    got, want = both(lambda s: s.validation.validate_task_parameters(s.tc(load(name))))
    assert got == want == (True, "Pass")


def test_validation_stages_and_type_guard():
    from olearning_sim_tpu_torch.taskmgr import validation

    assert validation.validate_type({"task_id": "x"})[0] is False
    tc = tcodecs.json2taskconfig(make_task_json())
    for stage in ("validate_type", "validate_correctness", "validate_relationship"):
        assert getattr(validation, stage)(tc) == (True, "Pass")


# ---------------------------------------------- scheduler, queue, resources
def test_task_queue_equals_jax():
    def run(s):
        q = s.TaskQueue()
        a, b = s.tc(make_task_json("a")), s.tc(make_task_json("b"))
        out = [q.add(a), q.add(b), q.add(a), q.get_task_ids(), q.delete("a"),
               q.delete("a"), "a" in q, "b" in q, len(q), q.get("b").taskID.taskID,
               q.get("a")]
        return out
    got, want = both(run)
    assert got == want == [True, True, False, ["a", "b"], True, False, False, True, 1, "b",
                           None]


def test_scheduler_decisions_equal_jax():
    def run(s):
        sch = s.scheduler
        out = []
        tc = s.tc(make_task_json(cpus=2, request_units=3))
        req = sch.get_task_request_resource(tc)
        out += [req, sch.check_resource_availability(req, {"logical_simulation": {"cpu": 6, "mem": 3}}),
                sch.check_resource_availability(req, {"logical_simulation": {"cpu": 5, "mem": 3}})]
        low, high = s.tc(make_task_json("low", priority=0)), s.tc(make_task_json("high", priority=9))
        big = s.tc(make_task_json("big", priority=10, cpus=10, request_units=10))
        small = s.tc(make_task_json("small", cpus=1, request_units=1))
        lots = {"logical_simulation": {"cpu": 100, "mem": 100}, "device_simulation": {}}
        tight = {"logical_simulation": {"cpu": 2, "mem": 100}, "device_simulation": {}}
        for strategy in ("default", "fifo", None, "unknown"):
            st = sch.StrategyFactory.create_strategy(strategy)
            for queue, avail in (([low, high], lots), ([big, small], tight), ([], lots),
                                 ([small, big], tight), ([big], tight)):
                res = st.schedule_next_task(queue, avail)
                out.append(None if res is None else (res.task.taskID.taskID, res.task_request))
        phones = s.tc(make_task_json("ph"))
        js = make_task_json("ph2")
        js["device_simulation"]["resource_request"] = [{"name": "data_0", "devices": ["high"],
                                                        "num_request": [3]}]
        phones = s.tc(js)
        req = sch.get_task_request_resource(phones)
        out += [req, sch.check_resource_availability(
            req, {"logical_simulation": lots["logical_simulation"],
                  "device_simulation": {"user1": {"high": 2}}})]
        return out
    got, want = both(run)
    assert got == want
    assert got[0]["logical_simulation"]["cpu"] == 6 and got[1] and not got[2]


def test_resource_ledger_equals_jax():
    def run(s):
        rm = s.ResourceManager(topology=s.topology(),
                               phone_provider=lambda: {"user1": {"high": 5}})
        out = [rm.get_resource()["logical_simulation"], rm.get_resource()["device_simulation"],
               rm.request_cluster_resource("t1", "user1", 5.0, 2.0),
               rm.request_cluster_resource("t1", "user1", 1.0, 1.0),
               rm.get_resource()["logical_simulation"],
               rm.request_cluster_resource("t2", "user1", 4.0, 1.0),
               rm.request_phone_resource("t3", "user1", {"high": 3}),
               rm.get_resource()["device_simulation"],
               rm.request_phone_resource("t4", "user1", {"high": 3}),
               rm.get_cluster_resource_detail(), rm.get_cluster_total_resource()]
        rm.release_resource("t1")
        rm.release_resource("t3")
        out += [rm.get_resource()["logical_simulation"], rm.get_resource()["device_simulation"],
                rm.get_cluster_resource_detail()]
        return out
    got, want = both(run)
    assert got == want
    assert got[2] and not got[3] and not got[5] and got[6] and not got[8]


def test_device_topology_detect():
    from olearning_sim_tpu_torch.resourcemgr import DeviceTopology, ResourceManager

    topo = DeviceTopology.detect("cpu", units_per_core=39, mem_per_core=40)
    assert (topo.num_chips, topo.platform, topo.device_kinds, topo.cpu, topo.mem) == \
        (1, "cpu", ["cpu"], 39, 40)
    rm = ResourceManager(topology=topo)
    assert rm.get_resource()["topology"]["cpu"] == 39
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceTopology.detect()  # no card here: the default refuses, never falls back
    with pytest.raises(RuntimeError, match="cuda"):
        ResourceManager()


# -------------------------------------------------------------------- hybrid
def test_hybrid_allocation_equals_jax():
    from olearning_sim_tpu.taskmgr import hybrid as jh

    from olearning_sim_tpu_torch.taskmgr import hybrid as th

    grid = itertools.product((6, 20), (0, 2), (0, 1, 3), (1, 2), (0, 1, 4))
    n = 0
    for cm in ((th.CostModel(), jh.CostModel()),
               (th.CostModel(alpha=0.05), jh.CostModel(alpha=0.05)),
               (th.CostModel.tpu_measured(40.0), jh.CostModel.tpu_measured(40.0))):
        for N, q, f, k, m in grid:
            d = {"N": [N, N + 3], "q": [q, 0], "f": [f, 2], "k": [k, 1], "m": [m, 1]}
            assert th.auto_allocation_hybrid_task(d, cm[0]) == \
                jh.auto_allocation_hybrid_task(d, cm[1])
            assert th._solve_brute(d["N"], d["q"], d["f"], d["k"], d["m"], cm[0]) == \
                jh._solve_brute(d["N"], d["q"], d["f"], d["k"], d["m"], cm[1])
            n += 1
        grid = itertools.product((6, 20), (0, 2), (0, 1, 3), (1, 2), (0, 1, 4))
    assert n == 3 * 72


def test_fix_data_parameters_equals_jax():
    from olearning_sim_tpu.taskmgr import hybrid as jh
    from olearning_sim_tpu.taskmgr.codecs import taskconfig2json as jt

    from olearning_sim_tpu_torch.taskmgr import hybrid as th

    js = make_task_json("hyb", num_clients=30)
    alloc = js["target"]["data"][0]["allocation"]
    alloc.update(optimization=True, logical_simulation=[], device_simulation=[],
                 running_response={"devices": ["high"], "nums": [3]})
    js["device_simulation"]["resource_request"] = [{"name": "data_0", "devices": ["high"],
                                                    "num_request": [5]}]
    jtc, ttc = side("jax").tc(js), side("port").tc(js)
    jh.fix_data_parameters(jtc)
    th.fix_data_parameters(ttc)
    assert tcodecs.taskconfig2json(ttc) == jt(jtc)
    assert sum(ttc.target.targetData[0].allocation.allocationLogicalSimulation) > 0


# ---------------------------------------------------------------- phone farm
def test_phone_farm_sequence_equals_jax(monkeypatch):
    from olearning_sim_tpu.phonemgr import PhoneCostModel as JCost
    from olearning_sim_tpu.phonemgr import SimulatedPhoneFarm as JFarm

    from olearning_sim_tpu_torch.phonemgr import PhoneCostModel as TCost
    from olearning_sim_tpu_torch.phonemgr import SimulatedPhoneFarm as TFarm

    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])

    def run(farm_cls, cost_cls):
        farm = farm_cls({"user1": {"high": 4, "low": 2}}, cost=cost_cls(), speedup=10.0,
                        failure_rate=0.3, seed=7)
        data = [{"name": "d0", "devices": ["high", "low"], "nums": [20, 9]}]
        out = [farm.request_device_resource("t", "user1", {"high": 3}),
               farm.get_device_available_resource(),
               farm.request_device_resource("u", "user1", {"high": 2}),
               farm.submit_task("t", 5, ["train", "evaluate"], data),
               farm.submit_task("t", 5, [], data)]
        for dt in (0.0, 0.5, 0.9, 0.95, 0.7, 3.0):
            clock[0] += dt
            out.append(farm.get_device_task_status("t"))
        out += [farm.stop_device("t"), farm.get_device_task_status("t"),
                farm.submit_task("t", 2, [], data), farm.get_device_task_status("t"),
                farm.release_device_resource("t"), farm.get_device_available_resource(),
                farm.get_device_task_status("ghost"), farm.stop_device("ghost")]
        clock[0] = 1000.0
        return out
    got, want = run(TFarm, TCost), run(JFarm, JCost)
    assert got == want
    assert any(s["device_result"] and s["device_result"][0]["simulation_target"]["failed_num"]
               != [0, 0] for s in got if isinstance(s, dict) and "device_result" in s)


# -------------------------------------------------------------------- sqlite
def test_task_table_crosses_packages_both_ways(tmp_path):
    from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo as JRepo

    path = str(tmp_path / "tasks.db")
    j = JRepo(sqlite_path=path)
    j.add_task("from_jax", task_status="QUEUED", task_params='{"a": 1}')
    assert j.claim_lease("from_jax", "jax-owner", ttl_s=60, now=100.0)
    t = TaskTableRepo(sqlite_path=path)  # adds the job_error column in place
    assert t.get_item_value("from_jax", "task_params") == '{"a": 1}'
    assert t.lease_info("from_jax") == ("jax-owner", 160.0)
    assert not t.claim_lease("from_jax", "port-owner", ttl_s=60, now=150.0)
    assert t.claim_lease("from_jax", "port-owner", ttl_s=60, now=161.0)  # expired: stolen
    t.add_task("from_port", task_status="RUNNING")
    t.set_item_value("from_port", "job_error", "boom")
    assert t.claim_lease("from_port", "port-owner", ttl_s=30, now=10.0)
    j2 = JRepo(sqlite_path=path)
    assert j2.lease_info("from_jax") == ("port-owner", 221.0)
    assert j2.get_item_value("from_port", "task_status") == "RUNNING"
    assert not j2.renew_lease("from_port", "jax-owner", ttl_s=30, now=11.0)
    assert j2.claim_lease("from_port", "jax-owner", ttl_s=30, now=41.0)
    assert t.lease_info("from_port")[0] == "jax-owner"
    assert not t.release_lease("from_port", "port-owner")
    assert j2.release_lease("from_port", "jax-owner") and t.lease_info("from_port") == ("", None)
    assert sorted(r["task_id"] for r in j2.query_all()) == ["from_jax", "from_port"]
    assert [c for c in TASK_COLUMNS if c != "job_error"] == list(j2.backend.columns)


def test_claim_row_has_one_winner_under_threads(tmp_path):
    repo = TaskTableRepo(sqlite_path=str(tmp_path / "race.db"))
    repo.add_task("t")
    winners, start = [], threading.Barrier(8)

    def claim(owner):
        start.wait()
        if repo.claim_lease("t", owner, ttl_s=60, now=100.0):
            winners.append(owner)

    threads = [threading.Thread(target=claim, args=(f"o{i}",)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(winners) == 1 and repo.lease_info("t")[0] == winners[0]


class _FlakyConn:
    """Connection proxy raising an OperationalError for the first ``n``
    statements that start with ``prefix``."""

    def __init__(self, conn, prefix, n, message="database is locked"):
        self._conn, self._prefix, self.remaining = conn, prefix, n
        self._exc = sqlite3.OperationalError(message)

    def execute(self, sql, *args):
        if sql.lstrip().upper().startswith(self._prefix) and self.remaining > 0:
            self.remaining -= 1
            raise self._exc
        return self._conn.execute(sql, *args)

    def __getattr__(self, name):
        return getattr(self._conn, name)


def test_retry_locked_retries_locks_and_passes_other_errors(tmp_path):
    from olearning_sim_tpu_torch.resilience import RETRY, ResilienceLog
    from olearning_sim_tpu_torch.utils.repo import retry_locked

    repo = TaskTableRepo(sqlite_path=str(tmp_path / "locked.db"))
    repo.add_task("t1")
    backend, real = repo.backend, repo.backend._conn
    backend._conn = flaky = _FlakyConn(real, "UPDATE", 3)
    try:
        assert repo.claim_lease("t1", "A", ttl_s=60, now=100.0)
    finally:
        backend._conn = real
    assert flaky.remaining == 0 and repo.lease_info("t1")[0] == "A"
    backend._conn = broken = _FlakyConn(real, "UPDATE", 10**6, message="no such table: nope")
    try:
        assert not repo.claim_lease("t1", "B", ttl_s=60, now=1e9)
    finally:
        backend._conn = real
    assert broken.remaining == 10**6 - 1  # one attempt, no retries
    # The helper itself: a locked error that outlasts the budget re-raises.
    calls = []

    def always_locked():
        calls.append(1)
        raise sqlite3.OperationalError("database is locked")

    from olearning_sim_tpu_torch.resilience import RetryPolicy

    log = ResilienceLog()
    policy = RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0, retry_on=(),
                         sleep=lambda _s: None)
    with pytest.raises(sqlite3.OperationalError, match="locked"):
        retry_locked(always_locked, policy=policy)
    assert len(calls) == 3
    assert retry_locked(lambda: 5, policy=policy) == 5
    assert log.count(RETRY) == 0


def test_intake_queues_cross_packages(tmp_path, monkeypatch):
    from olearning_sim_tpu.taskmgr.queue_repo import SqliteQueueRepo as JQueue

    from olearning_sim_tpu_torch.taskmgr.queue_repo import (
        MemoryQueueRepo,
        RedisQueueRepo,
        SqliteQueueRepo,
    )

    path = str(tmp_path / "q.db")
    jq, tq = JQueue(path), SqliteQueueRepo(path)
    assert jq.push("a") and tq.push("b") and jq.push("c")
    assert tq.peek_all() == jq.peek_all() == ["a", "b", "c"] and len(tq) == 3
    assert tq.pop() == "a" and jq.pop() == "b" and tq.pop() == "c" and jq.pop() is None
    tq.close()
    jq.close()
    m = MemoryQueueRepo()
    assert m.push("x") and m.push("y") and m.peek_all() == ["x", "y"] and len(m) == 2
    assert m.pop() == "x" and m.pop() == "y" and m.pop() is None
    flaky_q = SqliteQueueRepo(str(tmp_path / "lockq.db"))
    flaky_q.push("payload")
    real = flaky_q._conn
    flaky_q._conn = flaky = _FlakyConn(real, "BEGIN", 2)
    try:
        assert flaky_q.pop() == "payload"
    finally:
        flaky_q._conn = real
    assert flaky.remaining == 0
    monkeypatch.setitem(sys.modules, "redis", None)
    with pytest.raises(ImportError, match="redis"):
        RedisQueueRepo()

    class FakeRedis:
        def __init__(self):
            self.lists = {}

        def rpush(self, k, v):
            self.lists.setdefault(k, []).append(v)

        def lpop(self, k):
            lst = self.lists.get(k) or []
            return lst.pop(0) if lst else None

        def lrange(self, k, a, b):
            return list(self.lists.get(k, []))

        def llen(self, k):
            return len(self.lists.get(k, []))

    r = RedisQueueRepo(client=FakeRedis())
    assert r.push("p") and r.peek_all() == ["p"] and len(r) == 1 and r.pop() == "p"


def test_mysql_repo_over_a_dbapi_connection_equals_jax(tmp_path):
    from olearning_sim_tpu.utils.repo import MySqlTableRepo as JMySql

    from olearning_sim_tpu_torch.utils.repo import MySqlTableRepo

    cols = ["task_id", "owner_id", "lease_expires", "note"]

    def run(cls, path):
        conn = sqlite3.connect(path, check_same_thread=False)
        conn.execute("CREATE TABLE t (task_id TEXT, owner_id TEXT, lease_expires TEXT, "
                     "note TEXT)")
        conn.commit()
        made = []

        def connect():
            made.append(1)
            return sqlite3.connect(path, check_same_thread=False)

        repo = cls(connect, "t", cols, paramstyle="qmark")
        out = [repo.add_item({"task_id": ["a", "b"], "note": ["x", "y"]}),
               repo.add_item({"task_id": ["c"], "nope": ["z"]}),
               repo.get_item_value("task_id", "a", "note"),
               repo.set_item_value("task_id", "b", "note", "yy"),
               repo.get_values_by_conditions("note"),
               repo.claim_row("task_id", "a", "owner_id", "o1", "lease_expires", 160.0, 100.0),
               repo.claim_row("task_id", "a", "owner_id", "o2", "lease_expires", 170.0, 150.0),
               repo.claim_row("task_id", "a", "owner_id", "o2", "lease_expires", 230.0, 161.0),
               repo.release_row("task_id", "a", "owner_id", "o1", "lease_expires"),
               repo.release_row("task_id", "a", "owner_id", "o2", "lease_expires"),
               repo.delete_items(task_id="b"), repo.query_all(), repo.has_item("task_id", "a")]
        repo._conn.close()  # a dead connection: the next call reconnects once
        out.append(repo.get_item_value("task_id", "a", "note"))
        out.append(len(made))
        return out

    got = run(MySqlTableRepo, str(tmp_path / "port.db"))
    want = run(JMySql, str(tmp_path / "jax.db"))
    assert got == want
    assert got[5] and not got[6] and got[7] and got[-2] == "x" and got[-1] == 2
    with pytest.raises(ValueError):
        MySqlTableRepo(lambda: None, "t", cols, paramstyle="pyformat")


# ------------------------------------------------------------ the manager
def test_end_to_end_without_grpc_rows_equal_jax():
    """submit -> schedule_once -> the engine job runs -> release_once ->
    SUCCEEDED, resources released, with the JAX runner on one side and the
    port's runner (CPU) on the other."""
    def run(s):
        rm = s.ResourceManager(topology=s.topology())
        repo = s.Repo()
        mgr = s.manager(task_repo=repo, resource_manager=rm, schedule_interval=3600)
        js = make_task_json("e2e")
        out = [mgr.submit_task(s.tc(js)), mgr.submit_task(s.tc(js)),
               mgr.get_task_status(js["task_id"]).name, mgr.get_task_queue()]
        out.append(mgr.schedule_once())
        out.append(rm.get_resource()["logical_simulation"])
        out.append(join(mgr._launcher, f"job-{js['task_id']}").name)
        mgr.release_once()
        out += [mgr.get_task_status(js["task_id"]).name,
                rm.get_resource()["logical_simulation"], mgr.get_task_status("ghost").name,
                mgr.get_task_queue()]
        mgr.stop()
        return out, rows(repo)["e2e"]
    (jout, jrow), (tout, trow) = both(run)
    assert tout == jout
    assert tout[0] and not tout[1] and tout[2] == "QUEUED" and tout[7] == "SUCCEEDED"
    assert tout[5] == {"cpu": 6.0, "mem": 6.0} and tout[8] == {"cpu": 8.0, "mem": 8.0}
    assert tout[9] == "MISSING"
    assert trow == jrow
    assert trow["logical_round"] == 2 and trow["task_status"] == "SUCCEEDED"


def test_submit_takes_json_strings_and_dicts():
    repo = TaskTableRepo()
    mgr = side("port").manager(task_repo=repo, schedule_interval=3600)
    assert mgr.submit_task(json.dumps(make_task_json("as_str")))
    assert mgr.submit_task(make_task_json("as_dict"))
    assert not mgr.submit_task(make_task_json("bad", rounds=0))  # validated
    assert mgr.get_task_queue() == ["as_str", "as_dict"]


def test_stop_queued_rows_equal_jax():
    def run(s):
        repo = s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600)
        out = [mgr.submit_task(s.tc(make_task_json("stoppable"))),
               mgr.get_task_status("stoppable").name, mgr.stop_task("stoppable"),
               mgr.get_task_status("stoppable").name, mgr.stop_task("ghost")]
        return out, rows(repo)
    got, want = both(run)
    assert got == want and got[0][3] == "STOPPED"


def _gated(real_factory, reached, gate):
    """A runner factory whose runner pauses after its first round until
    ``gate`` is set, so a stop lands at the same round in every run."""
    def factory(tc, stop_event):
        runner = real_factory(tc, stop_event)
        step = runner.step
        calls = []

        def gated_step():
            more = step()
            calls.append(1)
            if len(calls) == 1:
                reached.set()
                gate.wait(60)
            return more
        runner.step = gated_step
        return runner
    return factory


def test_stop_running_rows_equal_jax():
    """A stop of a RUNNING job -> STOPPED, the runner having finished one
    round (the runner honours the stop at its next round boundary)."""
    def run(s):
        repo = s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600)
        reached, gate = threading.Event(), threading.Event()
        mgr._runner_factory = _gated(mgr._default_runner_factory, reached, gate)
        try:
            assert mgr.submit_task(s.tc(make_task_json("run_stop", rounds=500)))
            assert mgr.schedule_once() == "run_stop"
            assert reached.wait(120)
            out = [mgr.get_task_status("run_stop").name, mgr.stop_task("run_stop")]
        finally:
            gate.set()
        out.append(join(mgr._launcher, "job-run_stop").name)
        mgr.release_once()
        out.append(mgr.get_task_status("run_stop").name)
        return out, rows(repo)
    got, want = both(run)
    assert got[0] == want[0] == ["RUNNING", True, "STOPPED", "STOPPED"]
    assert got[1] == want[1]
    assert got[1]["run_stop"]["logical_round"] == 1


def test_boot_recovery_rows_equal_jax():
    def run(s):
        repo = s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600)
        mgr.submit_task(s.tc(make_task_json("r1")))
        mgr.submit_task(s.tc(make_task_json("r2")))
        mgr2 = s.manager(task_repo=repo, schedule_interval=3600)
        return mgr2.get_task_queue(), mgr2.get_task_status("r2").name, rows(repo)
    got, want = both(run)
    assert got == want and got[0] == ["r1", "r2"]


def test_interrupt_watchdog_rows_equal_jax():
    def run(s):
        repo = s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600, interrupt_queue_time=0.0)
        mgr.submit_task(s.tc(make_task_json("late")))
        mgr.interrupt_once(now=time.time() - 100)  # not late yet
        before = mgr.get_task_status("late").name
        mgr.interrupt_once(now=time.time() + 10)
        return before, mgr.get_task_status("late").name, rows(repo)
    got, want = both(run)
    assert got == want and got[:2] == ("QUEUED", "STOPPED")


def test_not_succeeded_before_first_round_rows_equal_jax():
    def run(s):
        gate = threading.Event()

        class SlowRunner:
            stopped = False

            def run(self):
                gate.wait(30)

        repo = s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600,
                        runner_factory=lambda tc, ev: SlowRunner())
        try:
            assert mgr.submit_task(s.tc(make_task_json("slow")))
            assert mgr.schedule_once() == "slow"
            seen = {mgr.get_task_status("slow").name for _ in range(20)}
            snap = rows(repo)
        finally:
            gate.set()
        return seen, snap
    got, want = both(run)
    assert got == want and got[0] == {"RUNNING"}


def test_stop_wins_scheduling_race_rows_equal_jax():
    def run(s):
        repo = s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600)
        assert mgr.submit_task(s.tc(make_task_json("racy")))
        out = [mgr.stop_task("racy"), mgr.schedule_once(), mgr.get_task_status("racy").name]
        return out, rows(repo)
    got, want = both(run)
    assert got == want and got[0] == [True, None, "STOPPED"]


def test_intake_drain_priority_and_change_scheduler_rows_equal_jax(tmp_path):
    """Task JSONs pushed on a SQLite intake are drained by schedule_once
    through submit_task; the higher priority launches first; malformed and
    invalid payloads are dropped."""
    class OkRunner:
        stopped = False

        def run(self):
            return []

    def run(s):
        q = s.queue_repo.SqliteQueueRepo(str(tmp_path / f"intake_{s.name}.db"))
        repo = s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600, intake_queue=q,
                        runner_factory=lambda tc, ev: OkRunner())
        for js in (make_task_json("lo", priority=1), make_task_json("hi", priority=9)):
            q.push(json.dumps(js))
        q.push("{not json")
        q.push(json.dumps(make_task_json("invalid", rounds=0)))
        order = [mgr.schedule_once()]
        order.append(mgr.schedule_once())
        for tid in order:
            join(mgr._launcher, f"job-{tid}")
        out = [order, mgr.change_scheduler("fifo"), len(q), mgr.drain_intake_once()]
        return out, rows(repo)
    got, want = both(run)
    assert got == want
    assert got[0][0] == ["hi", "lo"] and sorted(got[1]) == ["hi", "lo"]


def test_failed_runner_fails_the_job_with_its_error():
    """A runner that fails to build fails its job and the task (never a
    retry elsewhere); the port's row keeps the error."""
    def boom(tc, ev):
        raise RuntimeError("no card for this runner")

    def run(s):
        repo = s.Repo()
        mgr = s.manager(task_repo=repo, schedule_interval=3600, runner_factory=boom)
        assert mgr.submit_task(s.tc(make_task_json("dies")))
        mgr.schedule_once()
        out = [join(mgr._launcher, "job-dies").name]
        mgr.release_once()
        out.append(mgr.get_task_status("dies").name)
        return out, rows(repo), repo
    (jout, jrows, _), (tout, trows, trepo) = both(run)
    assert tout == jout == ["FAILED", "FAILED"] and trows == jrows
    assert "no card for this runner" in trepo.get_item_value("dies", "job_error")


def test_manager_refuses_cuda_without_a_card_and_pool_and_hybrid_split(tmp_path):
    from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager

    with pytest.raises(RuntimeError, match="cuda"):
        TaskManager(schedule_interval=3600)
    with pytest.raises(ValueError, match="A17b"):
        TaskManager(schedule_interval=3600, device="cpu", pool=object())
    (tmp_path / "data").mkdir()
    js = make_task_json("split")
    td = js["target"]["data"][0]
    td.update(data_split_type=True, data_path=str(tmp_path / "data"))
    td["allocation"].update(logical_simulation=[20], device_simulation=[4])
    js["device_simulation"]["resource_request"] = [{"name": "data_0", "devices": ["high"],
                                                    "num_request": [5]}]
    repo = TaskTableRepo()
    rm = side("port").ResourceManager(topology=side("port").topology(),
                                      phone_provider=lambda: {"user1": {"high": 5}})
    mgr = TaskManager(task_repo=repo, resource_manager=rm, schedule_interval=3600,
                      device="cpu")
    assert mgr.submit_task(js)
    with pytest.raises(ValueError, match="A14"):
        mgr._stage_hybrid_data(tcodecs.json2taskconfig(js))
    assert mgr.schedule_once() == "split"
    assert repo.get_item_value("split", "task_status") == "FAILED"
    assert rm.get_resource()["logical_simulation"] == {"cpu": 8.0, "mem": 8.0}


def test_default_factory_passes_device_perf_and_registry():
    from olearning_sim_tpu_torch.performancemgr import PerformanceManager
    from olearning_sim_tpu_torch.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    perf = PerformanceManager(registry=reg)
    repo = TaskTableRepo()
    mgr = side("port").manager(task_repo=repo, schedule_interval=3600, perf=perf,
                               registry=reg)
    runner = mgr._default_runner_factory(tcodecs.json2taskconfig(make_task_json("f")),
                                         threading.Event())
    assert runner.perf is perf and runner.registry is reg and runner.task_repo is repo
    runner.run()
    assert all(v.device.type == "cpu" for v in runner.states["data_0"].params.values())
    assert perf.get_performance("f")["rounds_recorded"] == 2
    assert reg.get("ols_engine_round_phase_duration_seconds") is not None
