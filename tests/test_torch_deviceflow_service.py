"""The port's deviceflow service against the JAX package's, on the same
inputs: strategy validation (``tests/test_deviceflow_validate.py``), the
flow lifecycle, sorter, dispatcher and service scenarios
(``tests/test_deviceflow_service.py``), the durable rooms
(``tests/test_durable_rooms.py``) and the outbound producers
(``tests/test_outbound.py``, with ``websocket`` stubbed in ``sys.modules``
for both packages, since each imports it only when it connects).

Every comparison is exact: validation messages, flow and registry rows,
sorter counts, delivered batches and drop lists under one seed, the
crash-recovery re-arm. Batches are deterministic because every message is
published before the flow is released: a real-time dispatcher then sends
only full batches but the last, and a flow slot waits for its amount."""

import json
import os
import subprocess
import sys
import time
import types
import zlib

import numpy as np
import pytest

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pkg(types.SimpleNamespace):
    pass


def pkg(name):
    """One package's deviceflow, behind the same names."""
    if name == "jax":
        from olearning_sim_tpu import resilience
        from olearning_sim_tpu.deviceflow import (dispatcher, durable_rooms, flow, outbound,
                                                  registry, rooms, service, sorter, validate)
        from olearning_sim_tpu.resilience import events, faults
        from olearning_sim_tpu.utils import repo
    else:
        from olearning_sim_tpu_torch import resilience
        from olearning_sim_tpu_torch.deviceflow import (dispatcher, durable_rooms, flow,
                                                        outbound, registry, rooms, service,
                                                        sorter, validate)
        from olearning_sim_tpu_torch.resilience import events, faults
        from olearning_sim_tpu_torch.utils import repo
    return Pkg(name=name, dispatcher=dispatcher, durable_rooms=durable_rooms, flow=flow,
               outbound=outbound, registry=registry, rooms=rooms, service=service,
               sorter=sorter, validate=validate, resilience=resilience, events=events,
               faults=faults, repo=repo)


def both(fn):
    """``fn(pkg)`` for the JAX package, then the port."""
    return fn(pkg("jax")), fn(pkg("port"))


def same(fn):
    jax_out, port_out = both(fn)
    assert port_out == jax_out
    return port_out


def wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def rt_strategy(batch=5, p=None):
    rt = {"use_strategy": True, "dispatch_batch_sizes": [batch]}
    if p is not None:
        rt["drop_simulation"] = {"drop_probability": p}
    return json.dumps({"real_time_dispatch": rt})


def flow_strategy(total=20, timings=(0, 1), amounts=(10, 10), drop=None):
    spec = {"use": True, "time_type": "relative", "timings": list(timings),
            "amounts": list(amounts)}
    if drop is not None:
        spec["drop_simulation"] = drop
    return json.dumps({"flow_dispatch": {"use_strategy": True, "total_dispatch_amount": total,
                                         "specific_timing": spec}})


def interval_strategy(total, intervals, domains, functions, drop=None):
    spec = {"use": True, "time_type": "relative", "intervals": intervals,
            "dispatch_rules": {"domains": domains, "functions": functions}}
    if drop is not None:
        spec["drop_simulation"] = drop
    return json.dumps({"flow_dispatch": {"use_strategy": True, "total_dispatch_amount": total,
                                         "specific_interval": spec}})


# ------------------------------------------------------------- validation
def _timing(**kw):
    spec = {"use": True, "time_type": kw.get("time_type", "relative"),
            "timings": kw.get("timings", [0, 5]), "amounts": kw.get("amounts", [5, 5])}
    if "time_zone" in kw:
        spec["time_zone"] = kw["time_zone"]
    if "drop" in kw:
        spec["drop_simulation"] = kw["drop"]
    return {"flow_dispatch": {"use_strategy": True, "total_dispatch_amount": kw.get("total", 10),
                              "specific_timing": spec}}


def _interval(intervals, domains, functions, **kw):
    return json.loads(interval_strategy(kw.get("total", 100), intervals, domains, functions,
                                        kw.get("drop")))


ABS = [["2026-01-01 00:00:00", "2026-01-01 00:01:00"]]
STRATEGIES = {
    "empty": {},
    "both": {"real_time_dispatch": {"use_strategy": True},
             "flow_dispatch": {"use_strategy": True}},
    "rt": {"real_time_dispatch": {"use_strategy": True}},
    "rt_p0.5": json.loads(rt_strategy(5, 0.5)),
    "rt_p1.5": json.loads(rt_strategy(5, 1.5)),
    "rt_p-0.1": json.loads(rt_strategy(5, -0.1)),
    "flow_no_specific": {"flow_dispatch": {"use_strategy": True, "total_dispatch_amount": 10}},
    "timing": _timing(),
    "timing_sizes": _timing(amounts=[5]),
    "timing_total": _timing(amounts=[5, 6]),
    "timing_negative": _timing(timings=[-1, 5]),
    "abs_no_zone": _timing(time_type="absolute", timings=ABS),
    "abs_bad_zone": _timing(time_type="absolute", time_zone="Mars/Olympus", timings=ABS),
    "abs_ok": _timing(time_type="absolute", time_zone="Asia/Shanghai", timings=ABS),
    "abs_bad_date": _timing(time_type="absolute", time_zone="Asia/Shanghai",
                            timings=[["not-a-date", "2026-01-01 00:01:00"]]),
    "drop_both": _timing(drop={"drop_probability": [0.1, 0.2], "drop_amounts": [1, 1]}),
    "drop_p_range": _timing(drop={"drop_probability": [0.1, 1.2]}),
    "drop_amounts_sum": _timing(drop={"drop_amounts": [10, 20]}),
    "drop_p_ok": _timing(drop={"drop_probability": [0.1, 0.9]}),
    "interval_ok": _interval([[1, 2], [2, 3]], [[0, 1], [0, 1]], ["t", "t"]),
    "interval_equal_ends": _interval([[1, 1], [2, 3]], [[0, 1], [0, 1]], ["t", "t"]),
    "interval_overlap": _interval([[1, 3], [2, 4]], [[0, 1], [0, 1]], ["t", "t"]),
    "interval_sizes": _interval([[0, 5]], [[0, 1], [0, 1]], ["t"]),
    "interval_domain": _interval([[0, 5]], [[1, 1]], ["t"]),
    "interval_not_t": _interval([[0, 5]], [[0, 1]], ["undefined_var + 1"]),
    "interval_sin": _interval([[0, 5]], [[0.0, 6.28]], ["math.sin(t)+1"]),
    "not_json": "not-json{",
}


@pytest.mark.parametrize("case", sorted(STRATEGIES))
def test_check_strategy_equals_jax(case):
    s = STRATEGIES[case]
    same(lambda p: p.validate.check_strategy(json.loads(json.dumps(s)) if isinstance(s, dict)
                                             else s))


@pytest.mark.parametrize("resource,strategy", [
    ("logical_simulation", "not json{"), ("gpu_simulation", "{}"),
    ("device_simulation", rt_strategy()), ("logical_simulation", flow_strategy()),
])
def test_check_notify_start_params_equals_jax(resource, strategy):
    same(lambda p: p.validate.check_notify_start_params(resource, strategy))


# -------------------------------------------------------- flow and sorter
def test_flow_manager_lifecycle_equals_jax():
    def run(p):
        fm = p.flow.FlowManager()
        flow, out = {}, []
        ok, params = fm.notify_start(flow, "t1", "t1_op_0", "logical_simulation", "s", {})
        flow["t1_op_0"] = params
        out.append((ok, json.dumps(params)))
        out.append(fm.notify_start(flow, "t1", "t1_op_0", "device_simulation", "DIFFERENT", {})[0])
        out.append(fm.notify_start(flow, "t1", "t1_op_0", "device_simulation", "s",
                                   {"ws": {"type": "memory"}})[0])
        out.append(fm.notify_start(flow, "t2", "t1_op_0", "device_simulation", "s", {})[0])
        reg = {"total_compute_resources": ["logical_simulation", "device_simulation"]}
        out.append((fm.check_all_notify_start(reg, params),
                    fm.check_all_notify_complete(reg, params)))
        for res in ("logical_simulation", "device_simulation"):
            ok, params = fm.notify_complete(flow, "t1", "t1_op_0", res)
            out.append((ok, fm.check_all_notify_complete(reg, params)))
        out.append(fm.notify_complete(flow, "t1", "missing", "logical_simulation"))
        out.append(fm.repo.query_all())
        return out
    out = same(run)
    assert out[1] is False and out[-2] == (False, {}) and out[-3] == (True, True)


def test_flow_recovery_from_repo_equals_jax():
    def run(p):
        repo = p.repo.MemoryTableRepo(p.flow.FLOW_COLUMNS)
        fm = p.flow.FlowManager(repo=repo)
        flow = {}
        for fid in ("t1_op_0", "t1_op_1"):
            ok, params = fm.notify_start(flow, "t1", fid, "logical_simulation", "s", {})
            flow[fid] = params
        flow["t1_op_1"]["isFinished"] = True
        fm.persist("t1_op_1", "t1", flow["t1_op_1"])
        return p.flow.FlowManager(repo=repo).load_flows()
    assert list(same(run)) == ["t1_op_0"]


def test_sorter_gates_equal_jax():
    def run(p):
        shelf = p.rooms.ShelfRoom()
        sorter = p.sorter.Sorter(shelf)
        flow, out = {}, []
        msg = p.rooms.Message("t1_op_0", "logical_simulation", b"g1")
        out.append(sorter.sort(flow, msg))
        flow["t1_op_0"] = {"notify_start_called": {"logical_simulation": True},
                           "notify_complete_called": {}}
        out.append(sorter.sort(flow, msg))
        out.append(sorter.sort(flow, p.rooms.Message("t1_op_0", "device_simulation", b"d")))
        flow["t1_op_0"]["notify_complete_called"]["logical_simulation"] = True
        out.append(sorter.sort(flow, msg))
        return out, sorter.accepted, sorter.discarded, shelf.shelf_size("t1_op_0")
    assert same(run) == ([False, True, False, False], 1, 3, 1)


def test_task_registry_rows_equal_jax():
    def run(p):
        reg = p.registry.TaskRegistry()
        out = [reg.register_task("t1", ["logical_simulation"]),
               reg.register_task("t1", ["logical_simulation"]),
               reg.register_task("t1", ["device_simulation"]),
               reg.register_task("t2", ["logical_simulation", "device_simulation"])]
        rows = reg.repo.query_all()
        recovered = p.registry.TaskRegistry(repo=reg.repo).get("t2")
        reg.unregister_task("t1")
        return out, rows, recovered, reg.is_registered("t1"), reg.repo.query_all()
    assert same(run)[0] == [True, True, False, True]


# ------------------------------------------------------------- dispatcher
def _dispatch(p, strategy, n_msgs, seed, flow_id="f", release_first=True):
    shelf = p.rooms.ShelfRoom()
    shelf.add_shelf(flow_id)
    for i in range(n_msgs):
        shelf.put_on_shelf(flow_id, i)
    batches = []
    clock = p.dispatcher.VirtualClock()
    disp = p.dispatcher.Dispatcher(flow_id, strategy, shelf, lambda b: batches.append(list(b)),
                                   clock=clock, rng=np.random.default_rng(seed),
                                   poll_interval=0.005)
    if release_first:
        disp.release_dispatch()
    disp.dispatch()
    return batches, disp.sent, disp.dropped, clock.now()


def test_dispatcher_flow_schedule_virtual_time_equals_jax():
    batches, sent, dropped, now = same(lambda p: _dispatch(p, flow_strategy(), 20, 0))
    assert sent == 20 and dropped == 0 and now >= 1.0 and len(batches) == 2


DROP_CASES = {
    "rt_p0.3": (rt_strategy(4, 0.3), 37),
    "rt_p0.05_batch1": (rt_strategy(1, 0.05), 25),
    "timing_drop_p": (flow_strategy(30, (0, 2, 5), (10, 15, 5),
                                    {"drop_probability": [0.2, 0.5, 0.0]}), 30),
    "timing_drop_amounts": (flow_strategy(20, (0, 1), (12, 8), {"drop_amounts": [3, 2]}), 20),
    "interval_sin_drop": (interval_strategy(40, [[0, 4], [4, 8]], [[0.0, 3.14], [0.0, 1.0]],
                                            ["math.sin(t)+1", "t+1"],
                                            {"drop_probability": [0.3, 0.1]}), 40),
}


@pytest.mark.parametrize("case", sorted(DROP_CASES))
@pytest.mark.parametrize("seed", [0, 11])
def test_dispatcher_drop_lists_equal_jax(case, seed):
    strategy, n = DROP_CASES[case]
    batches, sent, dropped, _ = same(lambda p: _dispatch(p, strategy, n, [seed, 3]))
    assert sent + dropped == n and sum(map(len, batches)) == sent


def test_real_time_drops_match_a_numpy_oracle():
    """Each message is kept unless the flow's generator draws below p, in
    shelf order: the plain rule the dispatcher implements."""
    batches, _, _, _ = _dispatch(pkg("port"), rt_strategy(4, 0.3), 37, 5)
    rng = np.random.default_rng(5)
    assert sum(batches, []) == [i for i in range(37) if not rng.random() < 0.3]


# ---------------------------------------------------------------- service
def _batches_factory(out):
    def factory(flow_id, cfg):
        return lambda batch: out.setdefault(flow_id, []).append(list(batch))
    return factory


def test_service_end_to_end_real_time_equals_jax():
    def run(p):
        svc = p.service.DeviceFlowService(poll_interval=0.005)
        svc.start()
        try:
            assert svc.register_task("t1", ["logical_simulation"])
            ok, msg = svc.notify_start("t1", "t1_op_0", "logical_simulation", rt_strategy())
            for i in range(17):
                svc.publish("t1_op_0", "logical_simulation", f"update-{i}")
            assert wait_until(lambda: svc.sorter.accepted == 17)
            done = svc.notify_complete("t1", "t1_op_0", "logical_simulation")
            assert wait_until(lambda: svc.check_dispatch_finished("t1"))
            return (ok, msg), done, svc.delivered, svc.sorter.accepted, svc.sorter.discarded
        finally:
            svc.stop()
    out = same(run)
    assert out[2]["t1_op_0"] == [f"update-{i}" for i in range(17)]


def test_service_rejects_unregistered_and_bad_strategy_equals_jax():
    def run(p):
        svc = p.service.DeviceFlowService(poll_interval=0.005)
        out = [svc.notify_start("ghost", "ghost_op_0", "logical_simulation", rt_strategy())]
        svc.register_task("t1", ["logical_simulation"])
        out.append(svc.notify_start("t1", "t1_op_0", "logical_simulation", "not-json{"))
        out.append(svc.notify_start("t1", "t1_op_0", "gpu_simulation", rt_strategy()))
        out.append(svc.notify_start("t1", "t1_op_0", "logical_simulation", rt_strategy(5, 2.0)))
        out.append(svc.notify_complete("t1", "never_started", "logical_simulation",
                                       flush_timeout=0.1))
        return out, svc.check_dispatch_finished("t1")
    out, finished = same(run)
    assert out[0] == (False, "task ghost not registered") and finished


def test_service_two_resources_flow_mode_equals_jax():
    def run(p):
        flow_repo = p.repo.MemoryTableRepo(p.flow.FLOW_COLUMNS)
        svc = p.service.DeviceFlowService(flow_repo=flow_repo, poll_interval=0.005,
                                          clock=p.dispatcher.VirtualClock())
        svc.start()
        try:
            svc.register_task("t2", ["logical_simulation", "device_simulation"])
            strat = flow_strategy(total=10, timings=[0], amounts=[10])
            out = [svc.notify_start("t2", "t2_op_0", "logical_simulation", strat)]
            for i in range(6):
                svc.publish("t2_op_0", "logical_simulation", i)
            assert wait_until(lambda: svc.sorter.accepted == 6)
            out.append((svc.check_dispatch_finished("t2"), flow_repo.query_all()))
            out.append(svc.notify_start("t2", "t2_op_0", "device_simulation", strat))
            for i in range(4):
                svc.publish("t2_op_0", "device_simulation", 100 + i)
            assert wait_until(lambda: svc.sorter.accepted == 10)
            out.append(svc.notify_complete("t2", "t2_op_0", "logical_simulation"))
            out.append((svc.check_dispatch_finished("t2"), flow_repo.query_all()))
            out.append(svc.notify_complete("t2", "t2_op_0", "device_simulation"))
            assert wait_until(lambda: svc.check_dispatch_finished("t2"))
            assert wait_until(lambda: not flow_repo.query_all())
            out.append((svc.delivered, svc.registry.repo.query_all()))
            return out
        finally:
            svc.stop()
    out = same(run)
    assert sorted(out[-1][0]["t2_op_0"]) == [0, 1, 2, 3, 4, 5, 100, 101, 102, 103]


def test_crash_recovery_rearms_dispatch_equals_jax():
    def run(p):
        repo = p.repo.MemoryTableRepo(p.flow.FLOW_COLUMNS)
        reg_repo = p.repo.MemoryTableRepo(p.registry.REGISTRY_COLUMNS)
        svc = p.service.DeviceFlowService(flow_repo=repo, registry_repo=reg_repo,
                                          poll_interval=0.005)
        svc.register_task("tR", ["logical_simulation"])
        assert svc.notify_start("tR", "tR_op_0", "logical_simulation", rt_strategy())[0]
        # "crash": no thread ran; a new service recovers from the tables
        svc2 = p.service.DeviceFlowService(flow_repo=repo, registry_repo=reg_repo,
                                           poll_interval=0.005)
        recovered = json.loads(json.dumps(svc2.flow))
        svc2.start()
        try:
            for i in range(5):
                svc2.publish("tR_op_0", "logical_simulation", i)
            done = svc2.notify_complete("tR", "tR_op_0", "logical_simulation")
            assert wait_until(lambda: svc2.check_dispatch_finished("tR"))
            return recovered, done, svc2.delivered
        finally:
            svc2.stop()
    recovered, _, delivered = same(run)
    assert recovered["tR_op_0"]["to_dispatch"] is True and delivered["tR_op_0"] == [0, 1, 2, 3, 4]


def test_crashed_dispatcher_leaves_flow_open_equals_jax():
    def run(p):
        calls = []

        def bad_outbound(flow_id, cfg):
            def producer(batch):
                calls.append(list(batch))
                raise RuntimeError("outbound endpoint down")
            return producer

        svc = p.service.DeviceFlowService(poll_interval=0.005, outbound_factory=bad_outbound)
        svc.start()
        try:
            svc.register_task("tX", ["logical_simulation"])
            svc.notify_start("tX", "tX_op_0", "logical_simulation", rt_strategy())
            for i in range(12):
                svc.publish("tX_op_0", "logical_simulation", i)
            assert wait_until(lambda: svc.sorter.accepted == 12)
            svc.notify_complete("tX", "tX_op_0", "logical_simulation")
            assert wait_until(lambda: "tX_op_0" in svc._dispatch_failed)
            return calls, svc.check_dispatch_finished("tX"), svc.shelf_room.shelf_size("tX_op_0")
        finally:
            svc.stop()
    assert same(run) == ([[0, 1, 2, 3, 4]], False, 7)


@pytest.mark.parametrize("seed", [0, 7])
def test_service_seeded_drops_equal_jax(seed):
    """The service seeds each flow's generator with [seed, crc32(flow id)]:
    one seed gives both packages the same drops, and a numpy oracle."""
    strategy = rt_strategy(batch=6, p=0.25)

    def run(p):
        batches = {}
        svc = p.service.DeviceFlowService(poll_interval=0.005, seed=seed,
                                          outbound_factory=_batches_factory(batches))
        svc.start()
        try:
            svc.register_task("tS", ["logical_simulation"])
            for r in range(2):
                svc.notify_start("tS", f"tS_train_{r}", "logical_simulation", strategy)
                for i in range(40):
                    svc.publish(f"tS_train_{r}", "logical_simulation", {"r": r, "i": i})
            assert wait_until(lambda: svc.sorter.accepted == 80)
            for r in range(2):
                svc.notify_complete("tS", f"tS_train_{r}", "logical_simulation")
            assert wait_until(lambda: svc.check_dispatch_finished("tS"))
            return batches
        finally:
            svc.stop()
    batches = same(run)
    for r in range(2):
        fid = f"tS_train_{r}"
        rng = np.random.default_rng([seed, zlib.crc32(fid.encode())])
        kept = [{"r": r, "i": i} for i in range(40) if not rng.random() < 0.25]
        assert sum(batches[fid], []) == kept
        assert all(len(b) == 6 for b in batches[fid][:-1])


@pytest.mark.parametrize("point", ["deviceflow.notify_start", "deviceflow.notify_complete",
                                   "deviceflow.publish"])
def test_service_fault_points_equal_jax(point):
    def run(p):
        log = p.events.ResilienceLog()
        svc = p.service.DeviceFlowService(poll_interval=0.005)
        svc.register_task("tF", ["logical_simulation"])
        plan = p.faults.FaultPlan(seed=1, specs=[p.faults.FaultSpec(point=point, times=1,
                                                                    error="io")])
        out = []
        with p.faults.chaos(plan, log=log):
            out.append(svc.notify_start("tF", "tF_op_0", "logical_simulation", rt_strategy()))
            try:
                svc.publish("tF_op_0", "logical_simulation", 1)
                out.append("published")
            except Exception as e:  # noqa: BLE001 — the injected fault's type is compared
                out.append(type(e).__name__)
            out.append(svc.notify_complete("tF", "tF_op_0", "logical_simulation",
                                           flush_timeout=0.05))
        return out, log.count("fault_injected")
    out, fired = same(run)
    assert fired == 1


# --------------------------------------------------------- durable rooms
def test_inbound_room_claims_revert_on_reopen_equals_jax(tmp_path):
    def run(p):
        path = str(tmp_path / f"{p.name}_rooms.db")
        room = p.durable_rooms.SqliteInboundRoom(path)
        for i in range(3):
            room.put(p.rooms.Message("f", "logical_simulation", {"i": i}))
        got = room.get(timeout=1)
        out = [got.payload]
        room.ack(got)
        out.append(room.get(timeout=1).payload)
        room.close()
        room2 = p.durable_rooms.SqliteInboundRoom(path)
        out += [room2.qsize(), room2.get(timeout=1).payload, room2.get(timeout=1).payload,
                room2.get(timeout=0.01)]
        room2.close()
        return out
    assert same(run) == [{"i": 0}, {"i": 1}, 2, {"i": 1}, {"i": 2}, None]


def test_shelf_room_take_ack_and_recovery_equals_jax(tmp_path):
    def run(p):
        path = str(tmp_path / f"{p.name}_rooms.db")
        shelf = p.durable_rooms.SqliteShelfRoom(path)
        shelf.add_shelf("f1")
        out = [shelf.has_shelf("f1"), shelf.has_shelf("nope"), shelf.put_on_shelf("nope", "x")]
        out += [shelf.put_on_shelf("f1", i) for i in range(6)]
        out.append(shelf.take_from_shelf("f1", 2))
        shelf.ack_flow("f1")
        out.append(shelf.take_from_shelf("f1", 2))
        shelf.park_flow("f1")
        out.append((shelf.shelf_size("f1"), shelf.take_from_shelf("f1", 1)))
        shelf.close()
        shelf2 = p.durable_rooms.SqliteShelfRoom(path)
        out += [shelf2.has_shelf("f1"), shelf2.shelf_size("f1"), shelf2.take_from_shelf("f1", 10)]
        shelf2.close_shelf("f1")
        out += [shelf2.has_shelf("f1"), shelf2.shelf_size("f1")]
        shelf2.close()
        return out
    out = same(run)
    assert out[-5:] == [True, 4, [2, 3, 4, 5], False, 0]


def test_durable_service_redelivers_after_crash_equals_jax(tmp_path):
    """A producer that fails on the third batch kills its dispatcher with
    the batch claimed and unacked; a new service over the same files re-arms
    the flow and delivers the rest: every payload once, in order."""
    def run(p):
        d = tmp_path / p.name
        d.mkdir()
        flows = p.repo.SqliteTableRepo(str(d / "flows.db"), "flows", p.flow.FLOW_COLUMNS)
        delivered, calls = [], []

        def factory(phase):
            def make(flow_id, cfg):
                def producer(batch):
                    calls.append((phase, list(batch)))
                    if phase == 1 and len(calls) == 3:
                        raise ConnectionError("sink down")
                    delivered.append(list(batch))
                return producer
            return make

        strategy = rt_strategy(batch=4)
        svc = p.service.DeviceFlowService(flow_repo=flows, outbound_factory=factory(1),
                                          rooms_path=str(d / "rooms.db"), poll_interval=0.005)
        svc.register_task("t1", ["logical_simulation"])
        svc.start()
        svc.notify_start("t1", "t1_op_0", "logical_simulation", strategy)
        for i in range(18):
            svc.publish("t1_op_0", "logical_simulation", {"uid": i})
        svc.notify_complete("t1", "t1_op_0", "logical_simulation")
        assert wait_until(lambda: "t1_op_0" in svc._dispatch_failed)
        svc.stop()
        svc.inbound.close()
        svc.shelf_room.close()
        svc2 = p.service.DeviceFlowService(flow_repo=flows, outbound_factory=factory(2),
                                           rooms_path=str(d / "rooms.db"), poll_interval=0.005)
        recovered = sorted(svc2.flow)
        svc2.register_task("t1", ["logical_simulation"])
        svc2.start()
        try:
            assert wait_until(lambda: svc2.check_dispatch_finished("t1"))
        finally:
            svc2.stop()
        return recovered, calls, delivered, flows.query_all()
    recovered, calls, delivered, rows = same(run)
    assert recovered == ["t1_op_0"] and rows == []
    assert [m["uid"] for b in delivered for m in b] == list(range(18))


KILL_N, KILL_BATCH, KILL_AFTER = 24, 4, 2


def _kill_phase(tmp, phase):
    """Child body (the port only): a durable service over shared SQLite
    state; phase 1 publishes everything and dies inside the producer
    (``os._exit``, no cleanup, as SIGKILL), phase 2 recovers and drains."""
    from olearning_sim_tpu_torch.deviceflow import DeviceFlowService
    from olearning_sim_tpu_torch.deviceflow.flow import FLOW_COLUMNS
    from olearning_sim_tpu_torch.utils.repo import SqliteTableRepo

    delivered_path = os.path.join(tmp, "delivered.jsonl")
    complete_flag = os.path.join(tmp, "complete.flag")
    state = {"batches": 0}

    def outbound_factory(flow_id, cfg):
        def producer(batch):
            if phase == 1 and state["batches"] >= KILL_AFTER:
                while not os.path.exists(complete_flag):
                    time.sleep(0.01)
                os._exit(17)
            with open(delivered_path, "a") as f:
                for payload in batch:
                    f.write(json.dumps(payload) + "\n")
                f.flush()
                os.fsync(f.fileno())
            state["batches"] += 1
        return producer

    svc = DeviceFlowService(
        flow_repo=SqliteTableRepo(os.path.join(tmp, "flows.db"), "flows", FLOW_COLUMNS),
        outbound_factory=outbound_factory, rooms_path=os.path.join(tmp, "rooms.db"),
        poll_interval=0.02)
    assert svc.register_task("t1", ["logical_simulation"])
    svc.start()
    if phase == 1:
        assert svc.notify_start("t1", "t1_op_0", "logical_simulation",
                                rt_strategy(batch=KILL_BATCH))[0]
        for i in range(KILL_N):
            svc.publish("t1_op_0", "logical_simulation", {"uid": i})
        assert svc.notify_complete("t1", "t1_op_0", "logical_simulation")[0]
        with open(complete_flag, "w") as f:
            f.write("done")
        time.sleep(30)
        raise SystemExit("phase 1 was supposed to die mid-dispatch")
    assert wait_until(lambda: svc.check_dispatch_finished("t1"), timeout=30)
    svc.stop()
    os._exit(0)


def test_kill_mid_dispatch_delivers_exactly_once(tmp_path):
    """The port's durable rooms across a process death (the JAX package's
    slow-marked ``test_durable_rooms.py`` case): every payload exactly once."""
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    code = ("import sys, test_torch_deviceflow_service as t; "
            "t._kill_phase(sys.argv[2], 1 if sys.argv[1] == 'phase1' else 2)")
    env["PYTHONPATH"] = os.path.join(REPO, "tests") + os.pathsep + env["PYTHONPATH"]
    p1 = subprocess.run([sys.executable, "-c", code, "phase1", str(tmp_path)], env=env,
                        timeout=120, capture_output=True, text=True)
    assert p1.returncode == 17, (p1.stdout, p1.stderr)
    lines = (tmp_path / "delivered.jsonl").read_text().splitlines()
    assert len(lines) == KILL_AFTER * KILL_BATCH
    p2 = subprocess.run([sys.executable, "-c", code, "phase2", str(tmp_path)], env=env,
                        timeout=120, capture_output=True, text=True)
    assert p2.returncode == 0, (p2.stdout, p2.stderr)
    lines = (tmp_path / "delivered.jsonl").read_text().splitlines()
    assert sorted(json.loads(ln)["uid"] for ln in lines) == list(range(KILL_N))


# --------------------------------------------------------------- outbound
class FakeSocket:
    def __init__(self, sink, url, fail_sends):
        self.sink, self.url, self.fail_sends = sink, url, fail_sends

    def send(self, frame):
        if self.fail_sends:
            self.fail_sends.pop()
            raise ConnectionError("socket closed")
        self.sink.append((self.url, frame))

    def close(self):
        self.sink.append((self.url, "<close>"))


@pytest.fixture
def fake_websocket(monkeypatch):
    """A stub ``websocket`` module (websocket-client's create_connection):
    both packages' producers import it when they connect."""
    sink, fail_sends = [], []
    mod = types.ModuleType("websocket")
    mod.create_connection = lambda url, timeout=None: FakeSocket(sink, url, fail_sends)
    monkeypatch.setitem(sys.modules, "websocket", mod)
    return sink, fail_sends


def test_websocket_producer_frames_equal_jax(fake_websocket):
    sink, fail_sends = fake_websocket

    def run(p):
        del sink[:]
        prod = p.outbound.WebsocketProducer("ws://agg:1/ws")
        prod([{"grad": [1, 2]}, "raw-string"])
        fail_sends.append(1)  # the next send fails once: one reconnect
        prod([{"again": True}])
        prod.close()
        return list(sink)
    frames = same(run)
    assert frames[1][1] == json.dumps({"payload": "cmF3LXN0cmluZw=="})
    assert [f for _, f in frames].count("<close>") == 2


def test_factory_dispatch_equals_jax():
    def run(p):
        fallback_calls = []
        factory = p.outbound.make_outbound_factory(
            fallback=lambda fid, cfg: fallback_calls.append((fid, cfg)) or (lambda b: None))
        ws = factory("f", {"type": "websocket", "url": "ws://x", "task_id": "t9"})
        factory("f", {"type": "memory"})
        try:
            p.outbound.make_outbound_factory()("f", {"type": "pulsar"})
            refused = None
        except ValueError as e:
            refused = str(e)
        return (type(ws).__name__, type(ws.inner).__name__, ws.task_id, ws.flow_id,
                fallback_calls, refused, factory.accepts_task_id)
    assert same(run)[:2] == ("ResilientProducer", "WebsocketProducer")


def test_deviceflow_streams_to_websocket_equals_jax(fake_websocket):
    sink, _ = fake_websocket

    def run(p):
        del sink[:]
        svc = p.service.DeviceFlowService(poll_interval=0.005)
        svc.start()
        try:
            svc.register_task("t1", ["logical_simulation"])
            ok = svc.notify_start("t1", "t1_op_0", "logical_simulation", rt_strategy(5),
                                  outbound_service={"type": "websocket", "url": "ws://agg:2"})
            for i in range(12):
                svc.publish("t1_op_0", "logical_simulation", {"update": i})
            assert wait_until(lambda: svc.sorter.accepted == 12)
            svc.notify_complete("t1", "t1_op_0", "logical_simulation")
            assert wait_until(lambda: svc.check_dispatch_finished("t1"))
            return ok, list(sink), svc.delivered
        finally:
            svc.stop()
    ok, frames, delivered = same(run)
    assert ok[0] and len(frames) == 12 and delivered == {}


def test_bad_outbound_config_fails_only_that_flow_equals_jax():
    def run(p):
        svc = p.service.DeviceFlowService(poll_interval=0.005)
        svc.start()
        try:
            svc.register_task("bad", ["logical_simulation"])
            svc.notify_start("bad", "bad_op_0", "logical_simulation", rt_strategy(4),
                             outbound_service={"type": "websocket"})  # no url
            svc.publish("bad_op_0", "logical_simulation", {"u": 0})
            svc.notify_complete("bad", "bad_op_0", "logical_simulation")
            svc.register_task("good", ["logical_simulation"])
            svc.notify_start("good", "good_op_0", "logical_simulation", rt_strategy(4))
            for i in range(4):
                svc.publish("good_op_0", "logical_simulation", {"u": i})
            svc.notify_complete("good", "good_op_0", "logical_simulation")
            assert wait_until(lambda: svc.check_dispatch_finished("good"))
            return svc.delivered, svc.check_dispatch_finished("bad"), sorted(svc._dispatch_failed)
        finally:
            svc.stop()
    assert same(run)[1:] == (False, ["bad_op_0"])


@pytest.mark.parametrize("on_failure", ["degrade", "raise"])
def test_resilient_producer_equals_jax(on_failure):
    def run(p):
        log = p.events.ResilienceLog()
        sent = []

        def flaky(batch):
            if len(batch) == 2:
                raise ConnectionError("websocket closed")
            sent.append(list(batch))

        prod = p.outbound.ResilientProducer(
            flaky, "f1", retry_policy=p.resilience.RetryPolicy(
                max_attempts=2, base_delay=0.0, jitter=0.0, sleep=lambda _s: None),
            on_failure=on_failure, log=log, task_id="t1")
        out = []
        for batch in ([1], [2, 3], [4]):
            try:
                prod(batch)
                out.append("ok")
            except ConnectionError:
                out.append("raised")
        return (out, sent, prod.dropped_batches, prod.dropped_messages,
                [(e.kind, e.point, e.task_id) for e in log.events()])
    out = same(run)
    assert out[0] == (["ok", "ok", "ok"] if on_failure == "degrade" else ["ok", "raised", "ok"])
