"""The JAX package's gRPC tests, run against the port on the CPU: the
session's five cases (``tests/test_session.py``), the task manager end to
end over the wire (``tests/test_taskmgr.py``), the gRPC outbound producer
and a deviceflow streaming to a gRPC sink (``tests/test_outbound.py``, the
batches equal JAX's under one seed), the entry point serving gRPC
(``tests/test_config.py``, with ``--device cpu``; a JAX client drives a task
to SUCCEEDED through it and it exits 0 on SIGTERM), and DeviceFlow in a
child process driven over the wire (``tests/test_multiprocess_session.py``,
whose cases JAX marks slow; the port's are kept short and unmarked)."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import grpc
import pytest
import torch

import torch_threads  # noqa: F401
from test_outbound import GrpcSink
from test_taskmgr import make_task_json
from test_torch_taskmgr import rows

from olearning_sim_tpu_torch.services import SimulatorSession
from olearning_sim_tpu_torch.services.grpc_services import (
    DeviceFlowClient,
    PerformanceMgrClient,
    PhoneManagerClient,
    ResourceMgrClient,
    SliceMgrClient,
)
from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig
from olearning_sim_tpu_torch.taskmgr.grpc_service import TaskMgrClient
from olearning_sim_tpu_torch.taskmgr.proto_codec import taskconfig_to_proto
from olearning_sim_tpu_torch.taskmgr.status import TaskStatus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wait_for(cond, timeout=60.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.02)
    return False


def wire_tc(js):
    return taskconfig_to_proto(json2taskconfig(js))


def _topology(side="port"):
    if side == "jax":
        from olearning_sim_tpu.resourcemgr import TpuTopology as Topology
    else:
        from olearning_sim_tpu_torch.resourcemgr import DeviceTopology as Topology
    return Topology(num_chips=1, num_cores=8, platform="cpu", device_kinds=["cpu"],
                    cpu=8.0, mem=8.0)


# ------------------------------------------------------ tests/test_session.py
@pytest.fixture
def session():
    from olearning_sim_tpu_torch.clustermgr import ClusterManager
    from olearning_sim_tpu_torch.performancemgr import PerformanceManager
    from olearning_sim_tpu_torch.phonemgr import SimulatedPhoneFarm
    from olearning_sim_tpu_torch.resourcemgr import ResourceManager
    from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager

    farm = SimulatedPhoneFarm(inventory={"user1": {"high": 20}}, speedup=1000.0)
    rm = ResourceManager(topology=_topology(),
                         phone_provider=farm.get_device_available_resource)
    perf = PerformanceManager()
    mgr = TaskManager(resource_manager=rm, phone_client=farm, perf=perf,
                      schedule_interval=0.05, release_interval=0.05,
                      interrupt_interval=3600, device="cpu")
    sess = SimulatorSession(resource_manager=rm, task_manager=mgr, phone_farm=farm,
                            performance_manager=perf,
                            cluster_manager=ClusterManager(devices=[torch.device("cpu")] * 8),
                            device="cpu")
    sess.start()
    yield sess
    sess.stop()


@pytest.fixture
def channel(session):
    with grpc.insecure_channel(f"127.0.0.1:{session.port}") as ch:
        yield ch


def test_all_services_respond(session, channel):
    res = ResourceMgrClient(channel).get_resource()
    assert res["logical_simulation"]["cpu"] == 8.0
    assert res["device_simulation"]["user1"]["high"] == 20
    assert res["topology"]["platform"] == "cpu"

    slices = SliceMgrClient(channel)
    ok, _ = slices.create_slice("s1", 4, user_id="user1")
    assert ok
    assert slices.query_slice("s1")["num_devices"] == 4
    ok, msg = slices.create_slice("s1", 2)
    assert not ok and "exists" in msg
    assert slices.delete_slice("s1")
    assert slices.query_slice("s1") is None

    phones = PhoneManagerClient(channel)
    assert phones.get_device_available_resource() == {"user1": {"high": 20}}
    assert phones.submit_task("pt", rounds=1, operators=["train"],
                              data=[{"name": "d", "devices": ["high"], "nums": [2]}])
    assert wait_for(lambda: phones.get_device_task_status("pt")["is_finished"], 10)
    assert phones.get_device_task_status("pt")["round"] == 1

    flow = DeviceFlowClient(channel)
    assert flow.register_task("ft", ["logical_simulation"])
    strategy = json.dumps(
        {"real_time_dispatch": {"use_strategy": True, "dispatch_batch_sizes": [5]}})
    ok, _ = flow.notify_start("ft", "ft_train_0", "logical_simulation", strategy)
    assert ok
    ok, _ = flow.notify_complete("ft", "ft_train_0", "logical_simulation")
    assert ok
    assert wait_for(lambda: flow.check_dispatch_finished("ft"), timeout=30)
    assert flow.unregister_task("ft")
    assert flow.get_outbound_endpoint()["kind"] == "queue"

    perf = PerformanceMgrClient(channel)
    assert perf.get_performance("none")["rounds_recorded"] == 0
    ctype, body = perf.get_metrics()
    assert ctype.startswith("text/plain")
    assert "ols_deviceflow_queue_depth" in body  # the session's deviceflow loops
    ctype_json, body_json = perf.get_metrics("json")
    assert ctype_json == "application/json"
    assert "ols_deviceflow_queue_depth" in json.loads(body_json)


def test_task_through_session(session, channel):
    """Full platform path over the wire: submit -> scheduled -> the port's
    engine on the CPU -> SUCCEEDED, with perf recorded."""
    tasks = TaskMgrClient(channel)
    assert tasks.submitTask(wire_tc(make_task_json("sess_task"))).is_success
    assert wait_for(lambda: tasks.getTaskStatus("sess_task").taskStatus
                    == int(TaskStatus.SUCCEEDED), timeout=120), \
        f"status={tasks.getTaskStatus('sess_task').taskStatus}"
    perf = PerformanceMgrClient(channel)
    report = perf.get_performance("sess_task")
    assert report["rounds_recorded"] >= 1
    assert report["device_rounds_per_sec"] > 0
    _, body = perf.get_metrics()
    assert "ols_engine_round_phase_duration_seconds_bucket" in body
    assert 'ols_taskmgr_state_transitions_total{status="RUNNING"}' in body


def test_default_session_composition():
    """SimulatorSession(device="cpu") with no other argument serves a
    working default stack on an ephemeral port."""
    sess = SimulatorSession(device="cpu")
    assert sess.address == "127.0.0.1:0"
    sess.start()
    try:
        assert sess.port > 0
        for name in ("task_manager", "resource_manager", "deviceflow",
                     "performance_manager", "cluster_manager"):
            assert getattr(sess, name) is not None, name
        with grpc.insecure_channel(f"127.0.0.1:{sess.port}") as ch:
            assert ResourceMgrClient(ch).get_resource()["logical_simulation"]["cpu"] > 0
    finally:
        sess.stop()
    assert sess._server is None


def test_session_metrics_endpoint():
    sess = SimulatorSession(services=("resourcemgr",), metrics_port=0, device="cpu")
    sess.start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{sess.metrics_server.port}/metrics", timeout=10).read().decode()
        assert "# TYPE" in body or body == ""
    finally:
        sess.stop()
    assert sess.metrics_server is None


def test_cluster_resource_query_rpcs(session, channel):
    rmc = ResourceMgrClient(channel)
    assert rmc.get_cluster_total_resource() == {"cpu": 8.0, "mem": 8.0}
    assert rmc.get_cluster_available_resource() == {"cpu": 8.0, "mem": 8.0}
    assert rmc.get_cluster_resource_detail() == []
    assert rmc.request_cluster_resource("trq", "user1", 3.0, 2.0)
    assert rmc.get_cluster_available_resource() == {"cpu": 5.0, "mem": 6.0}
    assert rmc.get_cluster_total_resource() == {"cpu": 8.0, "mem": 8.0}
    assert [d["task_id"] for d in rmc.get_cluster_resource_detail()] == ["trq"]
    assert rmc.release_cluster_resource("trq")
    assert rmc.get_cluster_available_resource() == {"cpu": 8.0, "mem": 8.0}
    assert rmc.get_cluster_resource_detail() == []


# ----------------------------------------------------- tests/test_taskmgr.py
def test_task_manager_end_to_end_grpc_rows_equal_jax():
    """submit over gRPC -> scheduled -> the engine runs -> SUCCEEDED, the
    resources released; the port's manager behind ``serve_taskmgr`` against
    JAX's, and their task rows equal (``UNCOMPARED`` left out)."""
    def run(side):
        if side == "jax":
            from olearning_sim_tpu.resourcemgr import ResourceManager
            from olearning_sim_tpu.taskmgr.codecs import json2taskconfig as j2t
            from olearning_sim_tpu.taskmgr.grpc_service import TaskMgrClient as Client
            from olearning_sim_tpu.taskmgr.grpc_service import serve_taskmgr
            from olearning_sim_tpu.taskmgr.task_manager import TaskManager
            from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo
            extra, tc = {}, j2t(make_task_json("grpc_task"))
        else:
            from olearning_sim_tpu_torch.resourcemgr import ResourceManager
            from olearning_sim_tpu_torch.taskmgr.grpc_service import TaskMgrClient as Client
            from olearning_sim_tpu_torch.taskmgr.grpc_service import serve_taskmgr
            from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager
            from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo
            extra, tc = {"device": "cpu"}, wire_tc(make_task_json("grpc_task"))
        rm = ResourceManager(topology=_topology(side))
        repo = TaskTableRepo()
        mgr = TaskManager(task_repo=repo, resource_manager=rm, schedule_interval=0.05,
                          release_interval=0.05, interrupt_interval=3600, **extra)
        mgr.start()
        server, port = serve_taskmgr(mgr, "127.0.0.1:0")
        try:
            with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
                client = Client(ch)
                out = [client.submitTask(tc).is_success, client.submitTask(tc).is_success]
                assert wait_for(lambda: client.getTaskStatus("grpc_task").taskStatus
                                == int(TaskStatus.SUCCEEDED), timeout=120)
                assert wait_for(lambda: rm.get_resource()["logical_simulation"]["cpu"] == 8.0)
                out.append(client.getTaskStatus("ghost").taskStatus)
        finally:
            server.stop(0)
            mgr.stop()
        return out, rows(repo)

    want, want_rows = run("jax")
    got, got_rows = run("port")
    assert got == want == [True, False, int(TaskStatus.MISSING)]
    assert got_rows == want_rows
    assert got_rows["grpc_task"]["task_status"] == "SUCCEEDED"


# ----------------------------------------------------- tests/test_outbound.py
def test_grpc_producer_round_trip():
    from olearning_sim_tpu_torch.deviceflow.outbound import GrpcOutboundProducer

    sink = GrpcSink()
    try:
        prod = GrpcOutboundProducer(sink.target, flow_id="t1_op_0")
        prod([{"a": 1}, {"b": 2}])
        prod([{"c": 3}])
        prod.close()
        assert len(sink.batches) == 2
        assert sink.batches[0][0] == "t1_op_0"
        assert [json.loads(m) for m in sink.batches[0][1]] == [{"a": 1}, {"b": 2}]
    finally:
        sink.close()


def test_deviceflow_streams_to_grpc_sink_equals_jax():
    """A real-time flow (batches of 4, a drop probability, one seed) into a
    gRPC ``OutboundSink``: the port's service delivers JAX's batches."""
    from olearning_sim_tpu.deviceflow import DeviceFlowService as JaxService

    from olearning_sim_tpu_torch.deviceflow import DeviceFlowService

    def run(service_cls):
        sink = GrpcSink()
        svc = service_cls(poll_interval=0.005)
        svc.start()
        try:
            assert svc.register_task("t2", ["logical_simulation"])
            strategy = json.dumps({"real_time_dispatch": {
                "use_strategy": True, "dispatch_batch_sizes": [4],
                "drop_simulation": {"drop_probability": 0.2}}})
            ok, msg = svc.notify_start("t2", "t2_op_0", "logical_simulation", strategy,
                                       outbound_service={"type": "grpc",
                                                         "target": sink.target})
            assert ok, msg
            for i in range(30):
                svc.publish("t2_op_0", "logical_simulation", {"u": i})
            assert svc.notify_complete("t2", "t2_op_0", "logical_simulation")[0]
            assert wait_for(lambda: svc.check_dispatch_finished("t2"), 30)
            assert "t2_op_0" not in svc.delivered
            return [(fid, [json.loads(m) for m in msgs]) for fid, msgs in sink.batches]
        finally:
            svc.stop()
            sink.close()

    want, got = run(JaxService), run(DeviceFlowService)
    assert got == want
    kept = [m["u"] for _, b in got for m in b]
    assert 0 < len(kept) < 30 and kept == sorted(kept)


# ------------------------------------------------------- tests/test_config.py
def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_main_entry_point_serves_grpc(tmp_path):
    """``python -m olearning_sim_tpu_torch --config x.ini --print-port
    --device cpu`` prints its port; a JAX ``TaskMgrClient`` drives a task
    through it to SUCCEEDED; SIGTERM ends it with exit 0."""
    from google.protobuf import empty_pb2

    from olearning_sim_tpu.proto import taskservice_pb2 as jpb
    from olearning_sim_tpu.taskmgr.codecs import json2taskconfig as j2t
    from olearning_sim_tpu.taskmgr.grpc_service import TaskMgrClient as JaxClient

    p = tmp_path / "platform.ini"
    p.write_text("[session]\nservices = taskmgr, resourcemgr, deviceflow\n"
                 "address = 127.0.0.1:0\n\n[taskmgr]\nscheduler_sleep_time = 0.05\n"
                 "release_sleep_time = 0.05\n")
    err_path = tmp_path / "stderr.log"
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "olearning_sim_tpu_torch", "--config",
                                 str(p), "--print-port", "--device", "cpu"],
                                stdout=subprocess.PIPE, stderr=err, text=True, cwd=REPO,
                                env=_env())
        try:
            port = int(proc.stdout.readline().strip())
            with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
                get_queue = ch.unary_unary(
                    "/TaskMgr/getTaskQueue",
                    request_serializer=empty_pb2.Empty.SerializeToString,
                    response_deserializer=jpb.TaskQueue.FromString)
                assert len(get_queue(empty_pb2.Empty(), timeout=10).tasks) == 0
                client = JaxClient(ch)
                task = make_task_json("main_task", cpus=1, request_units=1)
                assert client.submitTask(j2t(task)).is_success
                assert wait_for(lambda: client.getTaskStatus("main_task").taskStatus
                                == int(TaskStatus.SUCCEEDED), timeout=120)
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                raise
    assert rc == 0, err_path.read_text()
    assert f"platform serving on port {port} on cpu" in err_path.read_text()


def test_print_port_is_refused_in_process(tmp_path):
    """A config whose address is ``none`` runs in process: ``--print-port``
    has no port to print and exits 2 saying so."""
    p = tmp_path / "platform.ini"
    p.write_text("[session]\nservices = performancemgr\naddress = none\n")
    proc = subprocess.run([sys.executable, "-m", "olearning_sim_tpu_torch", "--config", str(p),
                           "--print-port", "--device", "cpu"], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and "serves no port" in proc.stderr
    assert proc.stdout == ""


# ----------------------------------------- tests/test_multiprocess_session.py
@pytest.fixture
def deviceflow_proc():
    """A separate OS process hosting only the port's deviceflow service."""
    code = ("from olearning_sim_tpu_torch.services import SimulatorSession\n"
            "import threading\n"
            "s = SimulatorSession(services=('deviceflow',), device='cpu').start()\n"
            "print('PORT', s.port, flush=True)\n"
            "threading.Event().wait()\n")
    proc = subprocess.Popen([sys.executable, "-c", code], env=_env(), cwd=REPO,
                            stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline().strip()
    assert line.startswith("PORT "), line
    channel = grpc.insecure_channel(f"127.0.0.1:{line.split()[1]}")
    try:
        yield DeviceFlowClient(channel)
    finally:
        channel.close()
        proc.terminate()
        proc.wait(timeout=10)


def test_flow_lifecycle_over_the_wire(deviceflow_proc):
    """Register -> NotifyStart -> PublishInbound x7 -> NotifyComplete ->
    the dispatch lands on this process's OutboundSink ->
    CheckDispatchFinished, all across processes."""
    df = deviceflow_proc
    sink = GrpcSink()
    try:
        assert df.register_task("mp1", ["logical_simulation"])
        strategy = json.dumps({"real_time_dispatch": {"use_strategy": True,
                                                      "dispatch_batch_sizes": [3]}})
        ok, msg = df.notify_start("mp1", "mp1_train_0", "logical_simulation", strategy,
                                  outbound_service={"type": "grpc", "target": sink.target})
        assert ok, msg
        for i in range(7):
            df.publish("mp1_train_0", "logical_simulation", {"uid": i})
        ok, msg = df.notify_complete("mp1", "mp1_train_0", "logical_simulation")
        assert ok, msg
        assert wait_for(lambda: df.check_dispatch_finished("mp1"), timeout=30)
        got = sorted(json.loads(m)["uid"] for _, b in sink.batches for m in b)
        assert got == list(range(7))
        assert sorted(len(b) for _, b in sink.batches) == [1, 3, 3]
        assert df.unregister_task("mp1")
    finally:
        sink.close()


def test_task_manager_drives_remote_deviceflow(deviceflow_proc):
    """A whole task against a deviceflow in another process: the runner's
    NotifyStart/NotifyComplete barriers and publishes, and the manager's
    register and dispatch-finished gate, all cross the wire; the task is
    SUCCEEDED and released after the remote dispatch finishes."""
    from olearning_sim_tpu_torch.resourcemgr import ResourceManager
    from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo

    df = deviceflow_proc
    js = make_task_json("mp_task", rounds=2)
    js["operatorflow"]["operators"][0]["operation_behavior_controller"] = {
        "use_gradient_house": True,
        "strategy_gradient_house": json.dumps({"real_time_dispatch": {
            "use_strategy": True, "dispatch_batch_sizes": [4]}}),
        "outbound_service": "",
    }
    repo = TaskTableRepo()
    mgr = TaskManager(task_repo=repo, resource_manager=ResourceManager(topology=_topology()),
                      deviceflow=df, schedule_interval=0.05, release_interval=0.05,
                      interrupt_interval=3600, device="cpu")
    mgr.start()
    try:
        assert mgr.submit_task(json2taskconfig(js))
        assert wait_for(lambda: mgr.get_task_status("mp_task") == TaskStatus.SUCCEEDED,
                        timeout=120), mgr.get_task_status("mp_task")
        assert wait_for(lambda: str(repo.get_item_value("mp_task", "resource_occupied"))
                        == "0", timeout=30)
        assert df.check_dispatch_finished("mp_task")
        assert int(repo.get_item_value("mp_task", "logical_round")) == 2
    finally:
        mgr.stop()
