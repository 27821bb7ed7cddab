"""The port's gRPC wire against the JAX package's, in one process: the
``TaskConfig`` converter byte for byte over the 13 configs, every RPC of
TaskMgr, ResourceMgr, DeviceFlow, PhoneManager, SliceMgr, PerformanceMgr
and OutboundSink both ways (a JAX client against a port server and a port
client against a JAX server, each against JAX against JAX: the same request
and response bytes, the same client return values, the same manager state
after), and submission over the wire (``is_success`` for the 13 configs
and the 42 validation cases of ``tests/test_torch_taskmgr.py``).

Fields that are the port's own are compared as parsed values, apart from
the bytes: ``ResourceSnapshot.topology_json`` (the port's ``DeviceTopology``
against JAX's ``TpuTopology``), the timings inside
``PerformanceReport.json_data``, and ``MetricsSnapshot.body`` (the rendered
registry, each package's own series)."""

import copy
import json
import pathlib
import time

import grpc
import pytest
import torch

import torch_threads  # noqa: F401
from test_outbound import GrpcSink
from test_taskmgr import make_task_json
from test_torch_taskmgr import MUTATIONS, UNCOMPARED, rows

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.stem for p in (REPO / "configs").glob("*.json"))
SERVICES = ("TaskMgr", "ResourceMgr", "DeviceFlow", "PhoneManager", "SliceMgr",
            "PerformanceMgr")
INVENTORY = {"user1": {"high": 20, "low": 4}}
RT_STRATEGY = json.dumps({"real_time_dispatch": {"use_strategy": True,
                                                 "dispatch_batch_sizes": [5]}})


def load(name):
    return json.loads((REPO / "configs" / f"{name}.json").read_text())


def wait_for(cond, timeout=30.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.01)
    return False


# --------------------------------------------------------------------- codec
@pytest.mark.parametrize("name", CONFIGS)
def test_taskconfig_codec_is_byte_equal_to_jax(name):
    from olearning_sim_tpu.taskmgr.codecs import json2taskconfig as jax_json2taskconfig

    from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig
    from olearning_sim_tpu_torch.taskmgr.proto_codec import (
        taskconfig_from_proto,
        taskconfig_to_proto,
    )

    js = load(name)
    want = jax_json2taskconfig(json.dumps(js))
    got = taskconfig_to_proto(json2taskconfig(js))
    assert got.SerializeToString(deterministic=True) == want.SerializeToString(deterministic=True)
    assert taskconfig_from_proto(want) == json2taskconfig(js)
    assert taskconfig_from_proto(got) == json2taskconfig(js)


def test_taskconfig_codec_zero_values_and_enums():
    """Absent JSON keys against explicit zeros, empty lists, an empty
    ``input`` string and every transfer type: the same bytes as JAX's."""
    from olearning_sim_tpu.taskmgr.codecs import json2taskconfig as jax_json2taskconfig

    from olearning_sim_tpu_torch.proto import taskservice_pb2 as pb
    from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig
    from olearning_sim_tpu_torch.taskmgr.proto_codec import (
        taskconfig_from_proto,
        taskconfig_to_proto,
    )

    cases = [{}, {"task_id": "x", "target": {"data": [{}]},
                  "operatorflow": {"operators": [{"input": ""}]},
                  "logical_simulation": {"computation_unit": {"setting": [{}]},
                                         "resource_request": [{}]}}]
    for kind in ("FILE", "HTTP", "S3", "MINIO"):
        js = make_task_json(f"t_{kind}")
        js["target"]["data"][0]["data_transfer_type"] = kind
        op = js["operatorflow"]["operators"][0]
        op["model"]["model_transfer_type"] = kind
        op["logical_simulation"]["operator_transfer_type"] = kind
        js["target"]["data"][0]["allocation"]["device_simulation"] = [0, 0]
        cases.append(js)
    for js in cases:
        want = jax_json2taskconfig(json.dumps(js)).SerializeToString(deterministic=True)
        msg = taskconfig_to_proto(json2taskconfig(js))
        assert msg.SerializeToString(deterministic=True) == want
        assert taskconfig_from_proto(pb.TaskConfig.FromString(want)) == json2taskconfig(js)
    bad = pb.TaskConfig()
    bad.target.targetData.add().dataTransferType = 9
    with pytest.raises(ValueError, match="FileTransferType 9"):
        taskconfig_from_proto(bad)


# ------------------------------------------------------------------ platforms
class Platform:
    """One package's managers behind its own ``SimulatorSession``, served
    on an ephemeral port, in the same state on either side."""

    def __init__(self, side, trace_dir):
        self.side = side
        if side == "jax":
            from olearning_sim_tpu.clustermgr import ClusterManager
            from olearning_sim_tpu.deviceflow import DeviceFlowService
            from olearning_sim_tpu.performancemgr import PerformanceManager
            from olearning_sim_tpu.phonemgr import SimulatedPhoneFarm
            from olearning_sim_tpu.resourcemgr import ResourceManager
            from olearning_sim_tpu.resourcemgr import TpuTopology as Topology
            from olearning_sim_tpu.services import SimulatorSession
            from olearning_sim_tpu.taskmgr.task_manager import TaskManager
            from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo
            cluster, extra = ClusterManager(), {}
        else:
            from olearning_sim_tpu_torch.clustermgr import ClusterManager
            from olearning_sim_tpu_torch.deviceflow import DeviceFlowService
            from olearning_sim_tpu_torch.performancemgr import PerformanceManager
            from olearning_sim_tpu_torch.phonemgr import SimulatedPhoneFarm
            from olearning_sim_tpu_torch.resourcemgr import DeviceTopology as Topology
            from olearning_sim_tpu_torch.resourcemgr import ResourceManager
            from olearning_sim_tpu_torch.services import SimulatorSession
            from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager
            from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo
            cluster = ClusterManager(devices=[torch.device("cpu")] * 8)
            extra = {"device": "cpu"}
        self.trace_dir = trace_dir
        self.farm = SimulatedPhoneFarm(inventory=INVENTORY, speedup=1000.0, seed=0)
        topo = Topology(num_chips=1, num_cores=8, platform="cpu", device_kinds=["cpu"],
                        cpu=8.0, mem=8.0)
        self.rm = ResourceManager(topology=topo,
                                  phone_provider=self.farm.get_device_available_resource)
        self.df = DeviceFlowService(poll_interval=0.005)
        self.cluster = cluster
        self.perf = PerformanceManager()
        self.repo = TaskTableRepo()
        self.tm = TaskManager(task_repo=self.repo, resource_manager=self.rm,
                              deviceflow=self.df, phone_client=self.farm, perf=self.perf,
                              schedule_interval=3600, release_interval=3600,
                              interrupt_interval=3600, **extra)
        self.session = SimulatorSession(
            address="127.0.0.1:0", task_manager=self.tm, resource_manager=self.rm,
            deviceflow=self.df, phone_farm=self.farm, cluster_manager=cluster,
            performance_manager=self.perf, supervise=False, **extra)
        self.session.start()
        self.channel = grpc.insecure_channel(f"127.0.0.1:{self.session.port}")

    def close(self):
        self.channel.close()
        self.session.stop()

    def state(self, service):
        """The manager state a service's script leaves behind."""
        if service == "TaskMgr":
            return rows(self.repo)
        if service == "ResourceMgr":
            res = self.rm.get_resource()
            res.pop("topology")
            return res, self.rm.get_cluster_resource_detail()
        if service == "DeviceFlow":
            return (copy.deepcopy(self.df.delivered), self.df.registry.get("ft"),
                    self.df.check_dispatch_finished("ft"))
        if service == "PhoneManager":
            return (self.farm.get_device_available_resource(),
                    self.farm.get_device_task_status("pt"))
        if service == "SliceMgr":
            return {n: self.cluster.query_slice(n) for n in self.cluster.list_slices()}
        return self.perf.list_tasks(), self.perf._trace_dir


class Recording:
    """A channel whose unary calls also log (path, request bytes, response
    bytes): the clients of either package run over it unchanged."""

    def __init__(self, channel):
        self.channel = channel
        self.log = []

    def unary_unary(self, path, request_serializer=None, response_deserializer=None, **kw):
        raw = self.channel.unary_unary(path, request_serializer=request_serializer,
                                       response_deserializer=None, **kw)

        def call(request, timeout=None, **k):
            body = raw(request, timeout=timeout, **k)
            self.log.append((path, request_serializer(request), body))
            return response_deserializer(body)

        return call


def clients(side):
    """One package's client classes and wire messages."""
    if side == "jax":
        from olearning_sim_tpu.proto import services_pb2 as spb
        from olearning_sim_tpu.services import grpc_services as g
        from olearning_sim_tpu.taskmgr import grpc_service as t
        from olearning_sim_tpu.taskmgr.codecs import json2taskconfig

        def wire_tc(js):
            return json2taskconfig(json.dumps(js))
    else:
        from olearning_sim_tpu_torch.proto import services_pb2 as spb
        from olearning_sim_tpu_torch.services import grpc_services as g
        from olearning_sim_tpu_torch.taskmgr import grpc_service as t
        from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig
        from olearning_sim_tpu_torch.taskmgr.proto_codec import taskconfig_to_proto

        def wire_tc(js):
            return taskconfig_to_proto(json2taskconfig(js))
    return {"TaskMgr": t.TaskMgrClient, "ResourceMgr": g.ResourceMgrClient,
            "DeviceFlow": g.DeviceFlowClient, "PhoneManager": g.PhoneManagerClient,
            "SliceMgr": g.SliceMgrClient, "PerformanceMgr": g.PerformanceMgrClient,
            "spb": spb, "wire_tc": wire_tc}


# Each script drives one service through client ``c`` (recorded); ``u`` is
# an unrecorded client of the same kind for waits whose poll count varies.
def script_taskmgr(c, u, k, p):
    js = make_task_json("g1")
    return [c.submitTask(k["wire_tc"](js)).is_success,
            c.submitTask(k["wire_tc"](js)).is_success,
            c.submitTask(k["wire_tc"](make_task_json("g2", rounds=0))).is_success,
            c.getTaskStatus("g1").taskStatus, c.getTaskStatus("ghost").taskStatus,
            [t.taskID for t in c.getTaskQueue().tasks],
            c.changeScheduler("fifo").is_success, c.changeScheduler("bogus").is_success,
            c.stopTask("g1").is_success, c.stopTask("ghost").is_success,
            c.getTaskStatus("g1").taskStatus, [t.taskID for t in c.getTaskQueue().tasks]]


def script_resourcemgr(c, u, k, p):
    out = [c.get_resource(), c.get_cluster_total_resource(),
           c.get_cluster_available_resource(), c.get_cluster_resource_detail(),
           c.request_cluster_resource("trq", "user1", 3.0, 2.0),
           c.request_cluster_resource("big", "user1", 30.0, 2.0),
           c.get_cluster_available_resource(),
           [d["task_id"] for d in c.get_cluster_resource_detail()],
           c.request_phone_resource("tp", "user1", {"high": 2}),
           c.request_phone_resource("tp2", "user1", {"high": 99}),
           c.get_resource()["device_simulation"],
           c.release_resource("tp"), c.release_cluster_resource("trq"),
           c.release_cluster_resource("trq"), c.get_cluster_available_resource()]
    out[0].pop("topology")  # the port's own: held by the bytes' comparison
    return out


def script_deviceflow(c, u, k, p):
    out = [c.register_task("ft", ["logical_simulation"]),
           c._calls["GetTotalComputeResources"](k["spb"].TaskRef(task_id="ft"))
           .total_compute_resources[:],
           c.notify_start("ft", "ft_train_0", "logical_simulation", RT_STRATEGY),
           c.notify_start("ghost", "ghost_train_0", "logical_simulation", RT_STRATEGY)]
    for i in range(12):
        c.publish("ft_train_0", "logical_simulation", {"update": i})
    ack = c._calls["PublishInbound"](k["spb"].InboundMessage(
        routing_key="ft_train_0", compute_resource="logical_simulation", payload="{x"))
    bad = c._calls["NotifyStart"](k["spb"].FlowNotifyRequest(
        task_id="ft", routing_key="ft_train_1", compute_resource="logical_simulation",
        strategy=RT_STRATEGY, outbound_service="not json"))
    out += [(ack.is_success, ack.message), (bad.is_success, bad.message),
            c.notify_complete("ft", "ft_train_0", "logical_simulation")]
    assert wait_for(lambda: u.check_dispatch_finished("ft"))
    out += [c.check_dispatch_finished("ft"), c.get_outbound_endpoint(),
            c.unregister_task("ft"), c.unregister_task("ft")]
    return out


def script_phonemanager(c, u, k, p):
    data = [{"name": "d", "devices": ["high", "low"], "nums": [2, 1]}]
    out = [c.get_device_available_resource(),
           c.request_device_resource("frz", "user1", {"high": 3}),
           c.get_device_available_resource(), c.release_device_resource("frz"),
           c.release_device_resource("frz"),
           c.submit_task("pt", rounds=2, operators=["train"], data=data),
           c.submit_task("pt", rounds=2, operators=["train"], data=data)]
    assert wait_for(lambda: u.get_device_task_status("pt")["is_finished"])
    out += [c.get_device_task_status("pt"), c.get_device_task_status("ghost"),
            c.stop_device("pt"), c.stop_device("ghost")]
    return out


def script_slicemgr(c, u, k, p):
    return [c.create_slice("s1", 4, user_id="user1"), c.query_slice("s1"),
            c.create_slice("s1", 2), c.create_slice("s2", 99), c.modify_slice("s1", 2),
            c.modify_slice("ghost", 2), c.query_slice("s1"), c.create_slice("s3", 1),
            c.delete_slice("s1"), c.delete_slice("s1"), c.query_slice("s1")]


def script_performancemgr(c, u, k, p):
    out = [c.get_performance("none")]
    fmt = [c.get_metrics()[0], c.get_metrics("json")[0]]
    return out + fmt + [c.start_trace(p.trace_dir), c.start_trace(p.trace_dir),
                        c.stop_trace(), c.stop_trace()]


SCRIPTS = {"TaskMgr": script_taskmgr, "ResourceMgr": script_resourcemgr,
           "DeviceFlow": script_deviceflow, "PhoneManager": script_phonemanager,
           "SliceMgr": script_slicemgr, "PerformanceMgr": script_performancemgr}


def own_fields_cleared(path, body):
    """A response with the port's own fields cleared, and those fields
    parsed (``None`` where the response has none)."""
    from olearning_sim_tpu.proto import services_pb2 as spb
    from olearning_sim_tpu.proto import telemetry_pb2 as tpb

    if path.endswith("ResourceMgr/getResource"):
        msg = spb.ResourceSnapshot.FromString(body)
        own, msg.topology_json = json.loads(msg.topology_json), ""
    elif path.endswith("PerformanceMgr/getMetrics"):
        msg = tpb.MetricsSnapshot.FromString(body)
        own, msg.body = msg.body, ""
    else:
        return body, None
    return msg.SerializeToString(deterministic=True), own


def methods_of(service):
    """The port's method names of a service (every one must be called)."""
    from olearning_sim_tpu_torch.services import grpc_services
    from olearning_sim_tpu_torch.taskmgr import grpc_service

    if service == "TaskMgr":
        return grpc_service._METHODS
    return getattr(grpc_services, f"{service}Servicer").METHODS


def drive(service, client_side, server_side, trace_dir):
    platform = Platform(server_side, str(trace_dir / "trace"))
    try:
        k = clients(client_side)
        rec = Recording(platform.channel)
        c, u = k[service](rec), k[service](platform.channel)
        result = SCRIPTS[service](c, u, k, platform)
        return result, rec.log, platform.state(service)
    finally:
        platform.close()


@pytest.fixture
def jax_profiler_off(monkeypatch):
    """JAX's profiler session replaced by a recording no-op: it and the
    port's ``torch.profiler`` session do not share a process safely, and
    the wire, not JAX's profiler, is under test here."""
    import jax

    calls = []
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d, *a, **k: calls.append(d))
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: calls.append(None))
    return calls


@pytest.mark.parametrize("service", SERVICES)
@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server"])
def test_every_rpc_equals_jax_both_ways(service, direction, tmp_path, jax_profiler_off):
    client_side, server_side = ("jax", "port") if direction.startswith("jax") else \
        ("port", "jax")
    want, want_log, want_state = drive(service, "jax", "jax", tmp_path)
    got, got_log, got_state = drive(service, client_side, server_side, tmp_path)
    assert [path for path, _, _ in got_log] == [path for path, _, _ in want_log]
    assert {path.rsplit("/", 1)[1] for path, _, _ in got_log} == set(methods_of(service))
    for (path, g_req, g_resp), (_, w_req, w_resp) in zip(got_log, want_log):
        assert g_req == w_req, path
        g_rest, g_own = own_fields_cleared(path, g_resp)
        w_rest, w_own = own_fields_cleared(path, w_resp)
        assert g_rest == w_rest, path
        if path.endswith("getResource"):
            # The port's DeviceTopology against JAX's TpuTopology: the same
            # counts and platform.
            assert {k: g_own[k] for k in w_own} == w_own
    assert got == want
    assert got_state == want_state


@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server"])
def test_performance_report_and_metrics_equal_jax_as_parsed_values(direction):
    """``getPerformance`` of a task with rounds, and ``getMetrics`` in both
    formats: the report's keys and counts equal JAX's, its timings each
    package's own; the metrics bodies each package's registry, parsed."""
    from olearning_sim_tpu.performancemgr.performance_manager import (
        RoundTiming as JaxRoundTiming,
    )

    from olearning_sim_tpu_torch.performancemgr.performance_manager import RoundTiming

    def run(client_side, server_side):
        p = Platform(server_side, "")
        try:
            timing = JaxRoundTiming if server_side == "jax" else RoundTiming
            for r in range(3):
                p.perf.record_round(timing(task_id="pt1", round_idx=r, operator="train",
                                           duration_s=0.5 + r, num_clients=8,
                                           local_steps=2))
            c = clients(client_side)["PerformanceMgr"](p.channel)
            prom = c.get_metrics()
            js = c.get_metrics("json")
            return c.get_performance("pt1"), prom, (js[0], json.loads(js[1]))
        finally:
            p.close()

    client_side, server_side = ("jax", "port") if direction.startswith("jax") else \
        ("port", "jax")
    want, want_prom, want_json = run("jax", "jax")
    got, got_prom, got_json = run(client_side, server_side)
    assert got == want
    assert got["rounds_recorded"] == 3
    assert got_prom[0] == want_prom[0] and got_json[0] == want_json[0]
    assert "# TYPE" in got_prom[1] and isinstance(got_json[1], dict)


def test_outbound_sink_both_ways():
    """``OutboundSink/PublishBatch``: each package's ``GrpcOutboundProducer``
    against each package's sink, and the raw call's bytes alike."""
    from olearning_sim_tpu.deviceflow.outbound import GrpcOutboundProducer as JaxProducer
    from olearning_sim_tpu.proto import services_pb2 as jspb

    from olearning_sim_tpu_torch.deviceflow.outbound import GrpcOutboundProducer
    from olearning_sim_tpu_torch.proto import services_pb2 as tspb
    from olearning_sim_tpu_torch.services.grpc_services import (
        OutboundSinkClient,
        OutboundSinkServicer,
        add_service_to_server,
    )

    class PortSink:
        def __init__(self):
            from concurrent import futures

            self.servicer = OutboundSinkServicer()
            self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
            add_service_to_server(self.servicer, self._server)
            self.port = self._server.add_insecure_port("127.0.0.1:0")
            self._server.start()
            self.batches = self.servicer.batches
            self.target = f"127.0.0.1:{self.port}"

        def close(self):
            self._server.stop(None)

    out = {}
    for producer_cls in (JaxProducer, GrpcOutboundProducer):
        for sink_cls in (GrpcSink, PortSink):
            sink = sink_cls()
            try:
                prod = producer_cls(sink.target, flow_id="t1_op_0")
                prod([{"a": 1}, {"b": 2}])
                prod([{"c": 3}, "raw"])
                prod.close()
                raws = []
                with grpc.insecure_channel(sink.target) as ch:
                    for spb in (jspb, tspb):
                        call = ch.unary_unary(
                            "/olearning_sim_tpu.services.OutboundSink/PublishBatch",
                            request_serializer=lambda m: m.SerializeToString(),
                            response_deserializer=None)
                        raws.append(call(spb.OutboundBatch(flow_id="f", messages=["x"])))
                    ok = OutboundSinkClient(ch).publish_batch("g", ["y", "z"])
                out[producer_cls.__module__.split(".")[0], sink_cls.__name__] = (
                    list(map(tuple, sink.batches)), raws, ok)
            finally:
                sink.close()
    want = out["olearning_sim_tpu", "GrpcSink"]
    assert all(v == want for v in out.values()), out
    assert want[0][0] == ("t1_op_0", ['{"a": 1}', '{"b": 2}'])
    assert want[0][-1] == ("g", ["y", "z"]) and want[2] == (True, "")


# ----------------------------------------------------------------- submission
@pytest.fixture(scope="module")
def submit_servers():
    """A JAX and a port platform, each answering ``submitTask`` only (the
    managers never schedule)."""
    platforms = {side: Platform(side.rstrip("2"), "") for side in ("jax", "port", "port2")}
    yield platforms
    for p in platforms.values():
        p.close()


def submit_both(servers, js):
    """``submitTask`` of ``js``: JAX client to JAX server, JAX client to a
    port server, port client to another port server."""
    out = []
    for client_side, server_side in (("jax", "jax"), ("jax", "port"), ("port", "port2")):
        k = clients(client_side)
        tc = k["wire_tc"](copy.deepcopy(js))
        out.append(k["TaskMgr"](servers[server_side].channel).submitTask(tc).is_success)
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_submit_configs_over_the_wire_equals_jax(submit_servers, name):
    got = submit_both(submit_servers, load(name))
    assert got == [True, True, True]


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_submit_validation_cases_over_the_wire_equals_jax(submit_servers, case):
    js = make_task_json(f"v_{case}")
    MUTATIONS[case](js)
    got = submit_both(submit_servers, js)
    assert got[1] == got[0] and got[2] == got[0]
    assert got[0] == case.startswith(("valid", "clip_only"))


def test_submitted_rows_equal_jax():
    """Every config and validation case submitted over the wire to fresh
    servers leaves the same rows on each port server as on the JAX server
    (``UNCOMPARED`` left out)."""
    servers = {side: Platform(side.rstrip("2"), "") for side in ("jax", "port", "port2")}
    try:
        for name in CONFIGS:
            submit_both(servers, load(name))
        for case in sorted(MUTATIONS):
            js = make_task_json(f"v_{case}")
            MUTATIONS[case](js)
            submit_both(servers, js)
        want = rows(servers["jax"].repo)
        got = [rows(servers["port"].repo), rows(servers["port2"].repo)]
    finally:
        for p in servers.values():
            p.close()
    assert len(want) == len(CONFIGS) + sum(
        case.startswith(("valid", "clip_only")) for case in MUTATIONS)
    assert got == [want, want]
    assert set(UNCOMPARED) >= {"in_queue_time", "submit_task_time"}


# -------------------------------------------------- without grpcio/protobuf
def test_without_grpc_the_port_runs_in_process_and_refuses_the_wire(tmp_path):
    """With ``grpc`` and ``google.protobuf`` unimportable, every non-wire
    module imports and an ``address=None`` session runs a task; asking to
    serve (the session, the entry point's ``--print-port``) or to send (a
    ``grpc`` outbound flow) fails with an error naming grpcio."""
    import subprocess
    import sys

    task = json.dumps(make_task_json("inproc", cpus=1, request_units=1))
    code = f"""
import sys
sys.modules["grpc"] = None
sys.modules["google.protobuf"] = None
import importlib, json, pkgutil, time
import olearning_sim_tpu_torch as port
wire = {{"olearning_sim_tpu_torch.proto.taskservice_pb2",
        "olearning_sim_tpu_torch.proto.services_pb2",
        "olearning_sim_tpu_torch.taskmgr.proto_codec",
        "olearning_sim_tpu_torch.taskmgr.grpc_service",
        "olearning_sim_tpu_torch.services.grpc_services"}}
names = [m.name for m in pkgutil.walk_packages(port.__path__, "olearning_sim_tpu_torch.")]
for name in names:
    if name in wire:
        try:
            importlib.import_module(name)
        except ImportError:
            continue
        raise SystemExit("wire module imported: " + name)
    importlib.import_module(name)
print("imported", len(names) - len(wire))
from olearning_sim_tpu_torch.services import SimulatorSession
from olearning_sim_tpu_torch.taskmgr.status import TaskStatus
try:
    SimulatorSession(services=("taskmgr",), address="127.0.0.1:0", device="cpu").start()
    raise SystemExit("served")
except ImportError as e:
    assert "grpcio" in str(e), e
    print("session refused:", e)
from olearning_sim_tpu_torch.deviceflow import DeviceFlowService
from olearning_sim_tpu_torch.deviceflow.outbound import make_outbound_factory
try:
    make_outbound_factory()("f", {{"type": "grpc", "target": "127.0.0.1:1"}})
    raise SystemExit("sent")
except ImportError as e:
    assert "grpcio" in str(e), e
    print("outbound refused:", e)
svc = DeviceFlowService(poll_interval=0.005, outbound_factory=make_outbound_factory())
svc.start()
svc.register_task("g", ["logical_simulation"])
assert svc.notify_start("g", "g_op_0", "logical_simulation", {RT_STRATEGY!r},
                        outbound_service={{"type": "grpc", "target": "127.0.0.1:1"}})[0]
svc.publish("g_op_0", "logical_simulation", {{"u": 1}})
svc.notify_complete("g", "g_op_0", "logical_simulation")
end = time.monotonic() + 30
while "g_op_0" not in svc._dispatch_failed and time.monotonic() < end:
    time.sleep(0.01)
assert "g_op_0" in svc._dispatch_failed and not svc.check_dispatch_finished("g")
assert "g_op_0" not in svc.delivered
svc.stop()
print("flow failed")
session = SimulatorSession(services=("taskmgr", "resourcemgr"), address=None, device="cpu")
session.task_manager._schedule_interval = 0.05
session.task_manager._release_interval = 0.05
with session:
    assert session.port is None
    assert session.task_manager.submit_task({task!r})
    end = time.monotonic() + 60
    while session.task_manager.get_task_status("inproc") != TaskStatus.SUCCEEDED:
        assert time.monotonic() < end, session.task_manager.get_task_status("inproc")
        time.sleep(0.05)
print("in process: SUCCEEDED")
"""
    env = dict(__import__("os").environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "in process: SUCCEEDED" in proc.stdout
    ini = tmp_path / "platform.ini"
    ini.write_text("[session]\nservices = performancemgr\n")
    main = ("import sys, runpy\nsys.modules['grpc'] = None\n"
            "sys.modules['google.protobuf'] = None\n"
            "sys.argv = ['olearning_sim_tpu_torch', '--config', sys.argv[1], '--print-port',"
            " '--device', 'cpu']\nrunpy.run_module('olearning_sim_tpu_torch',"
            " run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", main, str(ini)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "grpcio" in proc.stderr, proc.stderr
    assert proc.stdout == ""
