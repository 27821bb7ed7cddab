"""gRPC servicers + clients for ResourceMgr / DeviceFlow / PhoneManager /
SliceMgr / PerformanceMgr / OutboundSink.

Same generic-handler pattern as ``taskmgr/grpc_service.py`` (protoc's Python
output without grpc_python_plugin). Each servicer is a thin adapter from the
wire surface (``proto/services.proto``, mirroring the reference's service
inventory) onto the corresponding in-process manager.

The JAX package's ``services/grpc_services.py`` for the port. The method
paths stay the JAX package's, ``/olearning_sim_tpu.services.<Service>/<method>``:
they are the wire's names, not an import, so every existing client reaches
the port and the port's clients reach a JAX server. ``ResourceSnapshot.
topology_json`` carries the port's own topology (``DeviceTopology``), and
PerformanceMgr's ``startTrace``/``stopTrace`` hold a ``torch.profiler``
session. ``OutboundSinkServicer`` is a sink that collects published batches
(the receiving end of ``deviceflow.outbound.GrpcOutboundProducer``).
"""

from __future__ import annotations

import json
import threading
from typing import Dict, Tuple, Type

import grpc
from google.protobuf import empty_pb2

from olearning_sim_tpu_torch.proto import services_pb2 as spb

# The wire's service-path prefix (the JAX package's proto package).
SERVICE_PREFIX = "olearning_sim_tpu.services."


def _methods_of(service_cls) -> Dict[str, Tuple[Type, Type]]:
    return service_cls.METHODS


def add_service_to_server(servicer, server: grpc.Server) -> None:
    """Register any servicer class that defines SERVICE_NAME + METHODS."""
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )
        for name, (req, resp) in _methods_of(type(servicer)).items()
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(type(servicer).SERVICE_NAME, handlers),)
    )


class _ClientBase:
    SERVICE: Type = None

    def __init__(self, channel: grpc.Channel):
        self._calls = {
            name: channel.unary_unary(
                f"/{self.SERVICE.SERVICE_NAME}/{name}",
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString,
            )
            for name, (req, resp) in _methods_of(self.SERVICE).items()
        }


def _phones_to_proto(phones: Dict[str, Dict[str, int]]):
    return [
        spb.UserPhoneResource(
            user_id=user,
            phones=[spb.PhoneTypeCount(phone_type=t, num=n)
                    for t, n in sorted(types.items())],
        )
        for user, types in sorted(phones.items())
    ]


def _phones_from_proto(users) -> Dict[str, Dict[str, int]]:
    return {u.user_id: {p.phone_type: p.num for p in u.phones} for u in users}


# ---------------------------------------------------------------- ResourceMgr
class ResourceMgrServicer:
    """Adapter onto the port's :class:`ResourceManager` (resource ledger)."""

    SERVICE_NAME = SERVICE_PREFIX + "ResourceMgr"
    METHODS = {
        "getResource": (empty_pb2.Empty, spb.ResourceSnapshot),
        "getClusterAvailableResource": (empty_pb2.Empty, spb.ClusterResource),
        "getClusterTotalResource": (empty_pb2.Empty, spb.ClusterResource),
        "getClusterResourceDetail": (empty_pb2.Empty, spb.ClusterDetail),
        "requestClusterResource": (spb.ClusterResourceRequest, spb.Ack),
        "releaseClusterResource": (spb.TaskRef, spb.Ack),
        "requestPhoneResource": (spb.PhoneResourceRequest, spb.Ack),
        "releaseResource": (spb.TaskRef, spb.Ack),
    }

    def __init__(self, manager):
        self.manager = manager

    def getResource(self, request, context) -> spb.ResourceSnapshot:
        res = self.manager.get_resource()
        return spb.ResourceSnapshot(
            logical_simulation=spb.ClusterResource(
                cpu=res["logical_simulation"]["cpu"],
                mem=res["logical_simulation"]["mem"],
            ),
            device_simulation=_phones_to_proto(res.get("device_simulation", {})),
            topology_json=json.dumps(res.get("topology", {})),
        )

    def getClusterAvailableResource(self, request, context) -> spb.ClusterResource:
        avail = self.manager.get_cluster_available_resource()
        return spb.ClusterResource(cpu=avail["cpu"], mem=avail["mem"])

    def getClusterTotalResource(self, request, context) -> spb.ClusterResource:
        total = self.manager.get_cluster_total_resource()
        return spb.ClusterResource(cpu=total["cpu"], mem=total["mem"])

    def getClusterResourceDetail(self, request, context) -> spb.ClusterDetail:
        return spb.ClusterDetail(
            detail_json=json.dumps(self.manager.get_cluster_resource_detail())
        )

    def requestClusterResource(self, request, context) -> spb.Ack:
        ok = self.manager.request_cluster_resource(
            request.task_id, request.user_id, request.cpu, request.mem
        )
        return spb.Ack(is_success=ok)

    def releaseClusterResource(self, request, context) -> spb.Ack:
        return spb.Ack(is_success=self.manager.release_cluster_resource(request.task_id))

    def requestPhoneResource(self, request, context) -> spb.Ack:
        ok = self.manager.request_phone_resource(
            request.task_id, request.user_id,
            {p.phone_type: p.num for p in request.phones},
        )
        return spb.Ack(is_success=ok)

    def releaseResource(self, request, context) -> spb.Ack:
        return spb.Ack(is_success=self.manager.release_resource(request.task_id))


class ResourceMgrClient(_ClientBase):
    SERVICE = ResourceMgrServicer

    def get_resource(self):
        snap = self._calls["getResource"](empty_pb2.Empty())
        return {
            "logical_simulation": {"cpu": snap.logical_simulation.cpu,
                                   "mem": snap.logical_simulation.mem},
            "device_simulation": _phones_from_proto(snap.device_simulation),
            "topology": json.loads(snap.topology_json or "{}"),
        }

    def get_cluster_available_resource(self):
        r = self._calls["getClusterAvailableResource"](empty_pb2.Empty())
        return {"cpu": r.cpu, "mem": r.mem}

    def get_cluster_total_resource(self):
        r = self._calls["getClusterTotalResource"](empty_pb2.Empty())
        return {"cpu": r.cpu, "mem": r.mem}

    def get_cluster_resource_detail(self):
        r = self._calls["getClusterResourceDetail"](empty_pb2.Empty())
        return json.loads(r.detail_json or "[]")

    def request_cluster_resource(self, task_id, user_id, cpu, mem) -> bool:
        return self._calls["requestClusterResource"](spb.ClusterResourceRequest(
            task_id=task_id, user_id=user_id, cpu=cpu, mem=mem)).is_success

    def release_cluster_resource(self, task_id) -> bool:
        return self._calls["releaseClusterResource"](
            spb.TaskRef(task_id=task_id)).is_success

    def request_phone_resource(self, task_id, user_id, phones) -> bool:
        return self._calls["requestPhoneResource"](spb.PhoneResourceRequest(
            task_id=task_id, user_id=user_id,
            phones=[spb.PhoneTypeCount(phone_type=t, num=n)
                    for t, n in phones.items()])).is_success

    def release_resource(self, task_id) -> bool:
        return self._calls["releaseResource"](spb.TaskRef(task_id=task_id)).is_success


# ----------------------------------------------------------------- DeviceFlow
class DeviceFlowServicer:
    """Adapter onto :class:`DeviceFlowService` (reference
    ``deviceflow_server.py:43`` surface, ``deviceflow.proto:63-72``)."""

    SERVICE_NAME = SERVICE_PREFIX + "DeviceFlow"
    METHODS = {
        "RegisterTask": (spb.FlowRegisterRequest, spb.Ack),
        "UnRegisterTask": (spb.TaskRef, spb.Ack),
        "NotifyStart": (spb.FlowNotifyRequest, spb.Ack),
        "NotifyComplete": (spb.FlowNotifyRequest, spb.Ack),
        "PublishInbound": (spb.InboundMessage, spb.Ack),
        "GetTotalComputeResources": (spb.TaskRef, spb.FlowRegisterRequest),
        "CheckDeviceflowDispatchFinished": (spb.TaskRef, spb.Ack),
        "GetOutboundEndpoint": (empty_pb2.Empty, spb.OutboundEndpoint),
    }

    def __init__(self, service, outbound_endpoint: Dict[str, str] = None):
        self.service = service
        self.outbound_endpoint = outbound_endpoint or {
            "kind": "queue", "url": "inproc", "topic": "deviceflow_inbound",
        }

    def RegisterTask(self, request, context) -> spb.Ack:
        ok = self.service.register_task(
            request.task_id, list(request.total_compute_resources)
        )
        return spb.Ack(is_success=ok)

    def UnRegisterTask(self, request, context) -> spb.Ack:
        return spb.Ack(is_success=self.service.unregister_task(request.task_id))

    def NotifyStart(self, request, context) -> spb.Ack:
        outbound = None
        if request.outbound_service:
            try:
                outbound = json.loads(request.outbound_service)
            except ValueError:
                return spb.Ack(
                    is_success=False, message="outbound_service not json"
                )
        ok, msg = self.service.notify_start(
            request.task_id, request.routing_key, request.compute_resource,
            request.strategy or "{}", outbound_service=outbound,
        )
        return spb.Ack(is_success=ok, message=msg or "")

    def NotifyComplete(self, request, context) -> spb.Ack:
        ok, msg = self.service.notify_complete(
            request.task_id, request.routing_key, request.compute_resource
        )
        return spb.Ack(is_success=ok, message=msg or "")

    def PublishInbound(self, request, context) -> spb.Ack:
        """Reference Pulsar inbound topic over gRPC: decode the JSON payload
        and drop it into the service's inbound room."""
        try:
            payload = json.loads(request.payload) if request.payload else None
        except ValueError:
            return spb.Ack(is_success=False, message="payload not json")
        self.service.publish(
            request.routing_key, request.compute_resource, payload
        )
        return spb.Ack(is_success=True)

    def GetTotalComputeResources(self, request, context) -> spb.FlowRegisterRequest:
        entry = self.service.registry.get(request.task_id) \
            if hasattr(self.service, "registry") else None
        resources = (entry or {}).get("total_compute_resources", [])
        return spb.FlowRegisterRequest(
            task_id=request.task_id, total_compute_resources=resources
        )

    def CheckDeviceflowDispatchFinished(self, request, context) -> spb.Ack:
        return spb.Ack(is_success=self.service.check_dispatch_finished(request.task_id))

    def GetOutboundEndpoint(self, request, context) -> spb.OutboundEndpoint:
        return spb.OutboundEndpoint(**self.outbound_endpoint)


class DeviceFlowClient(_ClientBase):
    SERVICE = DeviceFlowServicer

    def register_task(self, task_id, total_compute_resources) -> bool:
        return self._calls["RegisterTask"](spb.FlowRegisterRequest(
            task_id=task_id,
            total_compute_resources=total_compute_resources)).is_success

    def unregister_task(self, task_id) -> bool:
        return self._calls["UnRegisterTask"](spb.TaskRef(task_id=task_id)).is_success

    def notify_start(self, task_id, routing_key, compute_resource,
                     strategy="{}", outbound_service=None):
        ack = self._calls["NotifyStart"](spb.FlowNotifyRequest(
            task_id=task_id, routing_key=routing_key,
            compute_resource=compute_resource, strategy=strategy,
            outbound_service=(
                json.dumps(outbound_service) if outbound_service else ""
            )))
        return ack.is_success, ack.message

    def notify_complete(self, task_id, routing_key, compute_resource):
        ack = self._calls["NotifyComplete"](spb.FlowNotifyRequest(
            task_id=task_id, routing_key=routing_key,
            compute_resource=compute_resource))
        return ack.is_success, ack.message

    def publish(self, routing_key, compute_resource, payload):
        """Duck-type-compatible with DeviceFlowService.publish — a runner
        wired to this client ships updates across processes (the reference's
        Pulsar publish, message_producer.py analogue)."""
        ack = self._calls["PublishInbound"](spb.InboundMessage(
            routing_key=routing_key, compute_resource=compute_resource,
            payload=json.dumps(payload)))
        if not ack.is_success:
            raise IOError(f"PublishInbound rejected: {ack.message}")

    def check_dispatch_finished(self, task_id) -> bool:
        return self._calls["CheckDeviceflowDispatchFinished"](
            spb.TaskRef(task_id=task_id)).is_success

    def get_outbound_endpoint(self):
        ep = self._calls["GetOutboundEndpoint"](empty_pb2.Empty())
        return {"kind": ep.kind, "url": ep.url, "topic": ep.topic}


# --------------------------------------------------------------- PhoneManager
class PhoneManagerServicer:
    """Adapter onto :class:`SimulatedPhoneFarm` (or a real phone-farm proxy)."""

    SERVICE_NAME = SERVICE_PREFIX + "PhoneManager"
    METHODS = {
        "submitTask": (spb.DeviceJobRequest, spb.Ack),
        "getDeviceAvailableResource": (empty_pb2.Empty, spb.AllUsersPhoneResource),
        "requestDeviceResource": (spb.PhoneResourceRequest, spb.Ack),
        "releaseDeviceResource": (spb.TaskRef, spb.Ack),
        "stopDevice": (spb.TaskRef, spb.Ack),
        "getDeviceTaskStatus": (spb.TaskRef, spb.DeviceTaskResult),
    }

    def __init__(self, farm):
        self.farm = farm

    def submitTask(self, request, context) -> spb.Ack:
        ok = self.farm.submit_task(
            request.task_id, rounds=request.rounds,
            operators=list(request.operators),
            data=[{"name": d.name, "devices": list(d.device_types),
                   "nums": list(d.nums)} for d in request.data],
        )
        return spb.Ack(is_success=ok)

    def getDeviceAvailableResource(self, request, context) -> spb.AllUsersPhoneResource:
        return spb.AllUsersPhoneResource(
            users=_phones_to_proto(self.farm.get_device_available_resource())
        )

    def requestDeviceResource(self, request, context) -> spb.Ack:
        ok = self.farm.request_device_resource(
            request.task_id, request.user_id,
            {p.phone_type: p.num for p in request.phones},
        )
        return spb.Ack(is_success=ok)

    def releaseDeviceResource(self, request, context) -> spb.Ack:
        return spb.Ack(is_success=self.farm.release_device_resource(request.task_id))

    def stopDevice(self, request, context) -> spb.Ack:
        return spb.Ack(is_success=self.farm.stop_device(request.task_id))

    def getDeviceTaskStatus(self, request, context) -> spb.DeviceTaskResult:
        st = self.farm.get_device_task_status(request.task_id)
        return spb.DeviceTaskResult(
            is_finished=st["is_finished"],
            max_round=st.get("max_round", 0),
            round=st.get("round", 0),
            operator=st.get("operator", ""),
            device_data_status=[
                spb.DeviceDataStatus(
                    name=r["name"],
                    device_types=r["simulation_target"]["devices"],
                    success_num=r["simulation_target"]["success_num"],
                    failed_num=r["simulation_target"]["failed_num"],
                )
                for r in st.get("device_result", [])
            ],
        )


class PhoneManagerClient(_ClientBase):
    """Drop-in ``phone_client`` for TaskManager: same method names/shapes as
    :class:`SimulatedPhoneFarm`, over the wire."""

    SERVICE = PhoneManagerServicer

    def submit_task(self, task_id, rounds, operators, data) -> bool:
        return self._calls["submitTask"](spb.DeviceJobRequest(
            task_id=task_id, rounds=rounds, operators=operators,
            data=[spb.DeviceDataTarget(name=d["name"],
                                       device_types=d["devices"],
                                       nums=d["nums"]) for d in data],
        )).is_success

    def get_device_available_resource(self):
        return _phones_from_proto(
            self._calls["getDeviceAvailableResource"](empty_pb2.Empty()).users
        )

    def request_device_resource(self, task_id, user_id, phones) -> bool:
        return self._calls["requestDeviceResource"](spb.PhoneResourceRequest(
            task_id=task_id, user_id=user_id,
            phones=[spb.PhoneTypeCount(phone_type=t, num=n)
                    for t, n in phones.items()])).is_success

    def release_device_resource(self, task_id) -> bool:
        return self._calls["releaseDeviceResource"](
            spb.TaskRef(task_id=task_id)).is_success

    def stop_device(self, task_id) -> bool:
        return self._calls["stopDevice"](spb.TaskRef(task_id=task_id)).is_success

    def get_device_task_status(self, task_id):
        r = self._calls["getDeviceTaskStatus"](spb.TaskRef(task_id=task_id))
        return {
            "is_finished": r.is_finished,
            "max_round": r.max_round,
            "round": r.round,
            "operator": r.operator,
            "device_result": [
                {"name": s.name,
                 "simulation_target": {"devices": list(s.device_types),
                                       "success_num": list(s.success_num),
                                       "failed_num": list(s.failed_num)}}
                for s in r.device_data_status
            ],
        }


# ------------------------------------------------------------------- SliceMgr
class SliceMgrServicer:
    """Adapter onto the port's :class:`ClusterManager` (slices of CUDA cards) or
    :class:`K8sClusterManager` (GPU pod Jobs): both raise ``ValueError`` or
    ``KeyError`` on a refused request, which the servicer nacks."""

    SERVICE_NAME = SERVICE_PREFIX + "SliceMgr"
    METHODS = {
        "createSlice": (spb.SliceCreateParam, spb.Ack),
        "modifySlice": (spb.SliceModifyParam, spb.Ack),
        "deleteSlice": (spb.SliceRef, spb.Ack),
        "querySlice": (spb.SliceRef, spb.SliceQueryResult),
    }

    def __init__(self, manager):
        self.manager = manager

    def createSlice(self, request, context) -> spb.Ack:
        try:
            self.manager.create_slice(request.slice_name, request.num_devices,
                                      request.user_id)
            return spb.Ack(is_success=True)
        except (ValueError, KeyError) as e:
            return spb.Ack(is_success=False, message=str(e))

    def modifySlice(self, request, context) -> spb.Ack:
        try:
            self.manager.modify_slice(request.slice_name, request.num_devices)
            return spb.Ack(is_success=True)
        except (ValueError, KeyError) as e:
            return spb.Ack(is_success=False, message=str(e))

    def deleteSlice(self, request, context) -> spb.Ack:
        return spb.Ack(is_success=self.manager.delete_slice(request.slice_name))

    def querySlice(self, request, context) -> spb.SliceQueryResult:
        q = self.manager.query_slice(request.slice_name)
        return spb.SliceQueryResult(json_data=json.dumps(q) if q else "")


class SliceMgrClient(_ClientBase):
    SERVICE = SliceMgrServicer

    def create_slice(self, name, num_devices, user_id=""):
        ack = self._calls["createSlice"](spb.SliceCreateParam(
            slice_name=name, num_devices=num_devices, user_id=user_id))
        return ack.is_success, ack.message

    def modify_slice(self, name, num_devices):
        ack = self._calls["modifySlice"](spb.SliceModifyParam(
            slice_name=name, num_devices=num_devices))
        return ack.is_success, ack.message

    def delete_slice(self, name) -> bool:
        return self._calls["deleteSlice"](spb.SliceRef(slice_name=name)).is_success

    def query_slice(self, name):
        r = self._calls["querySlice"](spb.SliceRef(slice_name=name))
        return json.loads(r.json_data) if r.json_data else None


# ------------------------------------------------------------- PerformanceMgr
class PerformanceMgrServicer:
    SERVICE_NAME = SERVICE_PREFIX + "PerformanceMgr"
    METHODS = {
        "getPerformance": (spb.TaskRef, spb.PerformanceReport),
        "getMetrics": (spb.MetricsQuery, spb.MetricsSnapshot),
        "startTrace": (spb.TraceRequest, spb.Ack),
        "stopTrace": (empty_pb2.Empty, spb.TraceRequest),
    }

    def __init__(self, manager):
        self.manager = manager

    def getPerformance(self, request, context) -> spb.PerformanceReport:
        return spb.PerformanceReport(
            json_data=json.dumps(self.manager.get_performance(request.task_id))
        )

    def getMetrics(self, request, context) -> spb.MetricsSnapshot:
        """Live telemetry registry, rendered: Prometheus text exposition by
        default, JSON snapshot for ``format="json"``."""
        fmt = (request.format or "prometheus").lower()
        body = self.manager.render_metrics(fmt)
        ctype = ("application/json" if fmt in ("json", "snapshot")
                 else "text/plain; version=0.0.4; charset=utf-8")
        return spb.MetricsSnapshot(content_type=ctype, body=body)

    def startTrace(self, request, context) -> spb.Ack:
        return spb.Ack(is_success=self.manager.start_trace(request.logdir))

    def stopTrace(self, request, context) -> spb.TraceRequest:
        return spb.TraceRequest(logdir=self.manager.stop_trace() or "")


class PerformanceMgrClient(_ClientBase):
    SERVICE = PerformanceMgrServicer

    def get_performance(self, task_id):
        r = self._calls["getPerformance"](spb.TaskRef(task_id=task_id))
        return json.loads(r.json_data)

    def get_metrics(self, fmt: str = "prometheus"):
        """Returns (content_type, rendered_body)."""
        r = self._calls["getMetrics"](spb.MetricsQuery(format=fmt))
        return r.content_type, r.body

    def start_trace(self, logdir) -> bool:
        return self._calls["startTrace"](spb.TraceRequest(logdir=logdir)).is_success

    def stop_trace(self):
        return self._calls["stopTrace"](empty_pb2.Empty()).logdir or None


# --------------------------------------------------------------- OutboundSink
class OutboundSinkServicer:
    """A collecting ``OutboundSink``: each ``PublishBatch`` appends
    ``(flow_id, [message, ...])`` to ``batches``, in arrival order."""

    SERVICE_NAME = SERVICE_PREFIX + "OutboundSink"
    METHODS = {"PublishBatch": (spb.OutboundBatch, spb.Ack)}

    def __init__(self):
        self.batches = []
        self._lock = threading.Lock()

    def PublishBatch(self, request, context) -> spb.Ack:
        with self._lock:
            self.batches.append((request.flow_id, list(request.messages)))
        return spb.Ack(is_success=True)


class OutboundSinkClient(_ClientBase):
    SERVICE = OutboundSinkServicer

    def publish_batch(self, flow_id, messages, timeout=None):
        """Returns the sink's ``(is_success, message)``."""
        ack = self._calls["PublishBatch"](
            spb.OutboundBatch(flow_id=flow_id, messages=messages), timeout=timeout)
        return ack.is_success, ack.message
