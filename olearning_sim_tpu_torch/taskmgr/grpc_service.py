"""gRPC surface for TaskMgr.

Wire-compatible with the reference service (``ols_core/proto/taskService.proto:205-211``:
``/TaskMgr/submitTask`` etc. — the reference proto has no package, so method
paths use the bare service name). Stubs are hand-written over grpc generic
handlers (protoc's Python output without grpc_python_plugin).

The JAX package's ``taskmgr/grpc_service.py`` for the port: the servicer
turns the wire ``TaskConfig`` into the port's dataclass
(``proto_codec.taskconfig_from_proto``) before ``submit_task``; the client
takes a wire ``TaskConfig`` (this package's message or the JAX package's:
both serialize alike).
"""

from __future__ import annotations

from concurrent import futures

import grpc
from google.protobuf import empty_pb2

from olearning_sim_tpu_torch.proto import taskservice_pb2 as pb
from olearning_sim_tpu_torch.taskmgr.proto_codec import taskconfig_from_proto

SERVICE_NAME = "TaskMgr"


class TaskMgrServicer:
    """RPC handlers delegating to a :class:`~olearning_sim_tpu_torch.taskmgr.task_manager.TaskManager`."""

    def __init__(self, manager):
        self.manager = manager

    def submitTask(self, request: pb.TaskConfig, context) -> pb.OperationStatus:
        ok = self.manager.submit_task(taskconfig_from_proto(request))
        return pb.OperationStatus(is_success=ok)

    def stopTask(self, request: pb.TaskID, context) -> pb.OperationStatus:
        return pb.OperationStatus(is_success=self.manager.stop_task(request.taskID))

    def getTaskStatus(self, request: pb.TaskID, context) -> pb.TaskStatus:
        status = self.manager.get_task_status(request.taskID)
        return pb.TaskStatus(taskStatus=int(status))

    def getTaskQueue(self, request, context) -> pb.TaskQueue:
        ids = self.manager.get_task_queue()
        return pb.TaskQueue(tasks=[pb.TaskID(taskID=i) for i in ids])

    def changeScheduler(self, request: pb.Scheduler, context) -> pb.OperationStatus:
        return pb.OperationStatus(is_success=self.manager.change_scheduler(request.scheduler))


_METHODS = {
    "submitTask": (pb.TaskConfig, pb.OperationStatus),
    "stopTask": (pb.TaskID, pb.OperationStatus),
    "getTaskStatus": (pb.TaskID, pb.TaskStatus),
    "getTaskQueue": (empty_pb2.Empty, pb.TaskQueue),
    "changeScheduler": (pb.Scheduler, pb.OperationStatus),
}


def add_taskmgr_to_server(servicer: TaskMgrServicer, server: grpc.Server) -> None:
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )
        for name, (req, resp) in _METHODS.items()
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )


class TaskMgrClient:
    """Client stub (reference clients call e.g. ``/TaskMgr/submitTask``)."""

    def __init__(self, channel: grpc.Channel):
        self._calls = {
            name: channel.unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp.FromString,
            )
            for name, (req, resp) in _METHODS.items()
        }

    def submitTask(self, tc) -> pb.OperationStatus:
        return self._calls["submitTask"](tc)

    def stopTask(self, task_id: str) -> pb.OperationStatus:
        return self._calls["stopTask"](pb.TaskID(taskID=task_id))

    def getTaskStatus(self, task_id: str) -> pb.TaskStatus:
        return self._calls["getTaskStatus"](pb.TaskID(taskID=task_id))

    def getTaskQueue(self) -> pb.TaskQueue:
        return self._calls["getTaskQueue"](empty_pb2.Empty())

    def changeScheduler(self, name: str) -> pb.OperationStatus:
        return self._calls["changeScheduler"](pb.Scheduler(scheduler=name))


def serve_taskmgr(manager, address: str = "127.0.0.1:0",
                  max_workers: int = 8) -> tuple[grpc.Server, int]:
    """Start a TaskMgr gRPC server; returns (server, bound_port)."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    add_taskmgr_to_server(TaskMgrServicer(manager), server)
    port = server.add_insecure_port(address)
    server.start()
    return server, port
