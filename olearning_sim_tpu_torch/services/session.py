"""SimulatorSession — one gRPC server hosting the selected control-plane
services (reference ``ols_core/simu_session.py:25-70``: boots
TaskMgr/ResourceMgr/RayClusterMgr/PerformanceMgr into one process by ``svc``
selector; here DeviceFlow and PhoneManager join the same process too, since
no external Pulsar/phone-farm processes are required in single-host mode).

The JAX package's ``services/session.py`` for the port. It builds the same
managers by the same ``services`` list, wires the task manager to them, and
``start()`` serves each selected manager's servicer on ``address`` (default
``"127.0.0.1:0"``, an ephemeral port read back from ``session.port``) with
``max_workers`` threads, as JAX's does. ``address=None`` is the in-process
session: the same managers and daemons, no server and no port; tasks then
enter through the manager's intake queue (a ``SqliteQueueRepo`` any local
producer pushes task JSON onto) or ``session.task_manager.submit_task``.
Serving needs grpcio and protobuf, loaded at ``start()``: without them a
session with an address raises an ``ImportError`` naming both and never
falls back to in process. Everything runs on ``device``: ``"cuda"`` unless
the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Iterable, Optional

from olearning_sim_tpu_torch.device import resolve_device

ALL_SERVICES = ("taskmgr", "resourcemgr", "deviceflow", "phonemgr",
                "slicemgr", "performancemgr")


class SimulatorSession:
    """Compose managers into one process.

    Any manager may be None (service omitted) — matching the reference's
    ``svc`` list selector. Construction wires defaults so
    ``SimulatorSession().start()`` gives a fully working single-host platform:
    ResourceManager over the device's cards, DeviceFlowService,
    PerformanceManager, ClusterManager, and a TaskManager wired to all of
    them (plus an optional SimulatedPhoneFarm).
    """

    def __init__(
        self,
        services: Iterable[str] = ALL_SERVICES,
        address: Optional[str] = "127.0.0.1:0",
        task_manager=None,
        resource_manager=None,
        deviceflow=None,
        phone_farm=None,
        cluster_manager=None,
        performance_manager=None,
        max_workers: int = 16,
        metrics_port: Optional[int] = None,
        supervisor=None,
        supervise: bool = True,
        device="cuda",
    ):
        """``address`` — where ``start()`` serves the selected services over
        gRPC (``host:port``; port 0 binds an ephemeral one, readable from
        ``session.port``); None runs the session in process, serving
        nothing. ``max_workers`` — the server's handler threads.

        ``metrics_port`` — when set, start() also serves the telemetry
        registry on ``127.0.0.1:<metrics_port>`` (``/metrics`` Prometheus
        text, ``/metrics.json`` snapshot; 0 binds an ephemeral port,
        readable from ``session.metrics_server.port``).

        ``supervisor`` / ``supervise`` — crash-safe task supervision: when
        the session hosts a task manager and ``supervise`` is on, a
        :class:`~olearning_sim_tpu_torch.supervisor.TaskSupervisor` (the
        given one, or a default over the manager) starts/stops with the
        session, and a session-built manager recovers resume-first
        (orphaned RUNNING rows are left for the supervisor to reclaim
        instead of being failed on boot).

        ``device`` — where the session's default managers run: the task
        manager builds runners there and the resource ledger counts its
        cards. ``"cuda"`` raises here without a card."""
        self.device = resolve_device(device)
        self.services = tuple(services)
        self.address = address
        self._server = None
        self.port: Optional[int] = None
        self.metrics_port = metrics_port
        self.metrics_server = None

        if "resourcemgr" in self.services and resource_manager is None:
            from olearning_sim_tpu_torch.resourcemgr.resource_manager import (
                DeviceTopology,
                ResourceManager,
            )

            phone_provider = (
                phone_farm.get_device_available_resource
                if phone_farm is not None else None
            )
            resource_manager = ResourceManager(
                topology=DeviceTopology.detect(self.device),
                phone_provider=phone_provider)
        if "deviceflow" in self.services and deviceflow is None:
            from olearning_sim_tpu_torch.deviceflow.service import DeviceFlowService

            deviceflow = DeviceFlowService()
        if "slicemgr" in self.services and cluster_manager is None:
            from olearning_sim_tpu_torch.clustermgr import ClusterManager

            cluster_manager = ClusterManager(
                devices=None if self.device.type == "cuda" else [self.device])
        if "performancemgr" in self.services and performance_manager is None:
            from olearning_sim_tpu_torch.performancemgr import PerformanceManager

            performance_manager = PerformanceManager()
        if "taskmgr" in self.services and task_manager is None:
            from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager

            task_manager = TaskManager(
                resource_manager=resource_manager,
                deviceflow=deviceflow,
                phone_client=phone_farm,
                perf=performance_manager,
                supervise_orphans=supervise,
                device=self.device,
            )
        if (supervise and "taskmgr" in self.services
                and task_manager is not None):
            # A user-supplied manager must share the session's resume-first
            # posture, or its release loop would MISSING-fail orphans ahead
            # of the supervisor's reclaim. (Boot-time `_recover` already ran
            # at THAT manager's construction — managers built for a
            # supervised session should pass supervise_orphans=True
            # themselves to also recover resume-first.)
            task_manager._supervise_orphans = True
            if supervisor is None:
                from olearning_sim_tpu_torch.supervisor import TaskSupervisor

                supervisor = TaskSupervisor(task_manager)
        self.supervisor = supervisor

        self.task_manager = task_manager
        self.resource_manager = resource_manager
        self.deviceflow = deviceflow
        self.phone_farm = phone_farm
        self.cluster_manager = cluster_manager
        self.performance_manager = performance_manager
        self._max_workers = max_workers

    # ------------------------------------------------------------------ boot
    def _serve(self):
        """The gRPC server with each selected manager's servicer, bound to
        ``address`` and started; ``session.port`` is its port."""
        from concurrent import futures

        from olearning_sim_tpu_torch.utils.wire import load_wire

        purpose = f"serving the platform on {self.address}"
        hint = ", or run the session in process (address None; session.address none)"
        grpc_services = load_wire("olearning_sim_tpu_torch.services.grpc_services", purpose,
                                  hint)
        taskmgr = load_wire("olearning_sim_tpu_torch.taskmgr.grpc_service", purpose, hint)
        server = grpc_services.grpc.server(futures.ThreadPoolExecutor(self._max_workers))
        if "taskmgr" in self.services and self.task_manager is not None:
            taskmgr.add_taskmgr_to_server(taskmgr.TaskMgrServicer(self.task_manager), server)
        servicers = (
            ("resourcemgr", self.resource_manager, grpc_services.ResourceMgrServicer),
            ("deviceflow", self.deviceflow, grpc_services.DeviceFlowServicer),
            ("phonemgr", self.phone_farm, grpc_services.PhoneManagerServicer),
            ("slicemgr", self.cluster_manager, grpc_services.SliceMgrServicer),
            ("performancemgr", self.performance_manager,
             grpc_services.PerformanceMgrServicer),
        )
        for name, manager, servicer in servicers:
            if name in self.services and manager is not None:
                grpc_services.add_service_to_server(servicer(manager), server)
        port = server.add_insecure_port(self.address)
        if not port:
            raise RuntimeError(f"the platform could not bind {self.address}")
        server.start()
        self._server, self.port = server, port

    def start(self) -> "SimulatorSession":
        """Serve ``address`` (unless it is None), then start the managers'
        daemons. A missing grpcio or protobuf raises here, before any
        daemon starts."""
        if self.address is not None and self._server is None:
            self._serve()
        if "taskmgr" in self.services and self.task_manager is not None:
            self.task_manager.start()
            if self.supervisor is not None:
                self.supervisor.start()
        if "deviceflow" in self.services and self.deviceflow is not None:
            self.deviceflow.start()
        if self.metrics_port is not None and self.metrics_server is None:
            from olearning_sim_tpu_torch.telemetry import MetricsHTTPServer

            registry = getattr(self.performance_manager, "registry", None)
            self.metrics_server = MetricsHTTPServer(
                registry=registry, port=self.metrics_port
            ).start()
        return self

    def stop(self, grace: float = 1.0) -> None:
        """Stop the server first (in-flight calls get ``grace`` seconds),
        then the metrics endpoint, the supervisor and the daemons."""
        if self._server is not None:
            self._server.stop(grace).wait()
            self._server = None
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.task_manager is not None and hasattr(self.task_manager, "stop"):
            self.task_manager.stop()
        if self.deviceflow is not None and hasattr(self.deviceflow, "stop"):
            self.deviceflow.stop()

    def __enter__(self) -> "SimulatorSession":
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()
