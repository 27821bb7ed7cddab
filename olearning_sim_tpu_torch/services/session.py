"""SimulatorSession — the selected control-plane services in one process
(reference ``ols_core/simu_session.py:25-70``: boots
TaskMgr/ResourceMgr/RayClusterMgr/PerformanceMgr into one process by ``svc``
selector; here DeviceFlow and PhoneManager join the same process too, since
no external Pulsar/phone-farm processes are required in single-host mode).

A copy of the JAX package's ``services/session.py`` without the gRPC server:
the port has no grpc or protobuf, so the session serves no port. It builds
the same managers by the same ``services`` list, wires the task manager to
them, and starts and stops the manager's daemons, the supervisor, the
deviceflow threads and the optional metrics endpoint. Tasks enter through
the manager's intake queue (a ``SqliteQueueRepo`` any local producer pushes
task JSON onto) or through ``session.task_manager.submit_task``. Everything
runs on ``device``: ``"cuda"`` unless the caller asks for the CPU.
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
        task_manager=None,
        resource_manager=None,
        deviceflow=None,
        phone_farm=None,
        cluster_manager=None,
        performance_manager=None,
        metrics_port: Optional[int] = None,
        supervisor=None,
        supervise: bool = True,
        device="cuda",
    ):
        """``metrics_port`` — when set, start() also serves the telemetry
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

    # ------------------------------------------------------------------ boot
    def start(self) -> "SimulatorSession":
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

    def stop(self) -> None:
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
