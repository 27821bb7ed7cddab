"""Programmatic GPU-pod provisioning against the Kubernetes API.

The reference vendors a full KubeRay CustomObjects client + CR builder
(``rayclusterMgr/kuberay_cluster_api.py:14`` RayClusterApi with
list/get/create/delete/patch + status polling;
``kuberay_cluster_builder.py:41`` ClusterBuilder's fluent
``build_meta().build_head().build_worker().get_cluster()`` with a
``succeeded`` flag; ``kuberay_cluster_utils.py`` update_worker_group_replicas)
and drives it from a gRPC servicer (``kuberay_cluster_manager.py:59-225``
create/modify/delete/queryRayCluster).

The port needs no CRD or operator either: a world of worker processes on
GPU nodes is an **Indexed batch/v1 Job + headless Service**. Each pod
reserves one card (``nvidia.com/gpu``; the worker drives one device a
process), the completion index is the process rank, the headless Service
gives rank 0 a stable name for the coordinator address, and the pods run
:mod:`olearning_sim_tpu_torch.clustermgr.worker`, which joins the
``torch.distributed`` world over NCCL from the ``OLS_*`` variables
(``deploy/k8s/gpu-pod-job.yaml``). The module keeps the reference's three
layers:

- :class:`GpuPodJobBuilder` — fluent builder producing the Service+Job
  pair; ``tests/test_torch_k8s_api.py`` pins its output (comments aside)
  to the committed manifest so the two can never drift.
- :class:`GpuPodJobApi` — CRUD + status polling against the k8s API.
  Pass ``batch_api``/``core_api`` (fakes in tests, or ``kubernetes.client``
  objects in production); the zero-argument constructor loads kubeconfig
  through the ``kubernetes`` SDK, which only that path imports.
- :class:`K8sClusterManager` — create/modify/delete/query with the same
  (ok, info) semantics and PENDING/READY status vocabulary as
  :mod:`~olearning_sim_tpu_torch.clustermgr.slice_manager`.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from olearning_sim_tpu_torch.utils.logging import Logger

COORDINATOR_PORT = 29400
DEFAULT_NAME = "ols-engine-gpu"
DEFAULT_IMAGE = "REGISTRY/olearning-sim-tpu-torch:latest"
DEFAULT_ACCELERATOR = "nvidia-h100-80gb"
DEFAULT_LAUNCH_TARGET = "olearning_sim_tpu_torch.clustermgr.targets:smoke_round"
WORKER_MODULE = "olearning_sim_tpu_torch.clustermgr.worker"
# One card a pod: the worker drives one device a process.
GPUS_PER_POD = 1


def _status_of(exc: Any) -> Optional[int]:
    """HTTP status off either our :class:`ApiError` or the kubernetes
    SDK's ``ApiException`` (both expose ``.status``)."""
    return getattr(exc, "status", None)


class ApiError(Exception):
    """Stand-in for ``kubernetes.client.rest.ApiException`` so fakes (and
    callers without the SDK installed) can raise/catch by HTTP status."""

    def __init__(self, status: int, reason: str = ""):
        super().__init__(f"{status}: {reason}")
        self.status = status
        self.reason = reason


# --------------------------------------------------------------- builder
class GpuPodJobBuilder:
    """Fluent builder for the GPU-pod Service+Job pair.

    Mirrors the reference ClusterBuilder's protocol (fluent stages + a
    ``succeeded`` flag consulted before submission,
    ``kuberay_cluster_builder.py:41-100``): ``build_meta`` names the job,
    ``build_workers`` sizes the world, ``build_container`` sets image and
    target, ``get_objects`` returns ``[service, job]`` dicts ready for
    :meth:`GpuPodJobApi.create_pod_job` (or YAML serialization).
    """

    def __init__(self):
        self.name = DEFAULT_NAME
        self.namespace = "default"
        self.labels: Dict[str, str] = {}
        self.pods = 4
        self.accelerator = DEFAULT_ACCELERATOR
        self.image = DEFAULT_IMAGE
        self.launch_target = DEFAULT_LAUNCH_TARGET
        self.port = COORDINATOR_PORT
        self.succeeded = False
        self._errors: List[str] = []

    def build_meta(self, name: str = DEFAULT_NAME,
                   k8s_namespace: str = "default",
                   labels: Optional[Dict[str, str]] = None):
        if not name or not name.replace("-", "").isalnum() or name != name.lower():
            self._errors.append(f"invalid DNS-1123 name {name!r}")
        else:
            self.name = name
        self.namespace = k8s_namespace
        self.labels = dict(labels or {})
        return self

    def build_workers(self, pods: int = 4,
                      accelerator: str = DEFAULT_ACCELERATOR):
        """Size the world: one Job completion per rank, each pod on one
        card of an ``accelerator`` node (the analogue of the reference's
        worker replicas, ``kuberay_cluster_builder.py`` build_worker)."""
        if pods < 1:
            self._errors.append(f"pods must be >= 1, got {pods}")
        else:
            self.pods = pods
        self.accelerator = accelerator
        return self

    def build_container(self, image: str = DEFAULT_IMAGE,
                        launch_target: str = DEFAULT_LAUNCH_TARGET,
                        port: int = COORDINATOR_PORT):
        if not image:
            self._errors.append("image must be non-empty")
        else:
            self.image = image
        if ":" not in launch_target:
            self._errors.append(
                f"launch target must be 'module:function', got {launch_target!r}")
        else:
            self.launch_target = launch_target
        self.port = port
        return self

    # ------------------------------------------------------------- output
    def get_objects(self) -> List[Dict[str, Any]]:
        """``[service, job]`` dicts; sets ``succeeded`` like the reference
        builder (callers must check it before submitting)."""
        self.succeeded = not self._errors
        service = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": self.name, **self._meta_extra()},
            "spec": {
                "clusterIP": "None",
                "selector": {"job-name": self.name},
                "ports": [{"port": self.port, "name": "coordinator"}],
            },
        }
        job = {
            "apiVersion": "batch/v1",
            "kind": "Job",
            "metadata": {"name": self.name, **self._meta_extra()},
            "spec": {
                "completions": self.pods,
                "parallelism": self.pods,
                "completionMode": "Indexed",
                "template": {
                    "metadata": {"labels": {"job-name": self.name,
                                            **self.labels}},
                    "spec": {
                        "subdomain": self.name,
                        "restartPolicy": "Never",
                        "nodeSelector": {
                            "cloud.google.com/gke-accelerator": self.accelerator,
                        },
                        "containers": [{
                            "name": "engine",
                            "image": self.image,
                            "command": ["python", "-m", WORKER_MODULE,
                                        "--target", self.launch_target],
                            "resources": {"limits": {
                                "nvidia.com/gpu": str(GPUS_PER_POD)}},
                            "env": [
                                {"name": "OLS_COORDINATOR_ADDRESS",
                                 "value": f"{self.name}-0.{self.name}:"
                                          f"{self.port}"},
                                {"name": "OLS_NUM_PROCESSES",
                                 "value": str(self.pods)},
                                {"name": "OLS_PROCESS_ID",
                                 "valueFrom": {"fieldRef": {"fieldPath":
                                     "metadata.annotations['batch.kubernetes"
                                     ".io/job-completion-index']"}}},
                                {"name": "OLS_DIST_BACKEND", "value": "nccl"},
                            ],
                            "ports": [{"containerPort": self.port}],
                        }],
                    },
                },
            },
        }
        return [service, job]

    def _meta_extra(self) -> Dict[str, Any]:
        extra: Dict[str, Any] = {}
        if self.namespace != "default":
            extra["namespace"] = self.namespace
        if self.labels:
            extra["labels"] = dict(self.labels)
        return extra


def update_job_parallelism(job: Dict[str, Any],
                           pods: int) -> Tuple[Dict[str, Any], bool]:
    """Re-size a BUILT Job manifest to ``pods`` ranks (the analogue of the
    reference's ``update_worker_group_replicas``,
    ``kuberay_cluster_utils.py``): returns (patched_copy, succeeded).

    For generating a fresh manifest at a new size (re-deploys, YAML
    export). A LIVE rescale must go through
    :meth:`K8sClusterManager.modify_cluster` instead — this copy also
    rewrites the pod template (OLS_NUM_PROCESSES), which the k8s API
    rejects as immutable on an existing Job."""
    if pods < 1:
        return job, False
    out = copy.deepcopy(job)
    try:
        out["spec"]["completions"] = pods
        out["spec"]["parallelism"] = pods
        env = out["spec"]["template"]["spec"]["containers"][0]["env"]
        for var in env:
            if var.get("name") == "OLS_NUM_PROCESSES":
                var["value"] = str(pods)
    except (KeyError, IndexError):
        return job, False
    return out, True


# ------------------------------------------------------------------- api
class GpuPodJobApi:
    """CRUD + status polling for GPU-pod jobs (reference: RayClusterApi,
    ``kuberay_cluster_api.py:14`` — same method-per-verb surface, same
    swallow-404/409-into-None error posture so control loops can poll
    without try/except at every site).

    ``batch_api``/``core_api``: any objects implementing the used subset of
    ``kubernetes.client.BatchV1Api``/``CoreV1Api`` **returning plain
    dicts** (production: construct those with ``kubernetes.client.ApiClient``
    preloaded config; tests: fakes). The zero-argument form requires the
    ``kubernetes`` SDK and a reachable kubeconfig.
    """

    def __init__(self, batch_api: Any = None, core_api: Any = None,
                 logger: Optional[Logger] = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        if batch_api is None or core_api is None:
            # Only the zero-argument production path needs the SDK.
            from kubernetes import client, config  # noqa: PLC0415

            config.load_kube_config()
            batch_api = batch_api or client.BatchV1Api()
            core_api = core_api or client.CoreV1Api()
        self.batch = batch_api
        self.core = core_api
        self.logger = logger if logger is not None else Logger()
        self._sleep = sleep_fn

    def _log(self, level: str, msg: str) -> None:
        getattr(self.logger, level)(task_id="", system_name="clustermgr",
                                    module_name="k8s_api", message=msg)

    # -------------------------------------------------------------- create
    def create_pod_job(self, objects: List[Dict[str, Any]],
                       k8s_namespace: str = "default") -> Optional[Any]:
        """Create the Service+Job pair. Returns the created Job resource,
        or None if it already exists / on API error (reference
        ``create_ray_cluster`` 409 posture)."""
        service = next(o for o in objects if o["kind"] == "Service")
        job = next(o for o in objects if o["kind"] == "Job")
        try:
            self.core.create_namespaced_service(namespace=k8s_namespace,
                                                body=service)
        except Exception as e:  # noqa: BLE001 — status-routed below
            if _status_of(e) != 409:  # idempotent re-create is fine
                self._log("error", f"error creating service: {e}")
                return None
        try:
            return self.batch.create_namespaced_job(namespace=k8s_namespace,
                                                    body=job)
        except Exception as e:  # noqa: BLE001
            if _status_of(e) == 409:
                self._log("error", f"pod job already exists: {e}")
            else:
                self._log("error", f"error creating pod job: {e}")
            return None

    # ---------------------------------------------------------------- read
    def get_pod_job(self, name: str,
                    k8s_namespace: str = "default") -> Optional[Any]:
        try:
            return self.batch.read_namespaced_job(name=name,
                                                  namespace=k8s_namespace)
        except Exception as e:  # noqa: BLE001
            if _status_of(e) == 404:
                self._log("error", f"pod job {name} not found: {e}")
            else:
                self._log("error", f"error fetching pod job {name}: {e}")
            return None

    def list_pod_jobs(self, k8s_namespace: str = "default",
                      label_selector: str = "") -> Optional[Any]:
        try:
            resource = self.batch.list_namespaced_job(
                namespace=k8s_namespace, label_selector=label_selector
            )
        except Exception as e:  # noqa: BLE001
            self._log("error", f"error listing pod jobs: {e}")
            return None
        if isinstance(resource, dict) and "items" not in resource:
            return None
        return resource

    def get_pod_job_status(self, name: str, k8s_namespace: str = "default",
                           timeout: float = 60,
                           delay_between_attempts: float = 5) -> Optional[Any]:
        """Poll until the Job reports a status (reference
        ``get_ray_cluster_status`` loop, ``kuberay_cluster_api.py:141``)."""
        while timeout > 0:
            job = self.get_pod_job(name, k8s_namespace)
            if job is None:
                return None
            status = job.get("status") if isinstance(job, dict) else None
            if status:
                return status
            self._log("info", f"pod job {name} status not set yet, waiting")
            self._sleep(delay_between_attempts)
            timeout -= delay_between_attempts
        self._log("info", f"pod job {name} status not set, timing out")
        return None

    def wait_until_pod_job_ready(self, name: str,
                                 k8s_namespace: str = "default",
                                 timeout: float = 60,
                                 delay_between_attempts: float = 5) -> bool:
        """True once every pod is running/ready (the analogue of the
        reference's head-serviceIP readiness probe,
        ``kuberay_cluster_api.py:185``). One Job read and one sleep per
        poll; returns within ``timeout`` (+ one delay) wall time."""
        while timeout > 0:
            job = self.get_pod_job(name, k8s_namespace)
            if job is None:
                return False
            want = job["spec"].get("parallelism", 1)
            status = job.get("status") or {}
            ready = status.get("ready", 0)
            if status and ready >= want:
                return True
            self._log("info", f"pod job {name} not ready ({ready}/{want})")
            self._sleep(delay_between_attempts)
            timeout -= delay_between_attempts
        return False

    # --------------------------------------------------------------- write
    def patch_pod_job(self, name: str, patch: Dict[str, Any],
                      k8s_namespace: str = "default") -> bool:
        try:
            self.batch.patch_namespaced_job(name=name,
                                            namespace=k8s_namespace,
                                            body=patch)
        except Exception as e:  # noqa: BLE001
            self._log("error", f"pod job {name} failed to patch: {e}")
            return False
        self._log("info", f"pod job {name} patched")
        return True

    def delete_pod_job(self, name: str,
                       k8s_namespace: str = "default") -> Optional[Any]:
        """Delete Job + its headless Service; None if already gone
        (reference ``delete_ray_cluster`` 404 posture)."""
        try:
            self.core.delete_namespaced_service(name=name,
                                                namespace=k8s_namespace)
        except Exception as e:  # noqa: BLE001
            if _status_of(e) != 404:
                self._log("error", f"error deleting service {name}: {e}")
        try:
            return self.batch.delete_namespaced_job(name=name,
                                                    namespace=k8s_namespace)
        except Exception as e:  # noqa: BLE001
            if _status_of(e) == 404:
                self._log("error", f"pod job {name} already deleted: {e}")
            else:
                self._log("error", f"error deleting pod job {name}: {e}")
            return None


# --------------------------------------------------------------- manager
class K8sClusterManager:
    """create/modify/delete/query over GPU-pod jobs with the reference
    servicer's semantics (``kuberay_cluster_manager.py:59-225``: build ->
    check ``succeeded`` -> submit; modify = re-size + patch) and the
    PENDING/READY vocabulary of
    :class:`~olearning_sim_tpu_torch.clustermgr.slice_manager.ClusterManager`,
    so a slice of local cards and a real k8s deployment answer queries in
    the same shape."""

    def __init__(self, api: GpuPodJobApi,
                 defaults: Optional[Dict[str, Any]] = None,
                 logger: Optional[Logger] = None):
        self.api = api
        self.defaults = dict(defaults or {})
        self.logger = logger if logger is not None else Logger()

    def _builder(self, name: str, namespace: str, pods: int):
        d = self.defaults
        return (
            GpuPodJobBuilder()
            .build_meta(name=name, k8s_namespace=namespace,
                        labels=d.get("labels"))
            .build_workers(
                pods=pods,
                accelerator=d.get("accelerator", DEFAULT_ACCELERATOR),
            )
            .build_container(
                image=d.get("image", DEFAULT_IMAGE),
                launch_target=d.get("launch_target", DEFAULT_LAUNCH_TARGET),
                port=d.get("port", COORDINATOR_PORT),
            )
        )

    def create_cluster(self, name: str, pods: int,
                       k8s_namespace: str = "default") -> bool:
        builder = self._builder(name, k8s_namespace, pods)
        objects = builder.get_objects()
        if not builder.succeeded:
            return False
        return self.api.create_pod_job(objects, k8s_namespace) is not None

    def modify_cluster(self, name: str, pods: int,
                       k8s_namespace: str = "default") -> bool:
        """Reference ``modifyRayCluster`` semantics (validate, re-size,
        patch) — but the patch body carries ONLY the mutable Job fields.
        Kubernetes rejects any change to a Job's ``spec.template`` with 422
        "field is immutable", so a full rebuilt-CR patch can never rescale
        a live Job. ``spec.parallelism`` is always mutable;
        ``spec.completions`` is mutable for elastic Indexed Jobs (the shape
        the builder emits). OLS_NUM_PROCESSES in the pod template stays at
        its creation value; a rescale of a running task goes through
        :class:`~olearning_sim_tpu_torch.clustermgr.elastic.ElasticWorldRunner`'s
        checkpoint-restart, which starts the new world."""
        if not name or not k8s_namespace or pods < 1:
            return False
        return self.api.patch_pod_job(
            name, {"spec": {"parallelism": pods, "completions": pods}},
            k8s_namespace,
        )

    def delete_cluster(self, name: str,
                       k8s_namespace: str = "default") -> bool:
        return self.api.delete_pod_job(name, k8s_namespace) is not None

    def query_cluster(self, name: str,
                      k8s_namespace: str = "default") -> Optional[Dict[str, Any]]:
        job = self.api.get_pod_job(name, k8s_namespace)
        if job is None:
            return None
        spec = job.get("spec", {})
        status = job.get("status") or {}
        want = spec.get("parallelism", 1)
        ready = status.get("ready", 0)
        return {
            "name": job["metadata"]["name"],
            "num_pods": want,
            "ready_pods": ready,
            "num_devices": want * GPUS_PER_POD,
            "status": "READY" if ready >= want else "PENDING",
        }

    # --------------------------------------------- slice-manager surface
    # Duck-typed to ClusterManager (slice_manager.py), so a caller of the
    # slice CRUD can drive either backend — slices of local cards, or
    # GPU-pod Jobs on a cluster — the way the reference's RayClusterManager
    # is itself the servicer (kuberay_cluster_manager.py:10).
    def create_slice(self, name: str, num_devices: int, user_id: str = ""):
        if num_devices <= 0:
            raise ValueError("num_devices must be positive")
        if not self.create_cluster(name, int(num_devices)):
            raise ValueError(f"create of pod job {name!r} failed "
                             "(exists or API error)")

    def modify_slice(self, name: str, num_devices: int):
        if num_devices <= 0:
            raise ValueError("num_devices must be positive")
        if not self.modify_cluster(name, int(num_devices)):
            raise KeyError(f"pod job {name!r} not found or patch failed")

    def delete_slice(self, name: str) -> bool:
        return self.delete_cluster(name)

    def query_slice(self, name: str) -> Optional[Dict[str, Any]]:
        return self.query_cluster(name)
