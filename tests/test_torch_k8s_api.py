"""The port's GPU-pod provisioning client (``clustermgr/k8s_api.py``)
against an in-memory fake k8s API server: one counterpart of each test of
``tests/test_k8s_api.py``, which holds the JAX package's TPU-pod client.

No live cluster exists here, so the client is exercised against
:class:`FakeK8s`, the used subset of BatchV1Api/CoreV1Api with real
404/409/422 semantics, plus two drift guards: the builder's output must
equal the committed ``deploy/k8s/gpu-pod-job.yaml`` (data-equal; comments
aside) and must validate against the vendored schemas that
``test_k8s_manifests.py`` applies to every manifest."""

import copy
import json
import os
import sys

import pytest
import yaml

import torch_threads  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_k8s_manifests as manifest_schemas  # noqa: E402

from olearning_sim_tpu_torch.clustermgr.k8s_api import (  # noqa: E402
    ApiError,
    GpuPodJobApi,
    GpuPodJobBuilder,
    K8sClusterManager,
    update_job_parallelism,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(REPO, "deploy", "k8s", "gpu-pod-job.yaml")
NAME = "ols-engine-gpu"


class FakeK8s:
    """In-memory stand-in for the k8s API: one object doubles as the
    BatchV1Api and CoreV1Api subset the client uses. Resources are plain
    dicts keyed (namespace, name); conflict/missing raise :class:`ApiError`
    with the real HTTP statuses."""

    def __init__(self):
        self.jobs = {}
        self.services = {}
        self.calls = []

    def create_namespaced_service(self, namespace, body):
        key = (namespace, body["metadata"]["name"])
        self.calls.append(("create_service", key))
        if key in self.services:
            raise ApiError(409, "service exists")
        self.services[key] = copy.deepcopy(body)
        return self.services[key]

    def delete_namespaced_service(self, name, namespace):
        key = (namespace, name)
        self.calls.append(("delete_service", key))
        if key not in self.services:
            raise ApiError(404, "service not found")
        return self.services.pop(key)

    def create_namespaced_job(self, namespace, body):
        key = (namespace, body["metadata"]["name"])
        self.calls.append(("create_job", key))
        if key in self.jobs:
            raise ApiError(409, "job exists")
        self.jobs[key] = copy.deepcopy(body)
        return self.jobs[key]

    def read_namespaced_job(self, name, namespace):
        key = (namespace, name)
        self.calls.append(("read_job", key))
        if key not in self.jobs:
            raise ApiError(404, "job not found")
        return copy.deepcopy(self.jobs[key])

    def list_namespaced_job(self, namespace, label_selector=""):
        items = [copy.deepcopy(j) for (ns, _), j in self.jobs.items()
                 if ns == namespace]
        if label_selector:
            k, _, v = label_selector.partition("=")
            items = [j for j in items
                     if j["metadata"].get("labels", {}).get(k) == v]
        return {"items": items}

    def patch_namespaced_job(self, name, namespace, body):
        key = (namespace, name)
        self.calls.append(("patch_job", key))
        if key not in self.jobs:
            raise ApiError(404, "job not found")
        # A Job's pod template is immutable on a real API server.
        if "template" in body.get("spec", {}):
            raise ApiError(422, "field is immutable: spec.template")
        job = self.jobs[key]
        for section, val in body.items():
            if section == "spec" and isinstance(val, dict):
                job["spec"].update(copy.deepcopy(val))
            else:
                job[section] = copy.deepcopy(val)
        return copy.deepcopy(job)

    def delete_namespaced_job(self, name, namespace):
        key = (namespace, name)
        self.calls.append(("delete_job", key))
        if key not in self.jobs:
            raise ApiError(404, "job not found")
        return self.jobs.pop(key)

    def set_job_status(self, name, namespace="default", **status):
        self.jobs[(namespace, name)]["status"] = status


@pytest.fixture()
def fake():
    return FakeK8s()


@pytest.fixture()
def api(fake):
    return GpuPodJobApi(batch_api=fake, core_api=fake, sleep_fn=lambda _: None)


@pytest.fixture()
def mgr(api):
    return K8sClusterManager(api)


# --------------------------------------------------------- builder drift
def test_builder_reproduces_committed_manifest():
    with open(MANIFEST) as f:
        committed = [d for d in yaml.safe_load_all(f) if d is not None]
    built = GpuPodJobBuilder().get_objects()  # all defaults == the manifest
    assert {d["kind"]: d for d in built} == {d["kind"]: d for d in committed}


def test_builder_output_passes_manifest_schemas():
    for obj in GpuPodJobBuilder().get_objects():
        key = (obj["apiVersion"], obj["kind"])
        assert key in manifest_schemas.SCHEMAS
        manifest_schemas.jsonschema.validate(obj, manifest_schemas.SCHEMAS[key])


def test_builder_rejects_bad_name_via_succeeded_flag():
    b = GpuPodJobBuilder().build_meta(name="Bad_Name!")
    b.get_objects()
    assert not b.succeeded
    b = GpuPodJobBuilder().build_container(launch_target="no_function")
    b.get_objects()
    assert not b.succeeded


def test_builder_sizes_workers_and_coordinator_env():
    b = (GpuPodJobBuilder()
         .build_meta(name="sim-a", labels={"owner": "t1"})
         .build_workers(pods=8, accelerator="nvidia-a100-80gb")
         .build_container(image="img:1", launch_target="m:fn"))
    service, job = b.get_objects()
    assert b.succeeded
    assert job["spec"]["completions"] == 8
    assert job["spec"]["parallelism"] == 8
    tmpl = job["spec"]["template"]["spec"]
    assert tmpl["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-a100-80gb"}
    container = tmpl["containers"][0]
    assert container["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    assert container["command"] == ["python", "-m", "olearning_sim_tpu_torch.clustermgr.worker",
                                    "--target", "m:fn"]
    env = {e["name"]: e.get("value") for e in container["env"]}
    assert env["OLS_COORDINATOR_ADDRESS"] == "sim-a-0.sim-a:29400"
    assert env["OLS_NUM_PROCESSES"] == "8"
    assert env["OLS_DIST_BACKEND"] == "nccl"
    assert service["spec"]["selector"] == {"job-name": "sim-a"}
    assert job["spec"]["template"]["metadata"]["labels"]["owner"] == "t1"


def test_update_job_parallelism_round_trip():
    job = GpuPodJobBuilder().get_objects()[1]
    patched, ok = update_job_parallelism(job, 16)
    assert ok
    assert patched["spec"]["completions"] == 16
    env = {e["name"]: e.get("value")
           for e in patched["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert env["OLS_NUM_PROCESSES"] == "16"
    assert job["spec"]["completions"] == 4  # original untouched
    _, ok = update_job_parallelism(job, 0)
    assert not ok
    _, ok = update_job_parallelism({"spec": {}}, 4)
    assert not ok


# ------------------------------------------------------------- api CRUD
def test_create_get_delete_round_trip(api, fake):
    objs = GpuPodJobBuilder().get_objects()
    assert api.create_pod_job(objs) is not None
    assert ("default", NAME) in fake.services
    job = api.get_pod_job(NAME)
    assert job["spec"]["completionMode"] == "Indexed"
    # Duplicate create: 409 swallowed into None, nothing clobbered.
    assert api.create_pod_job(objs) is None
    assert api.delete_pod_job(NAME) is not None
    assert fake.jobs == {} and fake.services == {}
    # Already deleted: 404 swallowed into None.
    assert api.delete_pod_job(NAME) is None
    assert api.get_pod_job(NAME) is None


def test_list_pod_jobs_with_label_selector(api):
    for name, owner in [("sim-a", "t1"), ("sim-b", "t2")]:
        objs = (GpuPodJobBuilder()
                .build_meta(name=name, labels={"owner": owner})
                .get_objects())
        assert api.create_pod_job(objs) is not None
    assert len(api.list_pod_jobs()["items"]) == 2
    only = api.list_pod_jobs(label_selector="owner=t2")["items"]
    assert [j["metadata"]["name"] for j in only] == ["sim-b"]


def test_status_polling_and_readiness(api, fake):
    api.create_pod_job(GpuPodJobBuilder().get_objects())
    # No status yet: polling times out cleanly.
    assert api.get_pod_job_status(NAME, timeout=10) is None
    assert not api.wait_until_pod_job_ready(NAME, timeout=10)
    fake.set_job_status(NAME, ready=2, active=4)
    assert api.get_pod_job_status(NAME)["ready"] == 2
    assert not api.wait_until_pod_job_ready(NAME, timeout=10)
    fake.set_job_status(NAME, ready=4, active=4)
    assert api.wait_until_pod_job_ready(NAME, timeout=10)


# ------------------------------------------------------------- manager
def test_manager_create_query_modify_delete(mgr, fake):
    assert mgr.create_cluster("sim-a", pods=4)
    q = mgr.query_cluster("sim-a")
    assert q == {"name": "sim-a", "num_pods": 4, "ready_pods": 0,
                 "num_devices": 4, "status": "PENDING"}
    fake.set_job_status("sim-a", ready=4)
    assert mgr.query_cluster("sim-a")["status"] == "READY"
    # Grow 4 -> 8 pods, patched in place (only the mutable fields).
    assert mgr.modify_cluster("sim-a", pods=8)
    job = fake.jobs[("default", "sim-a")]
    assert job["spec"]["parallelism"] == 8
    assert job["spec"]["completions"] == 8
    assert mgr.query_cluster("sim-a")["num_pods"] == 8
    assert mgr.delete_cluster("sim-a")
    assert mgr.query_cluster("sim-a") is None
    assert not mgr.delete_cluster("sim-a")


def test_manager_rejects_invalid_requests(mgr):
    assert not mgr.modify_cluster("", pods=4)
    assert not mgr.modify_cluster("sim-a", pods=0)
    assert not mgr.create_cluster("Bad_Name!", pods=4)
    # Modify of a job the server never saw: patch 404 -> False.
    assert not mgr.modify_cluster("ghost", pods=4)


def test_slice_surface_over_k8s_backend(mgr, fake):
    """K8sClusterManager duck-types ClusterManager's slice CRUD, so the
    platform session serves it as its slicemgr."""
    from olearning_sim_tpu_torch.services.session import SimulatorSession

    session = SimulatorSession(services=("slicemgr",), cluster_manager=mgr, device="cpu")
    slices = session.cluster_manager
    assert slices is mgr
    slices.create_slice("sim-a", num_devices=3, user_id="u")
    assert fake.jobs[("default", "sim-a")]["spec"]["parallelism"] == 3  # one card a pod
    with pytest.raises(ValueError):
        slices.create_slice("sim-a", num_devices=4)  # duplicate -> 409
    slices.modify_slice("sim-a", num_devices=6)
    parsed = json.loads(json.dumps(slices.query_slice("sim-a")))
    assert parsed["num_pods"] == 6 and parsed["status"] == "PENDING"
    assert parsed["num_devices"] == 6
    with pytest.raises(KeyError):
        slices.modify_slice("ghost", num_devices=2)
    assert slices.delete_slice("sim-a")
    assert slices.query_slice("sim-a") is None


def test_slice_mgr_servicer_over_k8s_backend(mgr, fake):
    """The SliceMgr servicer serves a K8sClusterManager over the wire
    unchanged (``tests/test_k8s_api.py``'s servicer case): a refused
    request (duplicate name -> 409, an unknown slice) comes back a nack."""
    import grpc

    from olearning_sim_tpu_torch.services.grpc_services import SliceMgrClient
    from olearning_sim_tpu_torch.services.session import SimulatorSession

    session = SimulatorSession(services=("slicemgr",), cluster_manager=mgr, device="cpu")
    with session, grpc.insecure_channel(f"127.0.0.1:{session.port}") as ch:
        slices = SliceMgrClient(ch)
        assert slices.create_slice("sim-a", 3, user_id="u") == (True, "")
        assert fake.jobs[("default", "sim-a")]["spec"]["parallelism"] == 3
        ok, _ = slices.create_slice("sim-a", 4)
        assert not ok  # duplicate -> 409 -> ValueError -> nack
        assert slices.modify_slice("sim-a", 6) == (True, "")
        parsed = slices.query_slice("sim-a")
        assert parsed["num_pods"] == 6 and parsed["status"] == "PENDING"
        assert parsed["num_devices"] == 6
        ok, msg = slices.modify_slice("ghost", 2)
        assert not ok and "ghost" in msg
        assert slices.delete_slice("sim-a")
        assert slices.query_slice("sim-a") is None


def test_create_is_idempotent_on_service_conflict(api, fake):
    """A crashed create that got the Service in but not the Job must be
    retryable: the 409 on the Service is tolerated, the Job proceeds."""
    objs = GpuPodJobBuilder().get_objects()
    fake.create_namespaced_service(namespace="default", body=objs[0])
    assert api.create_pod_job(objs) is not None
    assert ("default", NAME) in fake.jobs


def test_gpu_and_tpu_jobs_share_the_coordinator_contract():
    """The port's Job is the JAX package's but for the accelerator, the
    command and the backend: the same Service, Indexed completions, rank
    annotation and coordinator address at the same name."""
    from olearning_sim_tpu.clustermgr.k8s_api import TpuPodJobBuilder

    t_svc, t_job = TpuPodJobBuilder().build_meta(name="same").get_objects()
    g_svc, g_job = GpuPodJobBuilder().build_meta(name="same").get_objects()
    assert g_svc == t_svc
    for key in ("completions", "parallelism", "completionMode"):
        assert g_job["spec"][key] == t_job["spec"][key]
    t_env = {e["name"]: e for e in t_job["spec"]["template"]["spec"]["containers"][0]["env"]}
    g_env = {e["name"]: e for e in g_job["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert {k: g_env[k] for k in t_env} == t_env
    assert g_env["OLS_DIST_BACKEND"] == {"name": "OLS_DIST_BACKEND", "value": "nccl"}


def test_zero_argument_api_needs_the_kubernetes_sdk(monkeypatch):
    """Only the zero-argument constructor imports the SDK: without it the
    import fails there, and the module itself imports nothing of it."""
    import olearning_sim_tpu_torch.clustermgr.k8s_api as k8s

    monkeypatch.setitem(sys.modules, "kubernetes", None)
    with pytest.raises(ImportError):
        GpuPodJobApi()
    assert "kubernetes" not in vars(k8s)
