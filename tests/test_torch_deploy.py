"""The port's container image (``deploy/Dockerfile.gpu``) and its platform
Deployment (``deploy/k8s/gpu-platform.yaml``), checked structurally: no
docker daemon or cluster exists here, so every path the image copies and
runs must exist, its tag must be the one the manifests and the Job builder
name, its build step must be the kernel build's own entry point, and the
Deployment must run the port's platform on one GPU with no gRPC port.
``tests/test_k8s_manifests.py`` holds the manifest to the Kubernetes
schemas with the others."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import yaml

from olearning_sim_tpu_torch.clustermgr import k8s_api
from olearning_sim_tpu_torch.ops import _build

import torch_threads  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
DOCKERFILE = REPO / "deploy" / "Dockerfile.gpu"
K8S = REPO / "deploy" / "k8s"
PORT = "olearning_sim_tpu_torch"


def _lines():
    """The Dockerfile's instructions, continuation lines joined."""
    out, cur = [], ""
    for raw in DOCKERFILE.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        cur += line[:-1] + " " if line.endswith("\\") else line
        if not line.endswith("\\"):
            out.append(cur)
            cur = ""
    return out


def _header_tag():
    for line in DOCKERFILE.read_text().splitlines():
        if line.startswith("#") and "REGISTRY/" in line:
            return line.split("`")[1]
    raise AssertionError("Dockerfile.gpu's header names no image tag")


def _copied():
    return [src.rstrip("/") for ln in _lines() if ln.startswith("COPY ")
            for src in ln.split()[1:-1]]


def _port_containers():
    """Every container of deploy/k8s/*.yaml whose command runs the port."""
    out = []
    for path in sorted(K8S.glob("*.yaml")):
        for doc in yaml.safe_load_all(path.read_text()):
            if doc and doc["kind"] in ("Deployment", "Job"):
                for c in doc["spec"]["template"]["spec"]["containers"]:
                    if any(a.startswith(PORT) for a in c.get("command", [])):
                        out.append((path.name, doc, c))
    return out


def test_copy_sources_exist_and_hold_the_port_not_jax():
    copied = _copied()
    assert copied == [PORT, "configs"]
    for src in copied:
        assert (REPO / src).exists(), src
    assert not any(src.split("/")[0] == "olearning_sim_tpu" for src in copied)
    # The kernels' sources come with the package.
    assert sorted((REPO / PORT / "csrc").glob("*.cu"))
    assert all((REPO / PORT / "csrc" / s).exists() for s in _build.sources())


def test_cmd_runs_the_ports_main_on_an_existing_config():
    cmd = json.loads([ln for ln in _lines() if ln.startswith("CMD ")][-1][4:])
    assert cmd[:3] == ["python", "-m", PORT]
    assert (REPO / PORT / "__main__.py").exists()
    cfg = cmd[cmd.index("--config") + 1]
    assert (REPO / cfg).exists() and cfg.split("/")[0] in _copied()
    assert cmd[cmd.index("--device") + 1] == "cuda"
    help_text = subprocess.run([sys.executable, "-m", PORT, "--help"], cwd=REPO,
                               capture_output=True, text=True, timeout=60).stdout
    assert "--config" in help_text and "--device" in help_text


def test_base_image_and_torch_are_cuda_12_8():
    first = _lines()[0]
    assert first.startswith("FROM nvidia/cuda:12.8") and "devel" in first
    pip = " ".join(ln for ln in _lines() if "pip install" in ln)
    assert "torch==2.11.0" in pip and "whl/cu128" in pip
    for dep in ("numpy", "scipy", "pyyaml"):
        assert dep in pip
    assert not any(j in pip for j in ("jax", "flax", "optax"))


def test_header_tag_is_the_builders_and_every_port_manifests_image():
    tag = _header_tag()
    assert tag == k8s_api.DEFAULT_IMAGE == "REGISTRY/olearning-sim-tpu-torch:latest"
    containers = _port_containers()
    assert {name for name, _, _ in containers} == {"gpu-pod-job.yaml", "gpu-platform.yaml"}
    for name, _, c in containers:
        assert c["image"] == tag, name
    built = k8s_api.GpuPodJobBuilder().get_objects()
    job = next(o for o in built if o["kind"] == "Job")
    assert job["spec"]["template"]["spec"]["containers"][0]["image"] == tag


def test_build_step_is_the_kernel_builds_entry_point():
    runs = [ln for ln in _lines() if ln.startswith("RUN ") and "ops._build" in ln]
    assert runs == ["RUN python -m olearning_sim_tpu_torch.ops._build"]
    copies = [i for i, ln in enumerate(_lines()) if ln.startswith("COPY ")]
    assert max(copies) < _lines().index(runs[0])
    assert callable(_build.build_all) and callable(_build.main)
    assert 'if __name__ == "__main__":' in (REPO / PORT / "ops" / "_build.py").read_text()


def test_build_entry_builds_then_finds(tmp_path, monkeypatch, capsys):
    """``python -m ...ops._build`` builds each source once and then finds
    it, at the path ``library_path`` hashes (nvcc stubbed: it is not here)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    built = []

    def fake_build(source):
        lib = _build.library_path(source)[1]
        if not lib.exists():
            lib.write_bytes(b"")
            built.append(source)
        return lib

    monkeypatch.setattr(_build, "build", fake_build)
    assert _build.main() == 0
    first = capsys.readouterr().out.splitlines()
    assert _build.main() == 0
    second = capsys.readouterr().out.splitlines()
    names = _build.sources()
    assert built == names
    for lines, word in ((first, "built"), (second, "found")):
        assert lines == [f"{s} {word} {_build.library_path(s)[1]}" for s in names]


def test_build_entry_fails_without_nvcc(monkeypatch):
    if _build.shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present here")
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_HOME="/nonexistent")
    proc = subprocess.run([sys.executable, "-m", "olearning_sim_tpu_torch.ops._build"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0 and "nvcc not found" in proc.stderr


def test_gpu_platform_runs_the_port_on_one_gpu_without_grpc():
    docs = [d for d in yaml.safe_load_all((K8S / "gpu-platform.yaml").read_text()) if d]
    assert sorted(d["kind"] for d in docs) == ["Deployment", "PersistentVolumeClaim"]
    dep = next(d for d in docs if d["kind"] == "Deployment")
    assert dep["spec"]["replicas"] == 1
    pod = dep["spec"]["template"]["spec"]
    (c,) = pod["containers"]
    assert c["command"] == ["python", "-m", PORT, "--config", "/etc/ols/platform.yaml"]
    assert "--platform" not in c["command"] and "--print-port" not in c["command"]
    assert "ports" not in c
    assert str(c["resources"]["limits"]["nvidia.com/gpu"]) == "1"
    # The JAX platform's ConfigMap, and state on a PVC of its own.
    jax_docs = [d for d in yaml.safe_load_all((K8S / "platform.yaml").read_text()) if d]
    jax_dep = next(d for d in jax_docs if d["kind"] == "Deployment")
    volumes = {v["name"]: v for v in pod["volumes"]}
    jax_volumes = {v["name"]: v for v in jax_dep["spec"]["template"]["spec"]["volumes"]}
    assert volumes["config"] == jax_volumes["config"]
    claim = volumes["state"]["persistentVolumeClaim"]["claimName"]
    pvc = next(d for d in docs if d["kind"] == "PersistentVolumeClaim")
    assert claim == pvc["metadata"]["name"] != \
        jax_volumes["state"]["persistentVolumeClaim"]["claimName"]
    assert dep["metadata"]["name"] != jax_dep["metadata"]["name"]
    mounts = {m["name"]: m["mountPath"] for m in c["volumeMounts"]}
    env = {e["name"]: e for e in c["env"]}
    for name in ("OLS_SQLITE_PATH", "OLS_INTAKE_QUEUE_PATH"):
        assert env[name]["value"].startswith(mounts["state"] + "/")
    for key in ("ENDPOINT", "ACCESS_KEY", "SECRET_KEY", "BUCKET"):
        assert env[f"OLS_STORAGE_{key}"]["valueFrom"]["secretKeyRef"]["name"] == "ols-storage"
    # No Service selects the platform: it serves no gRPC port.
    labels = dep["spec"]["template"]["metadata"]["labels"]
    for path in K8S.glob("*.yaml"):
        for d in yaml.safe_load_all(path.read_text()):
            if d and d["kind"] == "Service":
                assert not d["spec"].get("selector", {}).items() <= labels.items(), path
