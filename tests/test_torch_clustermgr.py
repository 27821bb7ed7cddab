"""The port's multi-process launch: ``DistributedConfig`` and its
environment (the JAX package's variables, and the backend), the launcher's
refusals (two ranks on one card without gloo, more than one device a
process), the worker's exit 2 on a malformed target, a failing worker's
output raised from ``launch``, and each of the seven smoke targets at
world 2 over gloo on the CPU.

The targets run in one world of two spawned workers (a module fixture), in
turn, each reporting its line; the workers import the port and this module,
never JAX, so JAX stays inside test functions here."""

import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from olearning_sim_tpu_torch.clustermgr import (
    DistributedConfig,
    MultiHostLauncher,
    initialize_distributed,
)
from olearning_sim_tpu_torch.clustermgr import targets as tgt

import torch_threads  # noqa: F401

TESTS = str(pathlib.Path(__file__).resolve().parent)
REPO = str(pathlib.Path(TESTS).parent)
# What a worker must never import (the port is torch-only).
FORBIDDEN = {"jax", "flax", "optax", "orbax", "olearning_sim_tpu"}
TARGETS = ("smoke_psum", "smoke_round", "smoke_ditto_checkpoint", "smoke_tp_text",
           "smoke_ring_sp", "smoke_pipeline_pp", "elastic_segment")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    """The workers find this module (a target of the tests) beside the port."""
    return {"PYTHONPATH": os.pathsep.join([REPO, TESTS, os.environ.get("PYTHONPATH", "")])}


# ------------------------------------------------------------ worker targets
def all_targets(ckpt_dir: str) -> int:
    """Every smoke target in turn in one world; each reports its line (a
    failure reports and the next target runs)."""
    os.environ.update(OLS_ELASTIC_CKPT_DIR=ckpt_dir, OLS_ELASTIC_UNTIL="2")
    for name in TARGETS:
        args = ("flash",) if name == "smoke_ring_sp" else ()
        try:
            getattr(tgt, name)(*args)
        except Exception as e:  # noqa: BLE001 — reported to the test
            print(f"{name} FAILED: {type(e).__name__}: {e}", flush=True)
    print("imported:", sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN), flush=True)
    return 0


def fail_on_rank_one() -> int:
    """Rank 0 waits at a barrier; rank 1 says so and raises."""
    import torch.distributed as dist

    print(f"rank {dist.get_rank()} reached the target", flush=True)
    if dist.get_rank() == 1:
        raise RuntimeError("planted failure on rank 1")
    dist.barrier()
    return 0


# ---------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def world_of_two(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("elastic_ckpt")
    launcher = MultiHostLauncher(2, coordinator_port=free_port(), platform="cpu")
    res = launcher.launch("test_torch_clustermgr:all_targets", args=[str(ckpt)],
                          timeout=240, extra_env=_env())
    return [r.stdout for r in res], ckpt


@pytest.mark.parametrize("name", TARGETS)
def test_target_passes_at_world_two_over_gloo(world_of_two, name):
    outputs, ckpt = world_of_two
    for rank, out in enumerate(outputs):
        lines = [ln for ln in out.splitlines() if ln.startswith(f"{name} ")]
        assert lines and lines[-1].startswith(f"{name} ok: world=2"), (rank, out)
    if name == "smoke_ring_sp":
        # On the CPU the ring runs the stats kernel's plain version, and its
        # check against dense fails both wrong kernels put in its place.
        assert "flash=True K2 launches=0" in outputs[0]
        for what in ("key mask dropped", "uniform weights"):
            assert f"smoke_ring_sp with K2's {what}:" in outputs[0]
    if name == "elastic_segment":
        assert (ckpt / "segment_stats" / "segment_r2_w2.json").is_file()


def test_workers_import_no_jax(world_of_two):
    outputs, _ = world_of_two
    assert all("imported: []" in out for out in outputs), outputs


def test_distributed_config_env_round_trip(monkeypatch):
    from olearning_sim_tpu.clustermgr.launcher import DistributedConfig as JConfig

    for backend in ("", "gloo", "nccl"):
        cfg = DistributedConfig("127.0.0.1:29411", num_processes=4, process_id=3,
                                backend=backend)
        env = cfg.to_env()
        for k in ("OLS_COORDINATOR_ADDRESS", "OLS_NUM_PROCESSES", "OLS_PROCESS_ID",
                  "OLS_DIST_BACKEND"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert DistributedConfig.from_env() == cfg
        assert ("OLS_DIST_BACKEND" in env) == bool(backend)
        # The JAX package's three variables, named and written alike.
        jenv = JConfig("127.0.0.1:29411", 4, 3).to_env()
        assert {k: env[k] for k in jenv} == jenv
        assert JConfig.from_env() == JConfig("127.0.0.1:29411", 4, 3)


def test_single_process_joins_nothing_and_a_world_needs_an_address(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("OLS_DISTRIBUTED", raising=False)
    assert initialize_distributed(DistributedConfig()) == DistributedConfig()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs a coordinator address"):
        initialize_distributed(DistributedConfig(num_processes=2))


def test_launcher_refusals(monkeypatch):
    with pytest.raises(ValueError, match="one device per process"):
        MultiHostLauncher(2, platform="cpu", devices_per_process=2)
    with pytest.raises(ValueError, match="unknown backend"):
        MultiHostLauncher(2, platform="cpu", backend="mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="platform='cpu'"):
            MultiHostLauncher(1)
    # One card, two ranks: NCCL refuses, so the caller must name gloo; the
    # launcher never switches on its own.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="name backend='gloo'"):
        MultiHostLauncher(2)
    assert MultiHostLauncher(1).backend == "nccl"
    shared = MultiHostLauncher(2, backend="gloo")
    assert (shared.backend, shared.platform) == ("gloo", "cuda")
    assert MultiHostLauncher(2, platform="cpu").backend == "gloo"


@pytest.mark.parametrize("target", ["no_colon", ":fn", "module:"])
def test_worker_exits_2_on_a_malformed_target(target):
    proc = subprocess.run(
        [sys.executable, "-m", "olearning_sim_tpu_torch.clustermgr.worker",
         "--target", target],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2
    assert "--target must be 'module:function'" in proc.stderr


def test_a_failing_worker_raises_from_launch_with_its_output():
    launcher = MultiHostLauncher(2, coordinator_port=free_port(), platform="cpu")
    with pytest.raises(RuntimeError) as e:
        launcher.launch("test_torch_clustermgr:fail_on_rank_one", timeout=120,
                        extra_env=_env())
    msg = str(e.value)
    # Rank 1's failure and its output; rank 0, left at the barrier, fails
    # with the world or is stopped with it, its output kept too.
    assert "planted failure on rank 1" in msg and "rank 1 reached the target" in msg
    assert "rank 0 reached the target" in msg
    assert "worker 0 " in msg and "worker 1 " in msg
