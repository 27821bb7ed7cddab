"""Multi-process world bring-up over ``torch.distributed``.

The port of the JAX package's ``clustermgr/launcher.py``. The reference
scales out by submitting Ray jobs to a KubeRay cluster
(``taskMgr/task_runner.py:41-87``); the JAX package joins one process per
host into a ``jax.distributed`` world. The port runs one process per rank,
each driving one device, joined into a ``torch.distributed`` default group
(``parallel/mesh.py`` lays its plans over that group).

Two pieces:

- :func:`initialize_distributed` / :class:`DistributedConfig`: per-process
  world join, configured explicitly or from the ``OLS_*`` environment
  variables (the JAX package's three, plus ``OLS_DIST_BACKEND``), or from
  torchrun's ``env://`` variables with ``OLS_DISTRIBUTED=auto``.
- :class:`MultiHostLauncher`: spawns N local worker processes running a
  target function inside an initialised world — the harness behind the
  multi-process tests and ``chip_smoke.py``'s launches, and a local
  launcher for real multi-process runs.

One device per process: ``cuda:{rank % device_count}`` on the card, the CPU
when asked for. NCCL refuses two ranks on one card, so a world larger than
the number of cards needs gloo, and the caller must name it: nothing here
switches backend on its own.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

PLATFORMS = ("cuda", "cpu")
BACKENDS = ("nccl", "gloo")
# The package's parent: the worker imports the port from there.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_backend(platform: str) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if platform == "cuda" else "gloo"


@dataclasses.dataclass
class DistributedConfig:
    """One process's place in the world. ``coordinator_address`` is
    ``host:port`` of rank 0's TCP store; ``backend`` is ``nccl`` or
    ``gloo`` (empty: NCCL on the card, gloo on the CPU, as
    :func:`local_device` says)."""

    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0
    backend: str = ""

    @staticmethod
    def from_env() -> "DistributedConfig":
        return DistributedConfig(
            coordinator_address=os.environ.get("OLS_COORDINATOR_ADDRESS", ""),
            num_processes=int(os.environ.get("OLS_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("OLS_PROCESS_ID", "0")),
            backend=os.environ.get("OLS_DIST_BACKEND", ""),
        )

    def to_env(self) -> Dict[str, str]:
        env = {
            "OLS_COORDINATOR_ADDRESS": self.coordinator_address,
            "OLS_NUM_PROCESSES": str(self.num_processes),
            "OLS_PROCESS_ID": str(self.process_id),
        }
        if self.backend:
            env["OLS_DIST_BACKEND"] = self.backend
        return env


def local_device():
    """This process's device: ``cuda:{rank % device_count}`` unless the
    launcher asked for the CPU (``OLS_PLATFORM=cpu``)."""
    import torch

    if os.environ.get("OLS_PLATFORM", "cuda") == "cpu":
        return torch.device("cpu")
    rank = int(os.environ.get("OLS_PROCESS_ID", os.environ.get("RANK", "0")))
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def initialize_distributed(cfg: Optional[DistributedConfig] = None) -> DistributedConfig:
    """Join the world (a no-op for a single process with no coordinator).

    With a coordinator address, every process (a world of one included)
    calls ``init_process_group`` over ``tcp://`` on it; on a card it first
    makes its device current. With ``OLS_DISTRIBUTED=auto`` and no address,
    the world comes from torchrun's ``env://`` variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``), the counterpart of the JAX
    package's pod metadata."""
    import torch
    import torch.distributed as dist

    cfg = cfg if cfg is not None else DistributedConfig.from_env()
    auto = os.environ.get("OLS_DISTRIBUTED", "").lower() == "auto"
    if not cfg.coordinator_address and not auto:
        if cfg.num_processes > 1:
            raise ValueError(
                f"a world of {cfg.num_processes} processes needs a coordinator "
                f"address (OLS_COORDINATOR_ADDRESS=host:port)")
        return cfg
    dev = local_device()
    backend = cfg.backend or default_backend(dev.type)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (known: {list(BACKENDS)})")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if cfg.coordinator_address:
        dist.init_process_group(backend, init_method=f"tcp://{cfg.coordinator_address}",
                                world_size=cfg.num_processes, rank=cfg.process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
        cfg = dataclasses.replace(cfg, num_processes=dist.get_world_size(),
                                  process_id=dist.get_rank())
    return dataclasses.replace(cfg, backend=backend)


class MultiHostLauncher:
    """Spawn an N-process world on this machine, one process per rank.

    Each worker runs ``python -m olearning_sim_tpu_torch.clustermgr.worker``
    with a ``--target module:function`` import path; the worker joins the
    world, runs the target, leaves the world, and exits with the target's
    code. ``platform`` is ``cuda`` (one card per rank, ``rank %
    device_count``) or ``cpu``; ``backend`` defaults to NCCL on the card and
    gloo on the CPU. A card shared by two ranks needs ``backend="gloo"``,
    named by the caller (NCCL refuses it)."""

    def __init__(self, num_processes: int, coordinator_port: int = 29400,
                 platform: str = "cuda", backend: Optional[str] = None,
                 devices_per_process: int = 1):
        import torch

        if int(devices_per_process) != 1:
            raise ValueError(
                f"devices_per_process={devices_per_process}: the port runs one device "
                f"per process (one rank per card); launch one process per device")
        if platform not in PLATFORMS:
            raise ValueError(f"unknown platform {platform!r} (known: {list(PLATFORMS)})")
        backend = backend or default_backend(platform)
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (known: {list(BACKENDS)})")
        self.num_processes = int(num_processes)
        if platform == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "platform 'cuda' requested but torch.cuda.is_available() is "
                    "False; pass platform='cpu' to launch on the host")
            cards = torch.cuda.device_count()
            if backend == "nccl" and self.num_processes > cards:
                raise ValueError(
                    f"{self.num_processes} ranks on {cards} card(s): NCCL refuses two "
                    f"ranks on one card; name backend='gloo' to share cards")
        self.coordinator_address = f"127.0.0.1:{coordinator_port}"
        self.platform = platform
        self.backend = backend

    def launch(self, target: str, args: Sequence[str] = (),
               timeout: float = 300.0, extra_env: Optional[Dict[str, str]] = None,
               ) -> List[subprocess.CompletedProcess]:
        """Run ``target`` (``pkg.module:function``) in every process; returns
        the completed processes. Raises, with every worker's output, if any
        worker fails (the others are stopped then) or the deadline passes."""
        procs: List[subprocess.Popen] = []
        outputs: List[List[str]] = []
        readers: List[threading.Thread] = []
        for pid in range(self.num_processes):
            cfg = DistributedConfig(
                coordinator_address=self.coordinator_address,
                num_processes=self.num_processes,
                process_id=pid,
                backend=self.backend,
            )
            env = dict(os.environ)
            env.update(cfg.to_env())
            env["OLS_PLATFORM"] = self.platform
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (_ROOT, env.get("PYTHONPATH", "")) if p)
            # The parent's clock at the spawn, for the worker's spawn time.
            env["OLS_LAUNCH_TIME"] = repr(time.time())  # lint: allow-wall-clock
            if self.platform == "cpu":
                # The launcher owns each CPU worker's threads, as it owns
                # its device: one core per rank.
                env["OMP_NUM_THREADS"] = "1"
            if extra_env:
                env.update(extra_env)
            p = subprocess.Popen(
                [sys.executable, "-m", "olearning_sim_tpu_torch.clustermgr.worker",
                 "--target", target, *args],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            procs.append(p)
            # Drain every worker's pipe concurrently: a worker that logs more
            # than the OS pipe buffer before a collective would otherwise
            # block, deadlocking the whole world.
            buf: List[str] = []
            outputs.append(buf)
            t = threading.Thread(
                target=lambda f=p.stdout, b=buf: b.extend(f), daemon=True
            )
            t.start()
            readers.append(t)

        # Wait for every worker, but stop the world as soon as one fails: the
        # others would wait at their next collective until the deadline.
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        timed_out = time.monotonic() > deadline
        killed = set()
        for pid, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                p.wait()
                killed.add(pid)
        done: List[subprocess.CompletedProcess] = []
        failures: List[str] = []
        for pid, p in enumerate(procs):
            readers[pid].join(timeout=5)
            out = "".join(outputs[pid])
            done.append(subprocess.CompletedProcess(p.args, p.returncode, out, ""))
            if pid in killed:
                why = "timed out" if timed_out else "stopped after another worker failed"
                failures.append(f"worker {pid} {why}\n{out}")
            elif p.returncode != 0:
                failures.append(f"worker {pid} exit {p.returncode}\n{out}")
        if failures:
            raise RuntimeError("multi-process launch failed:\n" + "\n".join(failures))
        return done
