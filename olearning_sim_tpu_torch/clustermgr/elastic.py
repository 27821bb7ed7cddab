"""Elastic rescale of a running multi-process training world.

The port of the JAX package's ``clustermgr/elastic.py``. The reference
(``rayclusterMgr/kuberay_cluster_manager.py:112-162``) patches worker-group
replicas on a live KubeRay cluster and Ray reschedules actors onto the new
pods. A ``torch.distributed`` world cannot change size in place — its
process groups are fixed at ``init_process_group`` — so, as in the JAX
package, elasticity is **checkpoint-restart**:

    segment over world(N) -> checkpoint -> modify_slice(N') ->
    relaunch world(N') -> restore -> next segment

FedCore makes the handoff exact: the minibatch draws are the whole
population's, seeded by (seed, round), and aggregation is weight-based, so
the SAME logical population resharded over a different ``dp`` continues
the SAME training trajectory up to summation order (held against an
uninterrupted run in ``tests/test_torch_elastic.py``).

:class:`ElasticWorldRunner` drives the loop over a
:class:`~olearning_sim_tpu_torch.clustermgr.slice_manager.ClusterManager`
slice; each segment is a
:class:`~olearning_sim_tpu_torch.clustermgr.launcher.MultiHostLauncher`
target (one process per rank) that restores, advances to the segment's
last round and checkpoints.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, List, Optional

from olearning_sim_tpu_torch.clustermgr.launcher import MultiHostLauncher
from olearning_sim_tpu_torch.clustermgr.slice_manager import ClusterManager

# What a segment pays besides its steady rounds, from its rank 0's stats.
OVERHEAD_KEYS = ("spawn_sec", "import_sec", "init_sec", "setup_sec", "restore_sec",
                 "first_round_incl_compile_sec", "checkpoint_sec")
# And what explains some of them: the step's size on disk, and the modules
# the target imported up to the end of its first round.
SIZE_KEYS = ("checkpoint_bytes", "modules_imported")


class ElasticWorldRunner:
    """Run a training task across world-size changes of its slice.

    ``request_rescale(n)`` may be called at any time (any thread); it
    patches the slice via :meth:`ClusterManager.modify_slice` and the new
    size takes effect at the next segment boundary — the reschedule
    semantics of the reference's live replica patch, with the checkpoint as
    the migration vehicle. ``platform`` and ``backend`` are the launcher's
    (one rank per card on ``cuda``; a world larger than the cards needs
    ``backend="gloo"``, named by the caller).
    """

    def __init__(
        self,
        cluster_mgr: ClusterManager,
        slice_name: str,
        ckpt_dir: str,
        target: str = "olearning_sim_tpu_torch.clustermgr.targets:elastic_segment",
        segment_rounds: int = 2,
        coordinator_port: int = 29450,
        segment_timeout: float = 600.0,
        platform: str = "cuda",
        backend: Optional[str] = None,
    ):
        self.cluster_mgr = cluster_mgr
        self.slice_name = slice_name
        self.ckpt_dir = ckpt_dir
        self.target = target
        if int(segment_rounds) < 1:
            raise ValueError(
                f"segment_rounds must be >= 1 (got {segment_rounds}); a "
                f"zero-round segment would relaunch worlds forever"
            )
        self.segment_rounds = int(segment_rounds)
        self.coordinator_port = int(coordinator_port)
        self.segment_timeout = segment_timeout
        self.platform = platform
        self.backend = backend
        self.world_history: List[int] = []  # world size per executed segment
        # Per-segment rescale cost: the whole relaunch's wall time (this
        # process's view) and the child's phase breakdown (written by its
        # rank 0 into <ckpt_dir>/segment_stats).
        self.segment_stats: List[dict] = []
        self._lock = threading.Lock()

    def request_rescale(self, num_devices: int) -> None:
        """Grow/shrink the running task's slice; applied next segment."""
        with self._lock:
            self.cluster_mgr.modify_slice(self.slice_name, num_devices)

    def _world_size(self) -> int:
        info = self.cluster_mgr.query_slice(self.slice_name)
        if info is None:
            raise KeyError(f"slice {self.slice_name!r} not found")
        return int(info["num_devices"])

    def run(
        self,
        total_rounds: int,
        extra_env: Optional[dict] = None,
        between_segments: Optional[Callable[[int, int], None]] = None,
    ) -> List[int]:
        """Advance the task to ``total_rounds``, re-reading the slice size
        at every segment boundary. ``between_segments(segment_idx,
        completed_rounds)`` runs after each segment (a test hook, or where a
        controller decides to rescale). Returns ``world_history``."""
        done = 0
        segment = 0
        while done < total_rounds:
            world = self._world_size()
            until = min(done + self.segment_rounds, total_rounds)
            launcher = MultiHostLauncher(
                num_processes=world,
                # A fresh port per segment: the previous store's socket may
                # still be in TIME_WAIT.
                coordinator_port=self.coordinator_port + segment,
                platform=self.platform,
                backend=self.backend,
            )
            env = {
                "OLS_ELASTIC_CKPT_DIR": self.ckpt_dir,
                "OLS_ELASTIC_UNTIL": str(until),
                **(extra_env or {}),
            }
            t0 = time.perf_counter()
            launcher.launch(self.target, timeout=self.segment_timeout,
                            extra_env=env)
            wall = time.perf_counter() - t0
            self.world_history.append(world)
            self.segment_stats.append({
                "segment": segment,
                "world": world,
                "rounds": until - done,
                "launch_wall_sec": round(wall, 3),
                "child": self._read_child_stats(until, world),
            })
            done = until
            segment += 1
            if between_segments is not None and done < total_rounds:
                between_segments(segment, done)
        return self.world_history

    def _read_child_stats(self, until: int, world: int) -> Optional[dict]:
        path = os.path.join(self.ckpt_dir, "segment_stats",
                            f"segment_r{until}_w{world}.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def overhead_summary(self) -> dict:
        """Elasticity overhead across executed segments.

        ``overhead`` = launch wall minus the child's STEADY-STATE training
        time (steady_round_sec x rounds) — process spawn, importing torch,
        joining the world, restore, the first round and the checkpoint,
        everything the reference's in-place patch does not pay.
        ``per_segment`` breaks each segment's launch into those parts, as
        its rank 0 measured them."""
        total_wall = sum(s["launch_wall_sec"] for s in self.segment_stats)
        train = sum(
            (s["child"] or {}).get("steady_round_sec", 0.0)
            * (s["child"] or {}).get("rounds", 0)
            for s in self.segment_stats
        )
        have_child = [s for s in self.segment_stats if s["child"]]
        return {
            "segments": len(self.segment_stats),
            "total_wall_sec": round(total_wall, 3),
            "train_sec": round(train, 3),
            "overhead_sec": round(total_wall - train, 3),
            "overhead_per_segment_sec": round(
                (total_wall - train) / max(len(self.segment_stats), 1), 3
            ),
            "child_stats_found": len(have_child),
            "per_segment": [
                {"segment": s["segment"], "world": s["world"],
                 "launch_wall_sec": s["launch_wall_sec"],
                 **{k: s["child"].get(k) for k in OVERHEAD_KEYS + SIZE_KEYS}}
                for s in have_child
            ],
        }
