"""Elastic rescale tour: grow a running task's world from 2 to 4 workers.

A ``torch.distributed`` world is fixed when its process group forms, so
the analogue of the reference's live KubeRay replica patch is
checkpoint-restart elasticity:

    segment over world(2) -> checkpoint -> modify_slice(4) ->
    relaunch world(4) -> restore -> next segment

Each segment is a real multi-process world (one process a rank). The
round's minibatch draws are the whole population's, seeded by (seed,
round), so the rescaled run continues the same training trajectory: the
grown world picks up where the small one checkpointed.

The port of the JAX package's ``examples/elastic_rescale.py``. Its fleet is
the JAX example's 8 devices as 8 rank slots, slot i on card i modulo the
cards (all on the CPU with ``--device cpu``); ranks that share a card talk
over gloo (NCCL refuses two ranks on one card)::

    python -m olearning_sim_tpu_torch.examples.elastic_rescale [--device cpu]
"""

from __future__ import annotations

import json
import tempfile
from typing import List, Optional

from olearning_sim_tpu_torch.examples import _common

SLOTS = 8
WORLDS = (2, 4)
SEGMENT_ROUNDS = 2


def fleet(device) -> list:
    """SLOTS rank slots on ``device``: slot i on card i modulo the cards."""
    import torch

    from olearning_sim_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * SLOTS
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(SLOTS)]


def run(device="cuda") -> dict:
    """The slice's devices before and after, the world of each segment,
    where the largest world runs, and ``overhead_summary()``."""
    from olearning_sim_tpu_torch.clustermgr import ClusterManager, ElasticWorldRunner

    mgr = ClusterManager(devices=fleet(device))
    mgr.create_slice("demo", WORLDS[0], user_id="u1")
    start = mgr.query_slice("demo")["num_devices"]
    world = _common.world_backend(max(WORLDS), device)

    with tempfile.TemporaryDirectory() as ckdir:
        runner = ElasticWorldRunner(
            mgr, "demo", ckdir, segment_rounds=SEGMENT_ROUNDS,
            coordinator_port=_common.free_port(len(WORLDS)),
            platform=world["platform"], backend=world["backend"],
        )
        requested = []

        def controller(segment_idx, completed_rounds):
            if segment_idx == 1:   # the decision lands mid-task
                requested.append(completed_rounds)
                runner.request_rescale(WORLDS[1])

        history = runner.run(total_rounds=SEGMENT_ROUNDS * len(WORLDS),
                             between_segments=controller)
        assert history == list(WORLDS)
        assert mgr.query_slice("demo")["num_devices"] == WORLDS[1]
        summary = runner.overhead_summary()
    return {"start_devices": start, "rescale_after_round": requested[0],
            "history": history, "end_devices": mgr.query_slice("demo")["num_devices"],
            "world": world, "overhead": summary}


def report(result: dict) -> List[str]:
    return [f"slice 'demo': {result['start_devices']} devices",
            _common.world_line(result["world"]),
            f"after round {result['rescale_after_round']}: requesting rescale "
            f"{WORLDS[0]} -> {WORLDS[1]} workers",
            f"world sizes per segment: {result['history']}",
            f"rescale overhead: {result['overhead']['overhead_per_segment_sec']:.1f}s per "
            f"segment (spawn + torch import + dist-init + setup + restore + ckpt)",
            f"overhead_summary: {json.dumps(result['overhead'])}",
            f"ok: task grew {WORLDS[0]} -> {WORLDS[1]} workers mid-flight and completed on "
            f"the same trajectory"]


def main(argv: Optional[list] = None) -> int:
    return _common.cli(run, report, "a task's world grown 2 -> 4 workers mid-flight", argv)


if __name__ == "__main__":
    raise SystemExit(main())
