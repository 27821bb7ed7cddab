"""What the examples share: the command line, and worlds of one process
per rank for the multi-rank ones."""

from __future__ import annotations

import argparse
import json
import socket
from typing import Callable, List, Optional

RESULT_TAG = "example result: "


def cli(run: Callable[..., dict], report: Callable[[dict], List[str]],
        description: str, argv=None) -> int:
    """Parse ``--device``, run the example there and print its lines."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="where the example runs: cuda (the default; fails without a "
                         "card) or cpu")
    args = ap.parse_args(argv)
    for line in report(run(args.device)):
        print(line, flush=True)
    return 0


def free_port(span: int = 1) -> int:
    """A port with ``span`` free ports from it on 127.0.0.1 (an elastic run
    takes one a segment)."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        try:
            for p in range(port + 1, port + span):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
        except OSError:
            continue
        return port


def world_backend(ranks: int, device) -> dict:
    """Where a world of ``ranks`` processes runs: ``platform`` (cuda or
    cpu), the number of ``cards``, and the ``backend``: NCCL where every
    rank has a card of its own, else gloo, which lets ranks share a card
    (NCCL refuses two ranks on one card). ``why`` says which."""
    from olearning_sim_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"ranks": ranks, "platform": "cpu", "cards": 0, "backend": "gloo",
                "why": "gloo on the CPU"}
    import torch

    cards = torch.cuda.device_count()
    if ranks <= cards:
        return {"ranks": ranks, "platform": "cuda", "cards": cards, "backend": "nccl",
                "why": "one card a rank"}
    return {"ranks": ranks, "platform": "cuda", "cards": cards, "backend": "gloo",
            "why": f"{ranks} ranks share {cards} card(s); NCCL refuses two ranks on "
                   f"one card"}


def world_line(world: dict) -> str:
    return (f"world: {world['ranks']} ranks on {world['platform']} "
            f"({world['cards']} card(s)) over {world['backend']}: {world['why']}")


def launch(target: str, ranks: int, device, timeout: float = 600.0) -> dict:
    """Run ``target`` (``module:function``) in a world of ``ranks``
    processes on ``device`` and return the result its rank 0 emitted
    (:func:`emit`), with the world under ``"world"``. Raises if the world
    cannot be formed or any rank fails: it never runs a smaller world."""
    from olearning_sim_tpu_torch.clustermgr.launcher import MultiHostLauncher

    world = world_backend(ranks, device)
    launcher = MultiHostLauncher(ranks, coordinator_port=free_port(),
                                 platform=world["platform"], backend=world["backend"])
    done = launcher.launch(target, timeout=timeout)
    result = parse(done[0].stdout)
    if result is None:
        raise RuntimeError(f"{target}: rank 0 emitted no result:\n{done[0].stdout}")
    result["world"] = world
    return result


def emit(result: dict, rank: int) -> None:
    """A rank's result, printed where :func:`launch` finds it (rank 0's)."""
    if rank == 0:
        print(RESULT_TAG + json.dumps(result), flush=True)


def parse(stdout: str) -> Optional[dict]:
    lines = [ln for ln in stdout.splitlines() if ln.startswith(RESULT_TAG)]
    return json.loads(lines[-1][len(RESULT_TAG):]) if lines else None
