#!/usr/bin/env python3
"""Peak device memory of the DistilBERT task against its block of clients.

Runs ``configs/fedadam_sent140_distilbert.json`` at full width (768/12/6/3072,
vocab 30522, L 64) through the PyTorch port's task bridge and runner, as
``chip_smoke.py`` phase 8d does (clients cut to ``--clients``, rounds to
``--rounds``), once for each ``block_clients`` in ``--blocks``. Each block
size runs in a process of its own on a card that holds nothing else, so a
block that runs the card out of memory leaves the others' numbers as they
are. Prints one JSON line per block::

    {"block": B, "ok": true, "peak_allocated_gib": x, "peak_reserved_gib": x,
     "seconds": t}

or ``"ok": false`` with the out-of-memory message, then the card's name and
power limit.

Usage::

    python3 scripts/task_path_memory.py [--blocks 16 32 64] [--clients 64] [--rounds 1]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = "fedadam_sent140_distilbert"


def one_block(block: int, clients: int, rounds: int) -> dict:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the allocator's statistics exist once CUDA is up
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"block": block, "clients": clients}
    t0 = time.perf_counter()
    try:
        chip_smoke.run_task(f"block {block}", CONFIG, dev, rounds, clients=clients,
                            edit=chip_smoke.block_edit(block))
    except torch.OutOfMemoryError as e:
        out.update(ok=False, error=str(e).split(". If reserved")[0])
    else:
        out["ok"] = True
    out["seconds"] = time.perf_counter() - t0
    out["peak_allocated_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["peak_reserved_gib"] = torch.cuda.max_memory_reserved(dev) / 2**30
    out["card_total_gib"] = torch.cuda.get_device_properties(dev).total_memory / 2**30
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, nargs="+", default=[16, 32, 64])
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print("RESULT " + json.dumps(one_block(args.child, args.clients, args.rounds)),
              flush=True)
        return 0
    results = []
    for block in args.blocks:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(block), "--clients", str(args.clients),
             "--rounds", str(args.rounds)],
            capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        for ln in proc.stdout.splitlines():
            if not ln.startswith("RESULT "):
                print(f"  {ln}", flush=True)
        if proc.returncode != 0 or not lines:
            print(f"block {block}: child exited {proc.returncode}", flush=True)
            return 1
        results.append(json.loads(lines[0][len("RESULT "):]))
        print(json.dumps(results[-1]), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
