"""Worker entry point for :class:`~olearning_sim_tpu_torch.clustermgr.launcher.MultiHostLauncher`.

``python -m olearning_sim_tpu_torch.clustermgr.worker --target pkg.module:function``
joins the ``torch.distributed`` world the ``OLS_*`` environment variables
describe (``OLS_COORDINATOR_ADDRESS``, ``OLS_NUM_PROCESSES``,
``OLS_PROCESS_ID``, ``OLS_DIST_BACKEND``; ``OLS_PLATFORM=cpu`` for the CPU),
calls ``function()`` (it receives any remaining command-line arguments),
leaves the world and exits with the function's code (0 for a result that is
not an int). A malformed target exits 2 before joining. The reference
analogue is the Ray job entry point ``python3 run_task.py --task '<json>'``
(``task_runner.py:44``).

:data:`TIMES` holds this process's costs of a launch, in seconds: the
spawn (from the launcher's ``OLS_LAUNCH_TIME`` to this module's start),
importing torch, and joining the world; targets report them.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time
from typing import Dict

TIMES: Dict[str, float] = {}


def main(argv=None) -> int:
    TIMES["started"] = time.time()  # lint: allow-wall-clock
    parser = argparse.ArgumentParser(
        prog="python -m olearning_sim_tpu_torch.clustermgr.worker")
    parser.add_argument("--target", required=True,
                        help="import path 'pkg.module:function'")
    args, rest = parser.parse_known_args(argv)
    mod_name, _, fn_name = args.target.partition(":")
    if not (mod_name and fn_name):
        print(f"--target must be 'module:function', got {args.target!r}",
              file=sys.stderr)
        return 2
    if os.environ.get("OLS_LAUNCH_TIME"):
        TIMES["spawn_s"] = TIMES["started"] - float(os.environ["OLS_LAUNCH_TIME"])
    t0 = time.perf_counter()
    import torch.distributed as dist

    from olearning_sim_tpu_torch.clustermgr.launcher import initialize_distributed

    TIMES["import_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    initialize_distributed()
    TIMES["init_s"] = time.perf_counter() - t0
    try:
        fn = getattr(importlib.import_module(mod_name), fn_name)
        result = fn(*rest)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return int(result) if isinstance(result, int) else 0


if __name__ == "__main__":
    # Targets import this module by name to read TIMES: let them find this
    # one, not a second copy.
    sys.modules.setdefault("olearning_sim_tpu_torch.clustermgr.worker", sys.modules[__name__])
    sys.exit(main())
