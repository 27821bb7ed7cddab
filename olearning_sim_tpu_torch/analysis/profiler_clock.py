"""What ``torch.profiler`` keeps of a session's kernels: its host-side
launch records against its device events.

Each kernel's launch (``cudaLaunchKernel``, the driver's ``cuLaunchKernel``
and their Ex forms) is a host record, and the kernel a device event; the
two share a correlation id. Per session this reads how many launch
records and device events the profiler kept, which launches (in launch
order) lost their device event, how long after its launch each kernel
started (``launch_offsets``), and whether every launch record lies inside
its operator's interval (the host clocks agree).

On an H100 with torch 2.11 the launch records were complete in every
session, while the device events of a session's first launches were
dropped, more the older the process, whether the kernels came at once or
0.5 s after the session opened; a kernel's start stayed microseconds after
its launch, so no clock drifted. ``chip_smoke.py`` phase 19 therefore
counts launches from the launch records.

Run on a card (``--seconds`` of sessions, one every ``--every`` seconds,
the card busy with matrix products between them; half-way one session
with a schedule, as phase 10e's profiler opens them)::

    python -m olearning_sim_tpu_torch.analysis.profiler_clock --seconds 300 --every 30
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Dict, List

LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def launch_offsets(events) -> List[int]:
    """Start of each kept kernel minus the start of its launch call, in ns,
    over ``prof.profiler.kineto_results.events()``."""
    from torch.autograd import DeviceType

    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() != DeviceType.CUDA and e.name().startswith(LAUNCH_NAMES)}
    return [e.start_ns() - launches[e.correlation_id()] for e in events
            if e.device_type() == DeviceType.CUDA and e.correlation_id() in launches]


def session(dev, n: int, delay_s: float, work: str = "add") -> Dict:
    """One profiler session that runs ``n`` small operations (``work``:
    "add", one elementwise kernel each, or "matmul", cuBLAS's) ``delay_s``
    after it opens; what it kept of their kernels, and which of the
    launches (in launch order) lost their device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device=dev)
    a = torch.randn((256, 256), device=dev)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if delay_s:
            time.sleep(delay_s)
        for _ in range(n):
            if work == "add":
                x.add_(1)
            else:
                a = a @ a
        torch.cuda.synchronize(dev)
    events = prof.profiler.kineto_results.events()
    kernels = {e.correlation_id() for e in events if e.device_type() == DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset"))}
    launches = sorted(e.correlation_id() for e in events if e.device_type() != DeviceType.CUDA
                      and e.name().startswith(LAUNCH_NAMES))
    lost = [i for i, c in enumerate(launches) if c not in kernels]
    off = launch_offsets(events)
    # The two host clocks: torch's operator events against the launch
    # records, each of which should lie inside its operator's interval.
    ops = sorted((e.start_ns(), e.end_ns()) for e in events if e.name() in ("aten::add_", "aten::mm"))
    starts = [e.start_ns() for e in events if e.device_type() != DeviceType.CUDA
              and e.name().startswith(LAUNCH_NAMES)]
    outside = sum(not any(s <= t <= e for s, e in ops) for t in starts)
    return {"work": work, "ops": n, "delay_s": delay_s, "launch_records": len(launches),
            "kernels_kept": len(kernels), "launches_outside_their_op": outside,
            "lost_positions": [lost[0], lost[-1], len(lost)] if lost else None,
            "offset_ns": {"min": min(off), "median": statistics.median(off), "max": max(off)}
            if off else None}


def busy(dev, seconds: float) -> None:
    """Keep the card busy with matrix products for ``seconds``."""
    import torch

    a = torch.randn((2048, 2048), device=dev)
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(20):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize(dev)


def scheduled_session(dev) -> None:
    """A session with a schedule (wait 1, warm-up 1, active 1), as phase
    10e's profiler opens it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    x = torch.zeros(1, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(3):
            x.add_(1)
            torch.cuda.synchronize(dev)
            prof.step()


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--every", type=float, default=30.0)
    ap.add_argument("--kernels", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_clock: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    scheduled = False
    while True:
        age = time.perf_counter() - t0
        for work, delay in (("add", 0.0), ("add", 0.5), ("matmul", 0.0)):
            row = {"age_s": round(age, 1), **session(dev, args.kernels, delay, work)}
            print(json.dumps(row), flush=True)
        if age >= args.seconds:
            return 0
        if not scheduled and age >= args.seconds / 2:
            scheduled_session(dev)
            scheduled = True
            print(json.dumps({"age_s": round(time.perf_counter() - t0, 1),
                              "scheduled_session": True}), flush=True)
        busy(dev, args.every)


if __name__ == "__main__":
    sys.exit(main())
