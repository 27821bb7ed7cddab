#!/usr/bin/env python3
"""Device time by runner span, from the two files a
``PerformanceManager`` trace writes.

``PerformanceManager.stop_trace`` writes ``torch_profiler.trace.json``
(the profiler's Chrome trace) and ``runner_spans.trace.json`` (the
tracer's spans) on one time base. Each device event (kernel, copy, fill)
is attributed to the innermost span holding the start of the host runtime
call that issued it (the two share the profiler's ``correlation`` id);
one issued outside every span is unattributed. Only device events whose
host call lies inside the rounds' annotation (:data:`MARK`) are counted,
when the profiler file holds one.

Run anything under ``PerformanceManager.start_trace(<dir>)`` and
``stop_trace()`` (in code, or through the gRPC PerformanceMgr), with the
rounds to count inside a ``torch.profiler.record_function`` named
:data:`MARK` if the trace holds more than them; then::

    python3 scripts/span_device_time.py --logdir <dir>

Prints one JSON line: device ms per round (``round.train.train`` spans in
the file) by span name, the share of the device time under some span, and
the sum of the device events' times against their union (kernels of
several streams overlap).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARK = "span_device_time.rounds"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "(outside every span)"


def device_events(trace_events, mark=None):
    """``(event, host start)`` of each device event in ``trace_events`` (the
    profiler's Chrome events) whose issuing host call is in the file; with
    ``mark``, only those whose host call starts inside an annotation of that
    name, when the file holds one."""
    host = {}
    windows = []
    for e in trace_events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in HOST_CATS and "correlation" in e.get("args", {}):
            host[e["args"]["correlation"]] = e["ts"]
        elif mark is not None and e.get("name") == mark and e.get("cat") == "user_annotation":
            windows.append((e["ts"], e["ts"] + e["dur"]))
    for e in trace_events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t = host.get(e.get("args", {}).get("correlation"))
        if t is not None and not (windows and not any(a <= t <= b for a, b in windows)):
            yield e, t


def attribute(trace_events, span_events, mark=None):
    """``{span name: device us}``: each of :func:`device_events` under the
    innermost span of ``span_events`` that holds its host call's start;
    those issued outside every span under :data:`OUTSIDE`."""
    spans = sorted((s["ts"], s["ts"] + s["dur"], s["name"]) for s in span_events
                   if s.get("ph") == "X")
    starts = [a for a, _, _ in spans]
    out = {}
    for e, t in device_events(trace_events, mark):
        best, width = OUTSIDE, float("inf")
        for a, b, name in spans[:bisect.bisect_right(starts, t)]:
            if a <= t <= b and b - a < width:
                best, width = name, b - a
        out[best] = out.get(best, 0.0) + e["dur"]
    return out


def busy_us(trace_events, mark=None):
    """The union of :func:`device_events`' intervals, in us, and the
    streams they ran on: where kernels of several streams overlap, the
    sum of :func:`attribute` exceeds the union."""
    ivs, streams = [], set()
    for e, _ in device_events(trace_events, mark):
        ivs.append((e["ts"], e["ts"] + e["dur"]))
        streams.add(e.get("args", {}).get("stream"))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(ivs):
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, sorted(streams, key=str)


def read_logdir(logdir, mark=None):
    sys.path.insert(0, REPO)
    from olearning_sim_tpu_torch.performancemgr import PerformanceManager

    with open(os.path.join(logdir, PerformanceManager.TRACE_FILE)) as f:
        trace = json.load(f)["traceEvents"]
    with open(os.path.join(logdir, PerformanceManager.RUNNER_SPAN_FILE)) as f:
        spans = json.load(f)["traceEvents"]
    rounds = sum(s["name"] == "round.train.train" for s in spans) or 1
    us = attribute(trace, spans, mark)
    total = sum(us.values())
    busy, streams = busy_us(trace, mark)
    return {
        "rounds": rounds,
        "device_ms_per_round": {k: v / 1e3 / rounds
                                for k, v in sorted(us.items(), key=lambda kv: -kv[1])},
        "under_a_span": (total - us.get(OUTSIDE, 0.0)) / total if total else None,
        "device_sum_ms_per_round": total / 1e3 / rounds,
        "device_busy_ms_per_round": busy / 1e3 / rounds,
        "streams": streams,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--logdir", required=True,
                    help="a directory a PerformanceManager trace wrote")
    args = ap.parse_args(argv)
    print(json.dumps(read_logdir(args.logdir, MARK)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
