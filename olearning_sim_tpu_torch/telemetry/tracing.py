"""Span tracer: causal, parent-linked wall-clock spans.

``torch.profiler`` answers "what did the card do" at kernel granularity;
this module answers "what did the *runner* do" — which round, which
operator, which phase — at host granularity. Both export to the Chrome
``trace_event`` JSON format, so a runner-span file opens in
Perfetto/chrome://tracing beside the profiler's timeline (and
``PerformanceManager.stop_trace`` writes one beside every captured trace,
on the profiler file's time base: :meth:`SpanTracer.unix_ns` puts a span
on the profiler's clock, Unix nanoseconds). A copy of the JAX package's
``telemetry/tracing.py``, with that conversion added.

Usage::

    tracer = SpanTracer()            # or default_tracer()
    with tracer.span("round.train", round_idx=3, operator="train"):
        ...                          # nested spans parent-link automatically

Spans carry monotonic wall-clock durations, a per-tracer span id, the
enclosing span's id (``parent_id``), and free-form attributes. Nesting is
tracked per thread (a ``threading.local`` stack: spans never cross
threads).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Span:
    name: str
    span_id: int
    parent_id: Optional[int]
    start_s: float          # monotonic start (tracer epoch-relative)
    duration_s: float = 0.0
    thread_id: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_trace_event(self, offset_us: float = 0.0) -> Dict[str, Any]:
        """Chrome trace_event complete-event (``ph: X``) form; timestamps in
        microseconds per the spec, ``offset_us`` added to the start."""
        args = {k: v for k, v in self.attrs.items()}
        args["span_id"] = self.span_id
        if self.parent_id is not None:
            args["parent_id"] = self.parent_id
        return {
            "name": self.name,
            "ph": "X",
            "cat": "runner",
            "ts": round(self.start_s * 1e6 + offset_us, 3),
            "dur": round(self.duration_s * 1e6, 3),
            "pid": os.getpid(),
            "tid": self.thread_id,
            "args": args,
        }


class _ActiveSpan:
    def __init__(self, tracer: "SpanTracer", span: Span):
        self._tracer = tracer
        self.span = span
        self._t0 = 0.0

    def __enter__(self) -> Span:
        self._t0 = time.perf_counter()
        self._tracer._stack().append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        self.span.duration_s = time.perf_counter() - self._t0
        if exc_type is not None:
            self.span.attrs["error"] = f"{exc_type.__name__}: {str(exc)[:200]}"
        stack = self._tracer._stack()
        if stack and stack[-1] is self.span:
            stack.pop()
        self._tracer._finish(self.span)
        return False


class _NullSpanCtx:
    """Returned by a disabled tracer: zero bookkeeping, reusable."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullSpanCtx()


class SpanTracer:
    """Thread-safe span recorder with a bounded finished-span window.

    ``keep_last`` bounds memory for long runs (structured forensics keep the
    tail; exported files should be flushed per run/trace window anyway).
    """

    def __init__(self, keep_last: int = 65536, enabled: bool = True):
        self.keep_last = keep_last
        self.enabled = enabled
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: List[Span] = []
        self._next_id = 1
        self._epoch = time.perf_counter()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs: Any):
        """``with tracer.span("round.train", round_idx=3): ...`` — opens a
        span parented to the innermost open span on this thread."""
        if not self.enabled:
            return _NULL_CTX
        stack = self._stack()
        parent = stack[-1].span_id if stack else None
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        return _ActiveSpan(self, Span(
            name=name, span_id=span_id, parent_id=parent,
            start_s=time.perf_counter() - self._epoch,
            thread_id=threading.get_ident() & 0x7FFFFFFF,
            attrs=dict(attrs),
        ))

    def _finish(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            if len(self._spans) > self.keep_last:
                del self._spans[: len(self._spans) - self.keep_last]

    # ---------------------------------------------------------------- reads
    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def now(self) -> float:
        """Tracer-relative clock (same scale as ``Span.start_s``) — a
        watermark for windowed exports."""
        return time.perf_counter() - self._epoch

    def unix_ns(self, t: float) -> int:
        """Tracer time ``t`` (the scale of :meth:`now`) on the profiler's
        clock: Unix nanoseconds. The two clocks are paired afresh on each
        call, so the wall clock's adjustments since the tracer's start do
        not shift the answer."""
        pc, wall = time.perf_counter_ns(), time.time_ns()
        return wall - pc + round((self._epoch + t) * 1e9)

    # --------------------------------------------------------------- export
    def to_trace_events(
        self, since_s: Optional[float] = None, base_ns: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        """``since_s`` (tracer-relative, from :meth:`now`) limits the export
        to spans started after the watermark — e.g. only the spans inside
        one profiler window, not the whole process history. ``base_ns``
        (Unix nanoseconds: a profiler file's ``baseTimeNanoseconds``) puts
        each ``ts`` on that file's time base, microseconds after it;
        without it ``ts`` is microseconds after the tracer's start."""
        offset_us = 0.0 if base_ns is None else (self.unix_ns(0.0) - base_ns) / 1e3
        return [
            s.to_trace_event(offset_us) for s in self.spans()
            if since_s is None or s.start_s >= since_s
        ]

    def to_perfetto_json(self, since_s: Optional[float] = None,
                         base_ns: Optional[int] = None) -> str:
        """Chrome/Perfetto ``trace_event`` JSON (object form with
        ``traceEvents``, the shape both UIs accept)."""
        return json.dumps({
            "traceEvents": self.to_trace_events(since_s, base_ns),
            "displayTimeUnit": "ms",
        })

    def export(self, path: str, since_s: Optional[float] = None,
               base_ns: Optional[int] = None) -> str:
        """Write the Perfetto JSON next to (typically) a profiler trace;
        returns ``path``. Parent directories are created."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_perfetto_json(since_s, base_ns))
        return path


_DEFAULT = SpanTracer()


def default_tracer() -> SpanTracer:
    """The process-wide tracer (what instrumented modules use when no tracer
    is injected)."""
    return _DEFAULT


def set_default_tracer(tracer: SpanTracer) -> SpanTracer:
    global _DEFAULT
    old, _DEFAULT = _DEFAULT, tracer
    return old
