"""Round-level performance accounting + profiler control.

Metrics of record (BASELINE.md): FL rounds/sec, device-rounds/sec (clients
advanced per wall-second), and per-client local-step latency. Timings are
host wall-clock around the round step (device work is synchronized by the
runner's host transfer of the round loss, so the interval covers real
execution, not async dispatch).

A copy of the JAX package's ``performancemgr/performance_manager.py``. The
profiler is ``torch.profiler`` (host activity, and CUDA kernels on a card)
in place of ``jax.profiler``: a context object, so the manager holds the
open session between :meth:`PerformanceManager.start_trace` and
:meth:`PerformanceManager.stop_trace`, which exports its Chrome trace.
The profiler's session must open and close on one thread (its activity
profiler registers the thread that starts it), while a served manager gets
each call on whichever gRPC handler thread takes it: so the session is
opened, closed and exported on one thread the manager owns, and records
the operators of every thread (the rounds run on the task manager's job
threads, not on the thread that asked for the trace).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

from olearning_sim_tpu_torch.utils.repo import TableRepo

PERF_COLUMNS = ["task_id", "round_idx", "operator", "duration_s",
                "num_clients", "local_steps", "extra"]


def _all_threads_config():
    """A profiler config that records every thread's operators, or None
    where this torch's profiler has no such option (it then records the
    thread that opened the session)."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def _trace_base_ns(path: str) -> int:
    """The ``baseTimeNanoseconds`` in the head of a profiler Chrome trace:
    its ``ts`` values are microseconds after it. A file without one has
    ``ts`` in Unix microseconds, so its base is 0."""
    with open(path, "rb") as f:
        head = f.read(4096)
    m = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    return int(m.group(1)) if m else 0


@dataclasses.dataclass
class RoundTiming:
    task_id: str
    round_idx: int
    operator: str
    duration_s: float
    num_clients: int = 0
    local_steps: int = 0
    # Actual total (client, step) pairs executed; overrides the
    # num_clients * local_steps estimate when heterogeneous compute profiles
    # give clients differing step counts.
    total_client_steps: int = 0
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def device_rounds_per_sec(self) -> float:
        return self.num_clients / self.duration_s if self.duration_s > 0 else 0.0

    @property
    def per_client_step_latency_s(self) -> float:
        """Amortized wall time per (client, local step) — the per-device-step
        cost the reference models as alpha=3.5 s/device-round on CPU actors
        (``utils_runner.py:941``)."""
        steps = self.total_client_steps or self.num_clients * max(self.local_steps, 1)
        return self.duration_s / steps if steps else 0.0


def _mean_step_latency(rows: List["RoundTiming"]) -> float:
    """Mean over client-advancing rows only: eval/custom rows (num_clients=0)
    contribute no steps and must not dilute the metric of record."""
    train_rows = [t for t in rows if t.num_clients > 0]
    if not train_rows:
        return 0.0
    return sum(t.per_client_step_latency_s for t in train_rows) / len(train_rows)


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Linear interpolation between closest ranks (numpy's default): the
    nearest-rank rounding this replaces biased p95 on small samples — 10
    rounds' p95 answered the p100 (max) value."""
    if not sorted_vals:
        return 0.0
    pos = q * (len(sorted_vals) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class PerformanceManager:
    """Records timings, answers performance queries, controls the profiler."""

    def __init__(self, repo: Optional[TableRepo] = None, keep_last: int = 4096,
                 resilience_log=None, registry=None, tracer=None):
        # No repo by default: queries are answered from the bounded in-memory
        # window. Pass a repo to persist every row for external analysis —
        # retention is then the caller's policy (rows are append-only).
        # ``resilience_log`` — the ResilienceLog whose counters get_resilience
        # reports; pass the runner's instance when it is not the process-
        # global default (ResilienceConfig(log=...)).
        # ``registry`` / ``tracer`` — telemetry sinks this manager fronts
        # (None resolves the process defaults): every recorded timing also
        # feeds the live metrics registry, and stop_trace flushes the
        # tracer's runner spans next to the profiler's trace. get_performance
        # answers stay computed from the recorded RoundTiming rows
        # themselves — the façade adds lenses, it never changes the numbers.
        self.repo = repo
        self.keep_last = keep_last
        self.resilience_log = resilience_log
        self.registry = registry
        self.tracer = tracer
        self._lock = threading.RLock()
        self._timings: Dict[str, List[RoundTiming]] = {}
        # task_id -> monotonic time of the last repo rehydration scan: a
        # monitoring loop polling an unknown task must not pay a full-table
        # scan per poll, but rows another process appends later (shared
        # sqlite repo) must still become visible — so misses retry after
        # ``rehydrate_ttl_s`` instead of being cached forever.
        self.rehydrate_ttl_s = 30.0
        self._rehydrate_scans: Dict[str, float] = {}
        self._trace_dir: Optional[str] = None
        self._trace_session = None
        self._trace_span_mark: float = 0.0
        self._profiler_thread = None

    # ------------------------------------------------------------- recording
    def record_round(self, timing: RoundTiming) -> None:
        from olearning_sim_tpu_torch.telemetry import instrument

        instrument(
            "ols_engine_round_duration_seconds", self.registry
        ).labels(task_id=timing.task_id, operator=timing.operator).observe(
            timing.duration_s
        )
        with self._lock:
            rows = self._timings.setdefault(timing.task_id, [])
            rows.append(timing)
            if len(rows) > self.keep_last:
                del rows[: len(rows) - self.keep_last]
            if self.repo is None:
                return
            self.repo.add_item({
                "task_id": [timing.task_id],
                "round_idx": [str(timing.round_idx)],
                "operator": [timing.operator],
                "duration_s": [repr(timing.duration_s)],
                "num_clients": [str(timing.num_clients)],
                "local_steps": [str(timing.local_steps)],
                # total_client_steps rides in the extra JSON (no schema change)
                # so heterogeneous-profile per-client step latency stays
                # recomputable from a persisted repo, not just in memory.
                "extra": [json.dumps(
                    {**timing.extra,
                     "total_client_steps": timing.total_client_steps}
                )],
            })

    class _Timer:
        def __init__(self, mgr: "PerformanceManager", task_id: str,
                     round_idx: int, operator: str, num_clients: int,
                     local_steps: int, total_client_steps: int):
            self._mgr = mgr
            self._args = (task_id, round_idx, operator, num_clients,
                          local_steps, total_client_steps)
            # Values the caller learns mid-round (straggler/drop counts)
            # land in the recorded RoundTiming's extra via note().
            self.extra: Dict[str, float] = {}

        def note(self, **extra: float) -> None:
            """Attach extra key/values to the timing recorded at exit
            (called inside the ``with`` block)."""
            self.extra.update(extra)

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, exc_type, exc, tb):
            if exc_type is None:
                task_id, round_idx, operator, nc, ls, tcs = self._args
                self._mgr.record_round(RoundTiming(
                    task_id=task_id, round_idx=round_idx, operator=operator,
                    duration_s=time.perf_counter() - self._t0,
                    num_clients=nc, local_steps=ls, total_client_steps=tcs,
                    extra=dict(self.extra),
                ))
            return False

    def time_round(self, task_id: str, round_idx: int, operator: str,
                   num_clients: int = 0, local_steps: int = 0,
                   total_client_steps: int = 0) -> "_Timer":
        """``with perf.time_round(...):`` around one operator execution."""
        return PerformanceManager._Timer(
            self, task_id, round_idx, operator, num_clients, local_steps,
            total_client_steps,
        )

    # --------------------------------------------------------------- queries
    def get_resilience(self, task_id: str) -> Dict[str, int]:
        """Resilience counters for one task (retries, rollbacks, quarantines,
        injected faults — olearning_sim_tpu_torch.resilience.events). Part of the
        performance answer so robustness regressions ride the same query as
        throughput regressions."""
        log = self.resilience_log
        if log is None:
            from olearning_sim_tpu_torch.resilience.events import global_log

            log = global_log()
        return log.counters(task_id)

    def _rehydrate(self, task_id: str) -> List[RoundTiming]:
        """Rebuild a task's RoundTiming window from the persisted repo (a
        restarted manager constructed over the same TableRepo must answer
        for completed tasks, not ``rounds_recorded: 0``). Unparseable rows
        are skipped — one corrupt row must not hide the rest."""
        if self.repo is None:
            return []
        # Scan fully under the lock: a concurrent get_performance for the
        # same task must wait and see the restored window, not race past a
        # pre-stamped TTL and answer rounds_recorded: 0 mid-scan.
        with self._lock:
            rows = self._timings.get(task_id)
            if rows:
                return list(rows)
            now = time.monotonic()
            last = self._rehydrate_scans.get(task_id)
            if last is not None and now - last < self.rehydrate_ttl_s:
                return []
            if len(self._rehydrate_scans) > 4096:
                # Bound the stamp map: keep the freshest half (a monitoring
                # loop cycling through many dead ids must not grow it
                # forever).
                for tid, _ in sorted(self._rehydrate_scans.items(),
                                     key=lambda kv: kv[1])[:2048]:
                    del self._rehydrate_scans[tid]
            restored: List[RoundTiming] = []
            for row in self.repo.query_all():
                if row.get("task_id") != task_id:
                    continue
                try:
                    extra = json.loads(row.get("extra") or "{}")
                    restored.append(RoundTiming(
                        task_id=task_id,
                        round_idx=int(row.get("round_idx") or 0),
                        operator=row.get("operator") or "",
                        duration_s=float(row.get("duration_s") or 0.0),
                        num_clients=int(row.get("num_clients") or 0),
                        local_steps=int(row.get("local_steps") or 0),
                        total_client_steps=int(
                            extra.pop("total_client_steps", 0) or 0
                        ),
                        extra={k: v for k, v in extra.items()},
                    ))
                except (TypeError, ValueError):
                    continue
            self._rehydrate_scans[task_id] = time.monotonic()
            if restored:
                window = self._timings.setdefault(task_id, [])
                window.extend(restored[-self.keep_last:])
                restored = list(window)
            return restored

    def get_performance(self, task_id: str) -> Dict[str, Any]:
        """Summary for one task: throughput + latency distribution
        (the ``PerformanceMgr.getPerformance`` answer)."""
        resilience = self.get_resilience(task_id)
        with self._lock:
            rows = list(self._timings.get(task_id, []))
        if not rows:
            rows = self._rehydrate(task_id)
        if not rows:
            return {"task_id": task_id, "rounds_recorded": 0,
                    "resilience": resilience}
        # Convergence-tracker eval rows feed ONLY the convergence block:
        # they are synthetic observability rows, and counting them in the
        # throughput aggregates would make the same workload report
        # different round_time_s / rounds_per_sec with tracking on vs
        # off (breaking comparability with every banked number).
        timing_rows = [t for t in rows if t.operator != "convergence_eval"]
        if not timing_rows:
            timing_rows = rows
        durations = sorted(t.duration_s for t in timing_rows)
        total_time = sum(durations)
        total_clients = sum(t.num_clients for t in timing_rows)
        distinct_rounds = len({t.round_idx for t in timing_rows})

        def _convergence() -> Optional[Dict[str, Any]]:
            # Quality series from the runner's convergence_eval timing
            # rows (one per tracker eval point; extras carry the
            # accuracy/clock scalars). Dedup by round, last row wins —
            # a rolled-back round's replay re-records its eval point.
            latest: Dict[int, RoundTiming] = {}
            for t in rows:
                if t.operator == "convergence_eval":
                    latest[t.round_idx] = t
            if not latest:
                return None
            series = [
                {"round": r, "acc": t.extra.get("eval_acc"),
                 "loss": t.extra.get("eval_loss"),
                 "sim_s": t.extra.get("sim_s"),
                 "wall_s": t.extra.get("wall_s")}
                for r, t in sorted(latest.items())
            ]
            newest = latest[max(latest)]
            accs = [p["acc"] for p in series if p["acc"] is not None]
            out: Dict[str, Any] = {
                "evals": len(series),
                "final_accuracy": accs[-1] if accs else None,
                "best_accuracy": max(accs) if accs else None,
                "reached": bool(newest.extra.get("reached")),
                "series": series,
            }
            for src, dst in (("target", "target_accuracy"),
                             ("rounds_to_target", "rounds_to_target"),
                             ("sim_s_to_target", "sim_seconds_to_target"),
                             ("wall_s_to_target", "wall_seconds_to_target")):
                if src in newest.extra:
                    out[dst] = newest.extra[src]
            return out

        def _extra_total(key: str) -> int:
            # Dedup by (round, operator), last row wins: a rolled-back round
            # that replays records a second timing row for the same round,
            # and summing both would double-count its stragglers/drops.
            latest: Dict[Any, RoundTiming] = {}
            for t in timing_rows:
                latest[(t.round_idx, t.operator)] = t
            return sum(int(t.extra.get(key, 0) or 0)
                       for t in latest.values())

        return {
            "task_id": task_id,
            "rounds_recorded": distinct_rounds,
            "operator_executions": len(timing_rows),
            "total_time_s": total_time,
            "rounds_per_sec": distinct_rounds / total_time if total_time else 0.0,
            "device_rounds_per_sec": total_clients / total_time if total_time else 0.0,
            "round_time_s": {
                "mean": total_time / len(durations),
                "p50": _percentile(durations, 0.50),
                "p95": _percentile(durations, 0.95),
                "max": durations[-1],
            },
            "per_client_step_latency_s": _mean_step_latency(timing_rows),
            # Deadline-aware rounds: clients that missed the round deadline
            # (stragglers) reported distinctly from trace-level drops.
            "stragglers_total": _extra_total("stragglers"),
            "dropped_total": _extra_total("dropped"),
            # Adversarial-client defense: in-jit clip count, anomaly flags,
            # and injected-attack totals (docs/resilience.md).
            "defense": {
                "clipped_total": _extra_total("clipped"),
                "flagged_total": _extra_total("flagged"),
                "attacked_total": _extra_total("attacked"),
            },
            # Time-to-accuracy: the convergence tracker's quality series
            # and to-target facts (None when tracking is off for the
            # task) — docs/performance.md "Time-to-accuracy benching".
            "convergence": _convergence(),
            "resilience": resilience,
        }

    def list_tasks(self) -> List[str]:
        with self._lock:
            return sorted(self._timings)

    # --------------------------------------------------------------- metrics
    def render_metrics(self, fmt: str = "prometheus") -> str:
        """The live metrics registry rendered for transport: Prometheus
        text exposition (default) or a JSON snapshot — the body of the
        PerformanceMgr ``getMetrics`` RPC."""
        from olearning_sim_tpu_torch.telemetry import render_prometheus, snapshot

        if fmt in ("json", "snapshot"):
            return json.dumps(snapshot(self.registry))
        return render_prometheus(self.registry)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Dict form of the registry (bench.py artifacts)."""
        from olearning_sim_tpu_torch.telemetry import snapshot

        return snapshot(self.registry)

    # -------------------------------------------------------------- profiler
    TRACE_FILE = "torch_profiler.trace.json"
    RUNNER_SPAN_FILE = "runner_spans.trace.json"

    def _on_profiler_thread(self, fn):
        """``fn()`` run on the manager's profiler thread; its result or
        exception returned or raised here."""
        if self._profiler_thread is None:
            from concurrent.futures import ThreadPoolExecutor

            self._profiler_thread = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="torch-profiler")
        return self._profiler_thread.submit(fn).result()

    def start_trace(self, logdir: str) -> bool:
        """Begin a ``torch.profiler`` trace (host ops, and CUDA kernels when
        a card is present) written to ``logdir`` at :meth:`stop_trace`. One
        trace at a time. A start that raises (unwritable logdir, a profiler
        session already open elsewhere) leaves this manager armed for the
        next attempt instead of wedged "in a trace" forever."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from olearning_sim_tpu_torch.telemetry import default_tracer

        with self._lock:
            if self._trace_dir is not None:
                return False
            tracer = self.tracer if self.tracer is not None else \
                default_tracer()
            # Spans before this watermark belong to earlier rounds/traces
            # and have no counterpart in the capture starting now.
            self._trace_span_mark = tracer.now()
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            session = profile(activities=activities,
                              experimental_config=_all_threads_config())
            try:
                os.makedirs(logdir, exist_ok=True)
                self._on_profiler_thread(session.__enter__)
            except BaseException:
                # The profiler may have half-opened its session before
                # failing; close it so the retry doesn't hit "already
                # started".
                self._trace_dir = None
                with contextlib.suppress(Exception):
                    self._on_profiler_thread(lambda: session.__exit__(None, None, None))
                raise
            self._trace_session = session
            self._trace_dir = logdir
            return True

    def stop_trace(self) -> Optional[str]:
        """End the trace: the profiler's Chrome trace goes to
        ``<logdir>/torch_profiler.trace.json`` and the runner spans of the
        window to ``<logdir>/runner_spans.trace.json``, each ``ts`` on the
        profiler file's time base (microseconds after its
        ``baseTimeNanoseconds``), so the two overlay; returns ``logdir``
        (None when no trace is open)."""
        with self._lock:
            if self._trace_dir is None:
                return None
            session, self._trace_session = self._trace_session, None
            out, self._trace_dir = self._trace_dir, None

            def close():
                session.__exit__(None, None, None)
                session.export_chrome_trace(os.path.join(out, self.TRACE_FILE))

            self._on_profiler_thread(close)
        # Flush the runner-level spans as Perfetto trace_event JSON next to
        # the profiler's trace, on its time base, so one directory opens
        # both timelines and they overlay. Best-effort: span export must
        # never turn a successful capture into an error.
        from olearning_sim_tpu_torch.telemetry import default_tracer

        tracer = self.tracer if self.tracer is not None else default_tracer()
        with contextlib.suppress(Exception):
            tracer.export(os.path.join(out, self.RUNNER_SPAN_FILE),
                          since_s=self._trace_span_mark,
                          base_ns=_trace_base_ns(os.path.join(out, self.TRACE_FILE)))
        return out
