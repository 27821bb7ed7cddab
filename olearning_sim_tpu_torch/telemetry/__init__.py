"""Telemetry: metrics registry and span tracing, standard library only.

- :mod:`telemetry.metrics` — thread-safe ``Counter`` / ``Gauge`` /
  ``Histogram`` behind a :class:`MetricsRegistry` (process default +
  injectable instances);
- :mod:`telemetry.tracing` — :class:`SpanTracer` producing parent-linked
  wall-clock spans exportable as Chrome/Perfetto ``trace_event`` JSON;
- :mod:`telemetry.exporters` — Prometheus text exposition
  (:func:`render_prometheus`), JSON snapshots (:func:`snapshot` /
  :func:`dump_json`) and a stdlib scrape endpoint
  (:class:`MetricsHTTPServer`).

Copies of the JAX package's modules of the same names. :data:`CATALOG`
holds the entries of the JAX package's catalog that the port's modules
instrument, each identical there and here in kind, help, labels and
buckets, so that both packages' runners write the same series. A registry
passed in (``registry=``) is used duck-typed: the JAX package's
``MetricsRegistry`` works here, and a control plane that owns one sees a
port runner's series beside a JAX runner's. The process defaults, though,
are the port's own.

Set ``OLS_TELEMETRY=0`` in the environment to start the process with the
default registry and tracer disabled.
"""

from __future__ import annotations

import os
from typing import Optional

from olearning_sim_tpu_torch.telemetry.metrics import (
    COUNTER,
    DEFAULT_BUCKETS,
    GAUGE,
    HISTOGRAM,
    Counter,
    Gauge,
    Histogram,
    Metric,
    MetricsRegistry,
    default_registry,
    set_default_registry,
)
from olearning_sim_tpu_torch.telemetry.tracing import (
    Span,
    SpanTracer,
    default_tracer,
    set_default_tracer,
)
from olearning_sim_tpu_torch.telemetry.exporters import (
    MetricsHTTPServer,
    dump_json,
    render_prometheus,
    snapshot,
)

# Round-phase latencies cluster well under a second but stretch to
# minutes for first rounds; checkpoint I/O sits in between.
_PHASE_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                  2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)
# Outbound producer latency per dispatched batch: an in-memory collector
# returns in microseconds, a network sink in milliseconds.
_DISPATCH_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                     1.0, 5.0)
_IO_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
               10.0, 30.0, 60.0)
# Simulated device time (completion/deadline): phone rounds span sub-second
# high-tier devices to many-minute stragglers.
_SIM_TIME_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                     120.0, 300.0, 600.0, 1800.0)
# Median-normalized anomaly scores (dimensionless ratio): benign clients
# cluster near 1; sign-flip/scale attackers land decades above.
_ANOMALY_BUCKETS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
# Staleness (server commits between a client's dispatch and its commit):
# async buffers keep most commits in the low single digits; the long tail
# is what max_staleness truncates.
_STALENESS_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)

# name -> (kind, help, label names[, buckets]).
CATALOG = {
    "ols_engine_round_phase_duration_seconds": (
        HISTOGRAM,
        "Wall-clock per round phase (select/train/host_transfer/eval/"
        "custom/accounting/checkpoint/model_export)",
        ("task_id", "operator", "phase"), _PHASE_BUCKETS,
    ),
    # Eager PyTorch compiles nothing: in the port this gauge holds the
    # first round's wall time per (task, operator), as the JAX runner
    # records it, and that time is the CUDA context, cuBLAS/cuDNN handle
    # and autotuning warm-up rather than a compile.
    "ols_engine_compile_duration_seconds": (
        GAUGE,
        "First-execution wall-clock of the compiled round step per "
        "(task, operator) — dominated by XLA compilation",
        ("task_id", "operator"),
    ),
    "ols_engine_round_duration_seconds": (
        HISTOGRAM,
        "Wall-clock per (round, operator) execution as recorded by "
        "PerformanceManager",
        ("task_id", "operator"), _PHASE_BUCKETS,
    ),
    "ols_engine_rounds_total": (
        COUNTER,
        "Round executions by outcome (ok/failed/skipped)",
        ("task_id", "status"),
    ),
    "ols_engine_device_rounds_total": (
        COUNTER,
        "Virtual device-rounds advanced (clients x train rounds)",
        ("task_id",),
    ),
    "ols_engine_stragglers_total": (
        COUNTER,
        "Selected clients whose simulated completion missed the round "
        "deadline (deadline-masked aggregation; distinct from drops)",
        ("task_id",),
    ),
    "ols_engine_completion_time_seconds": (
        HISTOGRAM,
        "Simulated per-client completion times (network arrival + "
        "device-class compute) of each round's selected cohort",
        ("task_id",), _SIM_TIME_BUCKETS,
    ),
    "ols_engine_round_deadline_seconds": (
        HISTOGRAM,
        "Effective round deadline (static, adaptive-controller, or K-th "
        "arrival close) per train round",
        ("task_id",), _SIM_TIME_BUCKETS,
    ),
    "ols_engine_clipped_total": (
        COUNTER,
        "Participating clients whose delta L2 norm exceeded the defense "
        "clip threshold and was rescaled in-jit (adversarial-client "
        "defense)",
        ("task_id",),
    ),
    "ols_engine_anomaly_ratio": (
        HISTOGRAM,
        "Per-participant Krum-style anomaly scores normalized by the "
        "round's median score (benign clients cluster near 1; the flag "
        "threshold is defense.anomaly_threshold)",
        ("task_id",), _ANOMALY_BUCKETS,
    ),
    "ols_engine_quarantined_clients": (
        GAUGE,
        "Clients currently quarantined out of participation (strike "
        "budget exceeded via non-finite updates, anomaly flags, or "
        "operator preseed)",
        ("task_id",),
    ),
    "ols_engine_buffer_depth": (
        GAUGE,
        "Mean committed updates per async buffer commit in the last "
        "round (the buffer-utilization signal; the configured capacity "
        "is async.buffer_size)",
        ("task_id",),
    ),
    "ols_engine_staleness_rounds": (
        HISTOGRAM,
        "Per committed client update: server commits between its dispatch "
        "and its commit (async buffered rounds; the staleness-weight "
        "schedule discounts by this)",
        ("task_id",), _STALENESS_BUCKETS,
    ),
    "ols_engine_idle_seconds_total": (
        COUNTER,
        "Simulated seconds completed client updates spent waiting to be "
        "committed (mode=sync: until the round-close commit; mode=async: "
        "until their buffer filled) — the round-tail idle the async "
        "engine drives toward ~0",
        ("task_id", "mode"),
    ),
    # The port stages on a copy stream (and a staging thread): this counter
    # sums the seconds the round's host thread waited for staged blocks.
    "ols_engine_host_transfer_seconds_total": (
        COUNTER,
        "Wall seconds spent staging streamed cohort blocks host->device "
        "(FedCore.stream_round double-buffered placement; compare with "
        "round wall time for transfer exposure)",
        ("algorithm",),
    ),
    "ols_engine_stream_blocks_total": (
        COUNTER,
        "Cohort blocks executed by the streamed round engine (one "
        "compiled partial step per block; population / stream_block_rows "
        "per round)",
        ("algorithm",),
    ),
    "ols_engine_client_state_bytes": (
        GAUGE,
        "Host-resident persistent per-client state bytes held by the "
        "streamed population's HostClientStore (quarantine strikes, "
        "pacing EMAs, personalization state)",
        ("algorithm",),
    ),
    "ols_engine_eval_accuracy": (
        GAUGE,
        "Held-out eval accuracy of the global model at the last "
        "convergence-tracker eval point (fraction correct in [0, 1]; "
        "engine/convergence.py — the quality denominator behind every "
        "throughput number)",
        ("task_id",),
    ),
    "ols_engine_time_to_target_seconds": (
        GAUGE,
        "Seconds until eval accuracy first reached the configured "
        "convergence target, per clock (clock=sim: simulated fleet "
        "time; clock=wall: measured host time). Unset until the target "
        "is reached",
        ("task_id", "clock"),
    ),
    "ols_engine_rounds_to_target": (
        GAUGE,
        "Train rounds until eval accuracy first reached the configured "
        "convergence target (the rounds-denominated time-to-accuracy "
        "figure BENCH_convergence.json banks). Unset until reached",
        ("task_id",),
    ),
    "ols_engine_tp_sharded_ratio": (
        GAUGE,
        "Fraction of parameter elements the mesh mp axis actually shards "
        "for a tensor-parallel build, per model (parallel/tp "
        "sharded_fraction; 0 means the model axis is pure replication — "
        "the tp_coverage analyzer fails mp>1 configs below 50%)",
        ("model",),
    ),
    # The port's checkpointer saves off the round's critical path too: the
    # save series times the dispatch (the device-to-host copy is queued on
    # a side stream, the write runs on the commit thread).
    "ols_checkpoint_save_duration_seconds": (
        HISTOGRAM, "RoundCheckpointer.save wall-clock (dispatch side)",
        ("task_id",), _IO_BUCKETS,
    ),
    "ols_checkpoint_restore_duration_seconds": (
        HISTOGRAM, "RoundCheckpointer.restore wall-clock per attempted step",
        ("task_id",), _IO_BUCKETS,
    ),
    "ols_checkpoint_save_bytes_total": (
        COUNTER, "Payload bytes handed to checkpoint saves (leaf sizes)",
        ("task_id",),
    ),
    "ols_checkpoint_restore_bytes_total": (
        COUNTER, "Payload bytes restored from checkpoints (leaf sizes)",
        ("task_id",),
    ),
    # --------------------------------------------------------- deviceflow
    "ols_deviceflow_queue_depth": (
        GAUGE,
        "Staged messages by room (inbound queue / all shelves combined)",
        ("room",),
    ),
    "ols_deviceflow_inbound_messages_total": (
        COUNTER, "Messages published into the deviceflow inbound room", (),
    ),
    "ols_deviceflow_dispatched_messages_total": (
        COUNTER, "Messages delivered to outbound producers", (),
    ),
    "ols_deviceflow_dropped_messages_total": (
        COUNTER, "Messages dropped by dispatch behavior (drop schedule)", (),
    ),
    "ols_deviceflow_dispatch_batch_duration_seconds": (
        HISTOGRAM, "Outbound producer latency per dispatched batch",
        (), _DISPATCH_BUCKETS,
    ),
    "ols_deviceflow_parked_batches": (
        GAUGE,
        "Degraded outbound batches parked on durable shelves awaiting "
        "crash redelivery",
        (),
    ),
    # ------------------------------------------------------------ taskmgr
    "ols_taskmgr_state_transitions_total": (
        COUNTER, "Task status writes by destination state", ("status",),
    ),
    "ols_taskmgr_queue_depth": (
        GAUGE, "Tasks waiting in the scheduler queue", (),
    ),
    "ols_taskmgr_admission_rejected_total": (
        COUNTER,
        "Submissions refused by chip-pool admission control by reason "
        "(backpressure / oom / deadline); rejected tasks are failed "
        "loudly, never queued silently (taskmgr/pool.py)",
        ("reason",),
    ),
    "ols_taskmgr_task_wait_seconds": (
        HISTOGRAM,
        "Queue wait per launched task: submit accepted -> engine job "
        "launched (the p95 of this is the scheduler bench's figure of "
        "merit vs FIFO)",
        (), _PHASE_BUCKETS,
    ),
    "ols_taskmgr_pool_utilization_ratio": (
        GAUGE,
        "Fraction of a pool worker's peak-HBM capacity consumed by "
        "current placements (chip-pool scheduler ledger)",
        ("worker",),
    ),
    # --------------------------------------------------------- supervisor
    "ols_supervisor_resumes_total": (
        COUNTER,
        "Expired-lease RUNNING tasks re-adopted by the supervisor and "
        "relaunched through the checkpoint resume path",
        ("task_id",),
    ),
    "ols_supervisor_lease_age_seconds": (
        HISTOGRAM,
        "How long past expiry a reclaimed task's lease was when the "
        "supervisor took it (recovery latency; tune the lease TTL "
        "against this)",
        ("task_id",), _IO_BUCKETS,
    ),
    "ols_resilience_events_total": (
        COUNTER,
        "Resilience events (retry/rollback/quarantine/...) mirrored from "
        "ResilienceLog",
        ("kind", "task_id"),
    ),
}


def instrument(name: str, registry: Optional[MetricsRegistry] = None):
    """Materialize a cataloged metric in ``registry`` (default registry when
    None). Idempotent; the only way the port's code creates metrics."""
    spec = CATALOG[name]
    kind, help_text, labels = spec[0], spec[1], spec[2]
    registry = registry if registry is not None else default_registry()
    if kind == HISTOGRAM:
        buckets = spec[3] if len(spec) > 3 else DEFAULT_BUCKETS
        return registry.histogram(name, help_text, labels=labels,
                                  buckets=buckets)
    if kind == GAUGE:
        return registry.gauge(name, help_text, labels=labels)
    return registry.counter(name, help_text, labels=labels)


if os.environ.get("OLS_TELEMETRY") == "0":
    default_registry().enabled = False
    default_tracer().enabled = False

__all__ = [
    "CATALOG",
    "COUNTER",
    "GAUGE",
    "HISTOGRAM",
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "Metric",
    "MetricsRegistry",
    "MetricsHTTPServer",
    "Span",
    "SpanTracer",
    "default_registry",
    "default_tracer",
    "dump_json",
    "instrument",
    "render_prometheus",
    "set_default_registry",
    "set_default_tracer",
    "snapshot",
]
