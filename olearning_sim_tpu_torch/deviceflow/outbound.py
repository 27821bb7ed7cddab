"""Network outbound producers for dispatched deviceflow batches.

Reference: the gradient house forwards each dispatched batch to the task's
*outbound service* — a Pulsar producer or a WebSocket producer that wraps
every payload as ``{"payload": base64(...)}`` (the Pulsar WebSocket-producer
wire format, ``ols_core/deviceflow/non_grpc/message_producer.py:42-78``) —
so an external aggregator receives the behavior-shaped stream. The rebuild
keeps the WebSocket format byte-compatible and replaces the Pulsar option
with a gRPC ``OutboundSink`` service (``proto/services.proto``): brokerless,
and the control plane already speaks gRPC.

A copy of the JAX package's ``deviceflow/outbound.py``. The WebSocket
producer imports ``websocket`` (websocket-client) only when it connects;
the gRPC producer loads the wire (grpcio, protobuf) when it is built, and
raises an ``ImportError`` naming both where they do not import.

A producer is a callable ``producer(batch: List[Any]) -> None`` (the
contract ``Dispatcher`` expects); ``close()`` is optional.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


def _encode(msg: Any) -> str:
    return msg if isinstance(msg, str) else json.dumps(msg, default=str)


class WebsocketProducer:
    """Sends each dispatched message as ``{"payload": base64(json)}`` text
    frames — the reference WebsocketProducer's exact format
    (``message_producer.py:59-78``). Lazily connects; one reconnect attempt
    per send so a bounced aggregator doesn't drop the whole flow."""

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url
        self.timeout = timeout
        self._ws = None
        self._lock = threading.Lock()

    def _connect(self):
        import websocket  # websocket-client, lazy so tests can stub

        self._ws = websocket.create_connection(self.url, timeout=self.timeout)

    def _send(self, frame: str) -> None:
        if self._ws is None:
            self._connect()
        try:
            self._ws.send(frame)
        except Exception as e:
            logger.debug("websocket send to %s failed (%s: %s); "
                         "reconnecting once", self.url, type(e).__name__, e)
            self.close()
            self._connect()
            self._ws.send(frame)

    def __call__(self, batch: List[Any]) -> None:
        with self._lock:
            for msg in batch:
                payload = base64.b64encode(_encode(msg).encode()).decode()
                self._send(json.dumps({"payload": payload}))

    def close(self) -> None:
        ws, self._ws = self._ws, None
        if ws is not None:
            try:
                ws.close()
            except Exception as e:
                # Best-effort teardown of a possibly-dead socket, but the
                # failure stays observable for degraded-path debugging.
                logger.debug("websocket close for %s failed: %s: %s",
                             self.url, type(e).__name__, e)


class GrpcOutboundProducer:
    """Publishes dispatched batches to an external ``OutboundSink`` gRPC
    service (one RPC per batch, preserving the dispatcher's batching)."""

    def __init__(self, target: str, flow_id: str = "", timeout: float = 10.0):
        from olearning_sim_tpu_torch.utils.wire import load_wire

        wire = load_wire("olearning_sim_tpu_torch.services.grpc_services",
                         f"the grpc outbound sink of flow {flow_id or '?'} ({target})")
        self.flow_id = flow_id
        self.timeout = timeout
        self._channel = wire.grpc.insecure_channel(target)
        self._sink = wire.OutboundSinkClient(self._channel)

    def __call__(self, batch: List[Any]) -> None:
        ok, message = self._sink.publish_batch(
            self.flow_id, [_encode(m) for m in batch], timeout=self.timeout)
        if not ok:
            raise IOError(f"OutboundSink rejected batch: {message}")

    def close(self) -> None:
        self._channel.close()


class ResilientProducer:
    """Retry + degrade wrapper around a network producer.

    Each batch send is retried per ``retry_policy``; when the policy is
    exhausted the failure is handled per ``on_failure``:

    - ``"degrade"`` (default): the batch is dropped, the failure is logged
      and counted (``outbound_degraded`` events with batch size) and the
      flow keeps dispatching — a dead websocket/HTTP sink degrades the
      operator instead of crashing the dispatcher and wedging task teardown.
      The next batch tries the sink again (it may have come back).
    - ``"raise"``: re-raise — the dispatcher thread fails, the flow stays
      open, and ``check_dispatch_finished`` keeps gating teardown (the
      pre-resilience behavior, for deployments where losing the outbound
      stream must fail the task).

    Fault-injection point: ``outbound.send`` (fires per attempt, so a
    ``times=1`` fault exercises the retry-succeeds path).

    Delivery is at-least-once: a retry re-sends the WHOLE batch, so a sink
    that fails mid-batch (e.g. the frame-by-frame websocket producer) may
    receive the leading messages again. External aggregators that cannot
    tolerate duplicates should dedup on content or run with
    ``retry_policy=NO_RETRY``.
    """

    def __init__(self, inner: Callable[[List[Any]], None], flow_id: str = "",
                 retry_policy=None, on_failure: str = "degrade", log=None,
                 task_id: str = ""):
        from olearning_sim_tpu_torch.resilience import NO_RETRY

        self.inner = inner
        self.flow_id = flow_id
        self.retry_policy = retry_policy if retry_policy is not None else NO_RETRY
        self.on_failure = on_failure
        self.log = log
        self.task_id = task_id
        self.dropped_batches = 0
        self.dropped_messages = 0

    def __call__(self, batch: List[Any]) -> None:
        from olearning_sim_tpu_torch.resilience import OUTBOUND_DEGRADED, faults
        from olearning_sim_tpu_torch.resilience.events import global_log

        def op():
            faults.inject("outbound.send", context=self.flow_id,
                          task_id=self.task_id)
            self.inner(batch)

        try:
            self.retry_policy.call(op, point="outbound.send",
                                   task_id=self.task_id, log=self.log)
        except Exception as e:  # noqa: BLE001 — policy already filtered
            from olearning_sim_tpu_torch.resilience.retry import NON_RETRYABLE

            if isinstance(e, NON_RETRYABLE):
                # HostPreemption et al. model process death — degrading one
                # to a dropped batch would contradict the rollback contract.
                raise
            if self.on_failure != "degrade":
                raise
            self.dropped_batches += 1
            self.dropped_messages += len(batch)
            (self.log or global_log()).record(
                OUTBOUND_DEGRADED, point="outbound.send",
                task_id=self.task_id, flow_id=self.flow_id,
                batch_size=len(batch),
                error=f"{type(e).__name__}: {e}",
            )

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()


def make_outbound_factory(
    default_cfg: Optional[Dict[str, Any]] = None,
    fallback: Optional[Callable[[str, Dict[str, Any]], Callable]] = None,
    retry_policy=None,
    on_failure: str = "degrade",
    log=None,
):
    """Factory for ``DeviceFlowService(outbound_factory=...)``.

    Per-flow config (the ``outbound_service`` dict a task's NotifyStart
    carries, falling back to ``default_cfg``)::

        {"type": "websocket", "url": "ws://aggregator:8765/ws"}
        {"type": "grpc", "target": "aggregator:50070"}
        {"type": "memory"}   # or anything else -> ``fallback``

    ``fallback`` handles unrecognized/absent configs (the service's
    in-memory collector by default). Network producers (websocket/grpc) are
    wrapped in :class:`ResilientProducer` — send failures are retried per
    ``retry_policy`` and then degrade (logged + counted, batch dropped)
    instead of crashing the dispatcher; pass ``on_failure="raise"`` to keep
    the old fail-the-flow behavior. In-memory fallbacks are not wrapped
    (they cannot fail transiently)."""

    if retry_policy is None:
        # A network sink deserves a few attempts before a batch is dropped
        # (degrade) or the dispatcher dies (raise) — zero retries would turn
        # every transient hiccup into data loss under the degrade default.
        from olearning_sim_tpu_torch.resilience import RetryPolicy

        retry_policy = RetryPolicy(max_attempts=3, base_delay=0.2,
                                   max_delay=2.0)

    def factory(flow_id: str, cfg: Dict[str, Any]):
        eff = dict(default_cfg or {})
        eff.update(cfg or {})
        # Not part of any sink's connection config — the dispatch loop
        # injects it so degraded-batch events land in per-task counters.
        task_id = str(eff.pop("task_id", "") or "")
        kind = str(eff.get("type") or eff.get("kind") or "").lower()
        if kind in ("websocket", "ws"):
            producer = WebsocketProducer(
                eff["url"], timeout=float(eff.get("timeout", 10.0))
            )
        elif kind == "grpc":
            producer = GrpcOutboundProducer(
                eff.get("target") or eff["url"], flow_id,
                timeout=float(eff.get("timeout", 10.0)),
            )
        elif fallback is not None:
            return fallback(flow_id, eff)
        else:
            raise ValueError(
                f"unknown outbound service type {kind!r} for flow {flow_id}"
            )
        return ResilientProducer(
            producer, flow_id, retry_policy=retry_policy,
            on_failure=str(eff.get("on_failure", on_failure)), log=log,
            task_id=task_id,
        )

    # Signals the dispatch loop that this factory pops "task_id" from cfg;
    # user-supplied factories without the marker get the cfg untouched.
    factory.accepts_task_id = True
    return factory
