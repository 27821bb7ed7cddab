"""DeviceFlow service: the stateful gradient-house orchestrator.

Reference: ``ols_core/deviceflow/grpc_service/deviceflow_server.py:43-473`` —
a stateful server with three daemon threads (sort / dispatch / flow-release),
per-flow lifecycle Register -> NotifyStart -> (messages flow) ->
NotifyComplete -> dispatch -> release, crash recovery from its table, and a
``CheckDeviceflowDispatchFinished`` RPC that gates task teardown in the task
manager (``task_manager.py:1104-1121``).

This class is transport-agnostic: in the port no RPC surface wraps it, and
the task manager and the runners call its methods directly. Messages enter
via :meth:`publish` (the reference's Pulsar inbound topic).

A copy of the JAX package's ``deviceflow/service.py``, with the same
threads, tables, fault points and per-flow seeding.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from olearning_sim_tpu_torch.deviceflow.dispatcher import Clock, Dispatcher
from olearning_sim_tpu_torch.deviceflow.flow import FlowManager
from olearning_sim_tpu_torch.deviceflow.registry import TaskRegistry
from olearning_sim_tpu_torch.deviceflow.rooms import InboundRoom, Message, ShelfRoom
from olearning_sim_tpu_torch.deviceflow.sorter import Sorter
from olearning_sim_tpu_torch.deviceflow.validate import check_notify_start_params
from olearning_sim_tpu_torch.utils.clocks import Deadline
from olearning_sim_tpu_torch.utils.logging import Logger
from olearning_sim_tpu_torch.utils.repo import TableRepo


class DeviceFlowService:
    def __init__(
        self,
        flow_repo: Optional[TableRepo] = None,
        registry_repo: Optional[TableRepo] = None,
        outbound_factory: Optional[Callable[[str, Dict[str, Any]], Callable[[List[Any]], None]]] = None,
        clock: Optional[Clock] = None,
        logger: Optional[Logger] = None,
        poll_interval: float = 0.05,
        seed: int = 0,
        rooms_path: Optional[str] = None,
    ):
        """``rooms_path`` — path to a sqlite file; when given, the inbound
        and shelf rooms are durable (:mod:`durable_rooms`): staged messages
        survive a service crash and are re-delivered at-least-once on the
        next construction over the same file (the reference's persistent
        Pulsar topics, ``bound_room.py:29-64`` / ``shelf_room.py:23-137``).
        """
        self.logger = logger if logger is not None else Logger()
        self.flow_manager = FlowManager(repo=flow_repo, logger=self.logger)
        self.registry = TaskRegistry(repo=registry_repo, logger=self.logger)
        self.durable = rooms_path is not None
        if self.durable:
            from olearning_sim_tpu_torch.deviceflow.durable_rooms import (
                SqliteInboundRoom,
                SqliteShelfRoom,
            )

            self.inbound = SqliteInboundRoom(rooms_path)
            self.shelf_room = SqliteShelfRoom(rooms_path)
        else:
            self.inbound = InboundRoom()
            self.shelf_room = ShelfRoom()
        self.sorter = Sorter(self.shelf_room)
        self.clock = clock if clock is not None else Clock()
        self.poll_interval = poll_interval
        self.seed = seed
        # outbound_factory(flow_id, outbound_service_cfg) -> producer callable.
        # Default: collect delivered batches in-memory per flow for inspection.
        self.delivered: Dict[str, List[Any]] = {}
        self._outbound_factory = outbound_factory or self._default_outbound

        self._lock = threading.RLock()
        self.flow: Dict[str, Dict[str, Any]] = self.flow_manager.load_flows()
        self._dispatchers: Dict[str, Dispatcher] = {}
        # Daemon threads, not a ThreadPoolExecutor: a dispatcher whose flow is
        # never completed must not block interpreter shutdown.
        self._dispatch_threads: Dict[str, threading.Thread] = {}
        self._dispatch_done: Dict[str, bool] = {}  # clean completion flag
        self._dispatch_failed: set = set()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # Watermark for the publish/notify_complete handshake: every message
        # enqueued before a notify_complete snapshot must be *sorted* (not
        # merely dequeued) before completion is recorded. On a durable
        # restart, messages still pending in the inbound table count toward
        # the watermark so a post-recovery notify_complete waits for them.
        self._enqueued_count = self.inbound.qsize() if self.durable else 0
        self._sorted_count = 0
        # flow_id -> batches this service parked on its durable shelf (feeds
        # the parked-batch gauge; entries retire when the flow releases).
        self._parked_batches: Dict[str, int] = {}
        self._gauges_stamp = 0.0

    def _update_queue_gauges(self) -> None:
        """Refresh the inbound/shelf depth gauges from authoritative room
        state (called from publish and the dispatch loop's poll tick).
        Throttled to one refresh per poll interval: durable rooms answer
        sizes with sqlite COUNTs, which a hot publish path must not pay per
        message — the dispatch loop's tick keeps the gauge fresh anyway."""
        from olearning_sim_tpu_torch.telemetry import default_registry, instrument

        if not default_registry().enabled:
            # The registry-off overhead baseline must skip the value
            # computation too (sqlite COUNTs per flow), not just the set().
            return
        now = time.monotonic()
        if now - self._gauges_stamp < self.poll_interval:
            return
        self._gauges_stamp = now
        gauge = instrument("ols_deviceflow_queue_depth")
        gauge.labels(room="inbound").set(self.inbound.qsize())
        with self._lock:
            shelf_total = sum(
                self.shelf_room.shelf_size(fid) for fid in self.flow
            )
        gauge.labels(room="shelf").set(shelf_total)

    def _default_outbound(self, flow_id: str, cfg: Dict[str, Any]):
        """Dispatch on the flow's outbound_service config: a websocket
        sink (deviceflow/outbound.py, the reference's WS producer
        message_producer.py:42-78) gets a real producer, ``grpc`` is
        refused, anything else collects in-memory for in-process
        consumers."""
        from olearning_sim_tpu_torch.deviceflow.outbound import make_outbound_factory

        def in_memory(fid, _cfg):
            def producer(batch: List[Any]):
                self.delivered.setdefault(fid, []).extend(batch)

            return producer

        return make_outbound_factory(fallback=in_memory)(flow_id, cfg)

    # The inner factory pops "task_id" (per-task degrade accounting); the
    # bound method inherits this function attribute through getattr.
    _default_outbound.accepts_task_id = True

    # ----------------------------------------------------------------- RPCs
    def register_task(self, task_id: str, total_compute_resources: List[str]) -> bool:
        return self.registry.register_task(task_id, total_compute_resources)

    def unregister_task(self, task_id: str) -> bool:
        return self.registry.unregister_task(task_id)

    def notify_start(
        self,
        task_id: str,
        routing_key: str,
        compute_resource: str,
        strategy: str,
        outbound_service: Optional[Dict[str, Any]] = None,
    ) -> Tuple[bool, str]:
        """Reference ``NotifyStart`` (``deviceflow_server.py:166-260``):
        validate, create/join the flow, start sorting; when every registered
        resource has started, the dispatcher is armed."""
        from olearning_sim_tpu_torch.resilience import faults

        if faults.fire("deviceflow.notify_start", context=routing_key,
                       task_id=task_id) is not None:
            return False, f"injected fault: notify_start {routing_key}"
        if not self.registry.is_registered(task_id):
            return False, f"task {task_id} not registered"
        ok, msg = check_notify_start_params(compute_resource, strategy)
        if not ok:
            return False, msg
        with self._lock:
            ok, params = self.flow_manager.notify_start(
                self.flow, task_id, routing_key, compute_resource, strategy,
                outbound_service,
            )
            if not ok:
                return False, "notify_start failed"
            self.flow[routing_key] = params
            self.shelf_room.add_shelf(routing_key)
            params["to_sort"] = True
            if self.flow_manager.check_all_notify_start(
                self.registry.get(task_id), params
            ):
                params["to_dispatch"] = True
            # Re-persist with the sort/dispatch flags so crash recovery
            # re-arms dispatchers (reference deviceflow_server.py:137-164).
            self.flow_manager.persist(routing_key, task_id, params)
        return True, "Pass"

    def notify_complete(
        self, task_id: str, routing_key: str, compute_resource: str,
        flush_timeout: float = 30.0,
    ) -> Tuple[bool, str]:
        from olearning_sim_tpu_torch.resilience import faults

        if faults.fire("deviceflow.notify_complete", context=routing_key,
                       task_id=task_id) is not None:
            return False, f"injected fault: notify_complete {routing_key}"
        # Drain in-flight inbound messages first: updates published before
        # NotifyComplete must not be discarded just because the sort loop
        # hasn't consumed them yet. (The reference has this same race over
        # Pulsar, ``sorter.py:56-69``; in-process we close it with a sorted-
        # count watermark: completion is recorded only after every message
        # enqueued before this call has actually been sorted.)
        with self._lock:
            watermark = self._enqueued_count
        deadline = Deadline(flush_timeout)
        while not deadline.expired():
            with self._lock:
                if self._sorted_count >= watermark:
                    break
            time.sleep(min(self.poll_interval, 0.01))
        with self._lock:
            ok, params = self.flow_manager.notify_complete(
                self.flow, task_id, routing_key, compute_resource
            )
            if not ok:
                return False, "notify_complete failed"
            self.flow[routing_key] = params
            if self.flow_manager.check_all_notify_complete(
                self.registry.get(task_id), params
            ):
                disp = self._dispatchers.get(routing_key)
                if disp is not None:
                    disp.release_dispatch()
        return True, "Pass"

    def publish(self, routing_key: str, compute_resource: str, payload: Any) -> None:
        """Client updates enter here (the Pulsar inbound topic analogue).
        Fault-injection point ``deviceflow.publish`` raises (exception
        contract: callers own the retry)."""
        from olearning_sim_tpu_torch.resilience import faults

        faults.inject(
            "deviceflow.publish", context=routing_key,
            task_id=(self.flow.get(routing_key) or {}).get("task_id", ""),
        )
        with self._lock:
            self._enqueued_count += 1
        self.inbound.put(Message(routing_key, compute_resource, payload))
        from olearning_sim_tpu_torch.telemetry import instrument

        instrument("ols_deviceflow_inbound_messages_total").inc()
        self._update_queue_gauges()

    def check_dispatch_finished(self, task_id: str) -> bool:
        """Reference ``CheckDeviceflowDispatchFinished``
        (``deviceflow_server.py:403-427``): True when no unfinished flow of
        this task remains."""
        with self._lock:
            for params in self.flow.values():
                if params["task_id"] == task_id and not params.get("isFinished", False):
                    return False
            return True

    # -------------------------------------------------------------- threads
    def start(self) -> None:
        """Start the three daemon loops (reference ``deviceflow_server.py:76-81``)."""
        self._stop.clear()
        for target, name in (
            (self._sort_loop, "deviceflow-sort"),
            (self._dispatch_loop, "deviceflow-dispatch"),
            (self._release_loop, "deviceflow-release"),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            for disp in self._dispatchers.values():
                disp.release_dispatch()  # let open-flow dispatch loops exit
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    def _sort_loop(self) -> None:
        while not self._stop.is_set():
            msg = self.inbound.get(timeout=self.poll_interval)
            if msg is None:
                continue
            with self._lock:
                self.sorter.sort(self.flow, msg)
                self._sorted_count += 1
            # Durable rooms: the inbound row is deleted only after its
            # payload is on the durable shelf (ack-after-processing; a
            # crash in between re-queues the row — at-least-once).
            ack = getattr(self.inbound, "ack", None)
            if ack is not None:
                ack(msg)

    def _dispatch_loop(self) -> None:
        """Arm a dispatcher for every flow whose resources all started
        (reference ``deviceflow_server.py:429-451``)."""
        while not self._stop.is_set():
            with self._lock:
                for flow_id, params in list(self.flow.items()):
                    if not params.get("to_dispatch") or flow_id in self._dispatchers:
                        continue
                    if flow_id in self._dispatch_failed:
                        continue
                    try:
                        cfg = dict(params.get("outbound_service") or {})
                        if getattr(self._outbound_factory,
                                   "accepts_task_id", False):
                            # Only factories that pop the key get it — a
                            # user factory doing SomeProducer(**cfg) must
                            # not choke on an unexpected kwarg.
                            cfg["task_id"] = params.get("task_id", "")
                        producer = self._outbound_factory(flow_id, cfg)
                    except Exception as e:  # noqa: BLE001
                        # A malformed outbound config fails THIS flow, not
                        # the dispatch loop serving every other task.
                        self._dispatch_failed.add(flow_id)
                        self.logger.error(
                            task_id=params.get("task_id", ""),
                            system_name="DeviceFlow", module_name="dispatch",
                            message=f"outbound producer for {flow_id} failed: {e}",
                        )
                        continue
                    ack_flow = getattr(self.shelf_room, "ack_flow", None)
                    if ack_flow is not None:
                        # Durable shelves: claimed rows are deleted only
                        # after the outbound delivery returns, so a crash
                        # mid-dispatch re-delivers instead of losing them.
                        park = getattr(self.shelf_room, "park_flow", None)

                        def producer(batch, _p=producer, _fid=flow_id,
                                     _ack=ack_flow, _park=park):
                            dropped = getattr(_p, "dropped_batches", None)
                            _p(batch)
                            if dropped is not None and \
                                    _p.dropped_batches > dropped:
                                # A resilient producer degraded (dropped)
                                # this batch: ack would convert the degrade
                                # into acknowledged data loss; returning the
                                # rows to deliverable would livelock the
                                # dispatcher on a dead sink. Park them — a
                                # crash before flow release redelivers; a
                                # graceful release drops them (counted).
                                if _park is not None:
                                    _park(_fid)
                                    self._note_parked(_fid)
                                return
                            _ack(_fid)
                    disp = Dispatcher(
                        flow_id=flow_id,
                        strategy=params["strategy"],
                        shelf_room=self.shelf_room,
                        producer=producer,
                        clock=self.clock,
                        # crc32 keeps per-flow streams stable across processes
                        # (hash() is salted by PYTHONHASHSEED).
                        rng=np.random.default_rng(
                            [self.seed, zlib.crc32(flow_id.encode())]
                        ),
                        poll_interval=self.poll_interval,
                    )
                    self._dispatchers[flow_id] = disp
                    if self.flow_manager.check_all_notify_complete(
                        self.registry.get(params["task_id"]), params
                    ):
                        disp.release_dispatch()
                    self._dispatch_done[flow_id] = False
                    t = threading.Thread(
                        target=self._run_dispatch,
                        args=(flow_id, disp),
                        name=f"dispatch-{flow_id}",
                        daemon=True,
                    )
                    t.start()
                    self._dispatch_threads[flow_id] = t
            self._update_queue_gauges()
            self._stop.wait(self.poll_interval)

    def _note_parked(self, flow_id: str) -> None:
        """One more degraded batch parked on the durable shelf: the gauge
        counts batches awaiting crash redelivery until their flow releases
        (a graceful release drops them — close_shelf — so the gauge retires
        with the flow)."""
        from olearning_sim_tpu_torch.telemetry import instrument

        with self._lock:
            self._parked_batches[flow_id] = \
                self._parked_batches.get(flow_id, 0) + 1
        instrument("ols_deviceflow_parked_batches").inc()

    def _retire_parked(self, flow_id: str) -> None:
        from olearning_sim_tpu_torch.telemetry import instrument

        n = self._parked_batches.pop(flow_id, 0)
        if n:
            instrument("ols_deviceflow_parked_batches").dec(n)

    def _run_dispatch(self, flow_id: str, disp: Dispatcher) -> None:
        try:
            disp.dispatch()
            with self._lock:
                self._dispatch_done[flow_id] = True
        except Exception as e:  # noqa: BLE001 — surfaced via log + open flow
            params = self.flow.get(flow_id, {})
            self.logger.error(
                task_id=params.get("task_id", ""),
                system_name="Deviceflow",
                module_name="dispatch",
                message=f"dispatcher for flow {flow_id} crashed: {e!r}; "
                f"flow left open (staged messages preserved)",
            )

    def _release_loop(self) -> None:
        """Mark flows finished once dispatch drained; persist and drop state
        (reference ``deviceflow_server.py:453-473``). A crashed dispatcher
        does NOT finish its flow: the failure is logged, staged messages stay
        on the shelf, and check_dispatch_finished keeps returning False so the
        task manager sees the stall instead of a silent success."""
        while not self._stop.is_set():
            with self._lock:
                for flow_id, t in list(self._dispatch_threads.items()):
                    if t.is_alive():
                        continue
                    if not self._dispatch_done.get(flow_id, False):
                        if flow_id not in self._dispatch_failed:
                            self._dispatch_failed.add(flow_id)
                        del self._dispatch_threads[flow_id]  # no re-arm
                        continue
                    params = self.flow.get(flow_id)
                    if params is None:
                        continue
                    params["isFinished"] = True
                    self.flow_manager.persist(flow_id, params["task_id"], params)
                    self.flow_manager.release_flow(flow_id)
                    self.shelf_room.close_shelf(flow_id)
                    self._retire_parked(flow_id)
                    del self._dispatch_threads[flow_id]
                    del self._dispatchers[flow_id]
                    del self.flow[flow_id]
                    self._dispatch_done.pop(flow_id, None)
            self._stop.wait(self.poll_interval)
