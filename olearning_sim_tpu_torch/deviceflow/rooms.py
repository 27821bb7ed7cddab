"""In-process message rooms (the Pulsar-topic replacement).

Reference topology (``ols_core/deviceflow/non_grpc/bound_room.py:29-64``,
``shelf_room.py:23-137``): one global ``deviceflow_inbound`` Pulsar topic that
all clients publish to, plus one staging ("shelf") topic per flow. Here the
same topology is in-process queues behind a small interface; a Pulsar/gRPC
transport can implement the same two classes for cluster mode. The *behavioral*
role of Pulsar (delay/drop/spike scheduling) lives in the trace compiler and
dispatcher, not the transport.

A copy of the JAX package's ``deviceflow/rooms.py``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from collections import deque
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class Message:
    """Inbound message contract (reference ``deviceflow/utils/message.py:4-19``)."""

    routing_key: str  # f"{task_id}_{operator}_{round}"
    compute_resource: str  # "logical_simulation" | "device_simulation"
    payload: Any

    @property
    def flow_id(self) -> str:
        return self.routing_key


class InboundRoom:
    """Global inbound queue all simulated clients publish updates to."""

    def __init__(self, maxsize: int = 0):
        self._q: "queue.Queue[Message]" = queue.Queue(maxsize=maxsize)

    def put(self, msg: Message) -> None:
        self._q.put(msg)

    def get(self, timeout: Optional[float] = None) -> Optional[Message]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def qsize(self) -> int:
        return self._q.qsize()


class ShelfRoom:
    """Per-flow staging queues (reference shelf topics
    ``persistent://public/shelf_room/<flow_id>``)."""

    def __init__(self):
        self._shelves: Dict[str, deque] = {}
        self._lock = threading.RLock()

    def add_shelf(self, flow_id: str) -> None:
        with self._lock:
            self._shelves.setdefault(flow_id, deque())

    def has_shelf(self, flow_id: str) -> bool:
        with self._lock:
            return flow_id in self._shelves

    def put_on_shelf(self, flow_id: str, payload: Any) -> bool:
        with self._lock:
            shelf = self._shelves.get(flow_id)
            if shelf is None:
                return False
            shelf.append(payload)
            return True

    def take_from_shelf(self, flow_id: str, n: int = 1) -> list:
        """Up to ``n`` staged payloads, FIFO."""
        with self._lock:
            shelf = self._shelves.get(flow_id)
            if shelf is None:
                return []
            out = []
            while shelf and len(out) < n:
                out.append(shelf.popleft())
            return out

    def shelf_size(self, flow_id: str) -> int:
        with self._lock:
            shelf = self._shelves.get(flow_id)
            return len(shelf) if shelf is not None else 0

    def close_shelf(self, flow_id: str) -> None:
        with self._lock:
            self._shelves.pop(flow_id, None)
