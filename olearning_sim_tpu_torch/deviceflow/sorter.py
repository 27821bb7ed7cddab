"""Sorter: inbound messages -> per-flow shelves.

Reference: ``ols_core/deviceflow/non_grpc/sorter.py:16-92`` — a single
consumer loop on the global inbound topic that discards any message not
between its flow's NotifyStart and NotifyComplete, and re-publishes accepted
payloads onto the flow's shelf.

A copy of the JAX package's ``deviceflow/sorter.py``.
"""

from __future__ import annotations

from typing import Any, Dict

from olearning_sim_tpu_torch.deviceflow.rooms import Message, ShelfRoom


class Sorter:
    def __init__(self, shelf_room: ShelfRoom):
        self.shelf_room = shelf_room
        self.accepted = 0
        self.discarded = 0

    def should_put(self, flow: Dict[str, Dict[str, Any]], msg: Message) -> bool:
        """Accept only between NotifyStart and NotifyComplete for the
        message's compute resource (reference ``sorter.py:56-69``)."""
        params = flow.get(msg.flow_id)
        if params is None:
            return False
        if not params.get("notify_start_called", {}).get(msg.compute_resource, False):
            return False
        if params.get("notify_complete_called", {}).get(msg.compute_resource, False):
            return False
        return True

    def sort(self, flow: Dict[str, Dict[str, Any]], msg: Message) -> bool:
        if not self.should_put(flow, msg):
            self.discarded += 1
            return False
        self.shelf_room.add_shelf(msg.flow_id)
        if self.shelf_room.put_on_shelf(msg.flow_id, msg.payload):
            self.accepted += 1
            return True
        self.discarded += 1
        return False
