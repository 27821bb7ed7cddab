"""Durable (sqlite-backed) message rooms: staged updates survive a crash.

The reference's gradient house stages every in-flight update in *persistent*
Pulsar topics — one global inbound (``ols_core/deviceflow/non_grpc/
bound_room.py:29-64``) and one shelf topic per flow (``shelf_room.py:23-137``)
— so a deviceflow crash loses nothing. The in-process rooms
(:mod:`olearning_sim_tpu_torch.deviceflow.rooms`) recover flow *state* from the
repo but lose every sorted-but-undispatched message with the process. These
two classes implement the same interfaces over sqlite (WAL mode) so the
message bodies are durable too.

Delivery semantics are the reference's (Pulsar consumer with
ack-after-processing): **at-least-once**. Rows are *claimed* (state=1) when
taken and *deleted* only on ack — the sort loop acks an inbound row after
its payload is safely on the durable shelf, and the dispatcher's producer
wrapper acks shelf rows after the outbound delivery returns. A crash
re-queues claimed-but-unacked rows on the next open, so the only duplicate
window is a crash *between* delivery and ack (exactly Pulsar's).

A copy of the JAX package's ``deviceflow/durable_rooms.py``.
"""

from __future__ import annotations

import pickle
import sqlite3
import threading
import time
from typing import Any, List, Optional

from olearning_sim_tpu_torch.deviceflow.rooms import Message
from olearning_sim_tpu_torch.utils.repo import connect_sqlite


def _connect(path: str) -> sqlite3.Connection:
    # Shared control-plane sqlite discipline (WAL + busy_timeout): the
    # supervisor re-attaching a durable room while the dispatcher thread
    # drains it must wait, not raise "database is locked".
    return connect_sqlite(path)


class SqliteInboundRoom:
    """Durable global inbound queue (reference ``deviceflow_inbound`` topic).

    ``get`` *claims* the oldest pending row; callers ack via :meth:`ack`
    once the message has been processed (sorted onto the durable shelf).
    Unacked claims revert to pending on the next construction over the same
    file (= crash recovery).
    """

    def __init__(self, path: str):
        self._conn = _connect(path)
        self._lock = threading.RLock()
        with self._lock, self._conn:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS inbound ("
                " seq INTEGER PRIMARY KEY AUTOINCREMENT,"
                " routing_key TEXT NOT NULL,"
                " compute_resource TEXT NOT NULL,"
                " payload BLOB NOT NULL,"
                " state INTEGER NOT NULL DEFAULT 0)"
            )
            # Crash recovery: claimed-but-unacked -> pending again.
            self._conn.execute("UPDATE inbound SET state=0 WHERE state=1")

    def put(self, msg: Message) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO inbound (routing_key, compute_resource, payload)"
                " VALUES (?, ?, ?)",
                (msg.routing_key, msg.compute_resource,
                 pickle.dumps(msg.payload)),
            )

    def get(self, timeout: Optional[float] = None) -> Optional[Message]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock, self._conn:
                row = self._conn.execute(
                    "SELECT seq, routing_key, compute_resource, payload"
                    " FROM inbound WHERE state=0 ORDER BY seq LIMIT 1"
                ).fetchone()
                if row is not None:
                    self._conn.execute(
                        "UPDATE inbound SET state=1 WHERE seq=?", (row[0],)
                    )
            if row is not None:
                msg = Message(row[1], row[2], pickle.loads(row[3]))
                object.__setattr__(msg, "_seq", row[0])
                return msg
            if deadline is None or time.monotonic() >= deadline:
                return None
            time.sleep(0.005)

    def ack(self, msg: Message) -> None:
        seq = getattr(msg, "_seq", None)
        if seq is None:
            return
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM inbound WHERE seq=?", (seq,))

    def qsize(self) -> int:
        with self._lock:
            (n,) = self._conn.execute(
                "SELECT COUNT(*) FROM inbound WHERE state=0"
            ).fetchone()
            return n

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class SqliteShelfRoom:
    """Durable per-flow staging shelves (reference per-flow
    ``persistent://public/shelf_room/<flow_id>`` topics).

    ``take_from_shelf`` claims rows; :meth:`ack_flow` (called by the
    service's producer wrapper after outbound delivery returns) deletes the
    flow's claimed rows. Unacked claims revert to pending on reopen, in
    their original order.
    """

    def __init__(self, path: str):
        self._conn = _connect(path)
        self._lock = threading.RLock()
        with self._lock, self._conn:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS shelves ("
                " flow_id TEXT PRIMARY KEY)"
            )
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS shelf ("
                " seq INTEGER PRIMARY KEY AUTOINCREMENT,"
                " flow_id TEXT NOT NULL,"
                " payload BLOB NOT NULL,"
                " state INTEGER NOT NULL DEFAULT 0)"
            )
            # state=1 (claimed mid-delivery at crash) and state=2 (parked by
            # a degraded producer) both return to deliverable on restart.
            self._conn.execute("UPDATE shelf SET state=0 WHERE state!=0")

    def add_shelf(self, flow_id: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR IGNORE INTO shelves (flow_id) VALUES (?)",
                (flow_id,),
            )

    def has_shelf(self, flow_id: str) -> bool:
        with self._lock:
            return self._conn.execute(
                "SELECT 1 FROM shelves WHERE flow_id=?", (flow_id,)
            ).fetchone() is not None

    def put_on_shelf(self, flow_id: str, payload: Any) -> bool:
        with self._lock, self._conn:
            if not self.has_shelf(flow_id):
                return False
            self._conn.execute(
                "INSERT INTO shelf (flow_id, payload) VALUES (?, ?)",
                (flow_id, pickle.dumps(payload)),
            )
            return True

    def take_from_shelf(self, flow_id: str, n: int = 1) -> List[Any]:
        with self._lock, self._conn:
            rows = self._conn.execute(
                "SELECT seq, payload FROM shelf"
                " WHERE flow_id=? AND state=0 ORDER BY seq LIMIT ?",
                (flow_id, n),
            ).fetchall()
            if rows:
                self._conn.executemany(
                    "UPDATE shelf SET state=1 WHERE seq=?",
                    [(r[0],) for r in rows],
                )
            return [pickle.loads(r[1]) for r in rows]

    def ack_flow(self, flow_id: str) -> None:
        """Delete the flow's claimed rows — its outbound delivery returned.
        (One dispatcher per flow, so every claimed row of the flow belongs
        to the batch(es) just delivered or deliberately dropped.)"""
        with self._lock, self._conn:
            self._conn.execute(
                "DELETE FROM shelf WHERE flow_id=? AND state=1", (flow_id,)
            )

    def park_flow(self, flow_id: str) -> None:
        """Move the flow's claimed rows to state=2 (parked) — their outbound
        delivery was degraded (batch dropped by a resilient producer).
        Parked rows are invisible to ``take_from_shelf``/``shelf_size`` (so a
        permanently dead sink cannot livelock the dispatcher on the same
        batch) and to ``ack_flow`` (so the NEXT successful batch's ack cannot
        sweep them as delivered). Startup recovery returns them to
        deliverable, so a crash BEFORE the flow releases redelivers them; on
        a graceful flow release ``close_shelf`` drops them — a bounded,
        counted loss (the degrading producer already recorded
        ``outbound_degraded`` with the batch size)."""
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE shelf SET state=2 WHERE flow_id=? AND state=1",
                (flow_id,),
            )

    def shelf_size(self, flow_id: str) -> int:
        with self._lock:
            (n,) = self._conn.execute(
                "SELECT COUNT(*) FROM shelf WHERE flow_id=? AND state=0",
                (flow_id,),
            ).fetchone()
            return n

    def close_shelf(self, flow_id: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "DELETE FROM shelf WHERE flow_id=?", (flow_id,)
            )
            self._conn.execute(
                "DELETE FROM shelves WHERE flow_id=?", (flow_id,)
            )

    def close(self) -> None:
        with self._lock:
            self._conn.close()
