"""Alternate task-intake queues (the reference's RedisRepo path).

The reference ships a Redis-list submit path — task JSON ``rpush``-ed onto a
list and ``lpop``-ed by the manager (``ols_core/taskMgr/utils/utils_redis.py:16-48``;
the consuming ``submitTask`` variant is present but commented out at
``task_manager.py:255-345``). The rebuild makes the idea first-class behind a
small FIFO interface so a producer that cannot speak gRPC (a GUI backend, a
cron job, another host) can still enqueue tasks:

- :class:`MemoryQueueRepo` — in-process deque (tests, single-process mode);
- :class:`SqliteQueueRepo` — durable file-backed FIFO: rows survive a crash
  and a restarted manager drains what an earlier process enqueued (the
  crash-recovery semantics the reference gets from Redis persistence);
- :class:`RedisQueueRepo` — thin adapter with the reference's rpush/lpop
  wire behavior, import-gated (redis-py is not a baked-in dependency).

:meth:`TaskManager.drain_intake_once` pops payloads, decodes them with the
JSON→proto codec, and routes them through the normal ``submit_task`` path —
validation and dedup behave exactly as for gRPC submissions.

A copy of the JAX package's ``taskmgr/queue_repo.py``.
"""

from __future__ import annotations

import abc
import collections
import threading
from typing import List, Optional

from olearning_sim_tpu_torch.utils.repo import connect_sqlite, retry_locked


class QueueRepo(abc.ABC):
    """FIFO of opaque string payloads (task JSON on the intake path)."""

    @abc.abstractmethod
    def push(self, payload: str) -> bool:
        """Append to the tail (reference ``RedisRepo.insert_data`` rpush)."""

    @abc.abstractmethod
    def pop(self) -> Optional[str]:
        """Remove and return the head, or None when empty (reference
        ``RedisRepo.pop_data`` lpop)."""

    @abc.abstractmethod
    def peek_all(self) -> List[str]:
        """Snapshot of pending payloads, head first (non-destructive)."""

    @abc.abstractmethod
    def __len__(self) -> int: ...


class MemoryQueueRepo(QueueRepo):
    def __init__(self):
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def push(self, payload: str) -> bool:
        with self._lock:
            self._q.append(payload)
        return True

    def pop(self) -> Optional[str]:
        with self._lock:
            return self._q.popleft() if self._q else None

    def peek_all(self) -> List[str]:
        with self._lock:
            return list(self._q)

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class SqliteQueueRepo(QueueRepo):
    """Durable FIFO: an AUTOINCREMENT rowid orders payloads, and pop is a
    single DELETE..RETURNING-style transaction, so concurrent managers (or a
    manager restarted after a crash) never double-consume an entry."""

    def __init__(self, path: str, table: str = "task_intake_queue"):
        if not table.replace("_", "").isalnum():
            raise ValueError(f"invalid table name {table!r}")
        self._path = path
        self._table = table
        self._lock = threading.Lock()
        # Shared helper: WAL + busy_timeout, so a producer process pushing
        # while the manager's schedule daemon pops never sees
        # "database is locked".
        self._conn = connect_sqlite(path)
        with self._lock:
            self._conn.execute(
                f"CREATE TABLE IF NOT EXISTS {table} "
                "(id INTEGER PRIMARY KEY AUTOINCREMENT, payload TEXT NOT NULL)"
            )
            self._conn.commit()

    def push(self, payload: str) -> bool:
        # Bounded locked-retry (utils.repo.retry_locked): at submit-storm
        # concurrency the 30 s busy_timeout itself can expire; a transient
        # "database is locked" must not drop an intake payload.
        def op():
            with self._lock:
                self._conn.execute(
                    f"INSERT INTO {self._table} (payload) VALUES (?)",
                    (payload,),
                )
                self._conn.commit()
            return True

        return retry_locked(op)

    def pop(self) -> Optional[str]:
        def op():
            with self._lock:
                # IMMEDIATE: take the write lock before reading so two
                # processes popping the same file cannot both see (and
                # delete) the head row.
                self._conn.execute("BEGIN IMMEDIATE")
                try:
                    row = self._conn.execute(
                        f"SELECT id, payload FROM {self._table} "
                        f"ORDER BY id LIMIT 1"
                    ).fetchone()
                    if row is None:
                        self._conn.commit()
                        return None
                    self._conn.execute(
                        f"DELETE FROM {self._table} WHERE id = ?", (row[0],)
                    )
                    self._conn.commit()
                    return row[1]
                except Exception:
                    self._conn.rollback()
                    raise

        return retry_locked(op)

    def peek_all(self) -> List[str]:
        with self._lock:
            rows = self._conn.execute(
                f"SELECT payload FROM {self._table} ORDER BY id"
            ).fetchall()
        return [r[0] for r in rows]

    def __len__(self) -> int:
        with self._lock:
            (n,) = self._conn.execute(
                f"SELECT COUNT(*) FROM {self._table}"
            ).fetchone()
        return int(n)

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class RedisQueueRepo(QueueRepo):
    """Reference wire behavior (rpush/lpop on a named list,
    ``utils_redis.py:16-48``); requires the optional redis-py client."""

    def __init__(self, key: str = "task_intake_queue", *, host: str = "localhost",
                 port: int = 6379, db: int = 0, client=None):
        if client is None:
            try:
                import redis  # noqa: PLC0415 — optional dependency
            except ImportError as e:  # pragma: no cover - redis not baked in
                raise ImportError(
                    "RedisQueueRepo needs the redis package; use "
                    "SqliteQueueRepo for a dependency-free durable queue"
                ) from e
            client = redis.Redis(host=host, port=port, db=db, decode_responses=True)
        self._r = client
        self._key = key

    def push(self, payload: str) -> bool:
        self._r.rpush(self._key, payload)
        return True

    def pop(self) -> Optional[str]:
        return self._r.lpop(self._key)

    def peek_all(self) -> List[str]:
        return list(self._r.lrange(self._key, 0, -1))

    def __len__(self) -> int:
        return int(self._r.llen(self._key))
