"""State repositories.

The reference persists every piece of control-plane state in MySQL via a
generic table accessor (``ols_core/utils/repo_utils.py:19-400`` SqlDataBase,
specialized as TaskTableRepo / ResTableRepo / the deviceflow table). A copy
of the JAX package's ``utils/repo.py``: the same narrow interface behind an
ABC, with three implementations:

- :class:`MemoryTableRepo` — dict-backed, for single-process mode and tests;
- :class:`SqliteTableRepo` — stdlib sqlite3 file DB for durable single-host
  deployments (WAL + busy timeout through :func:`connect_sqlite`; the lease
  CAS ``claim_row`` / ``release_row`` is one conditional UPDATE);
- :class:`MySqlTableRepo` — the cluster-mode shared state bus the reference
  runs on (``repo_utils.py``'s ``mysql+pymysql`` engine), as a DBAPI
  adapter with the reference's reconnect-once-then-retry discipline.
  Import-gated: the driver module (pymysql) loads only on the production
  path; tests inject sqlite3 connections through the same adapter code.

All values are stored as TEXT in the SQL backends (the reference serializes
JSON into MySQL text columns the same way) and as given in memory; typed
access is the caller's concern. A table written by either package's SQLite
repo reads in the other's.
"""

from __future__ import annotations

import abc
import contextlib
import sqlite3
import threading
from typing import Any, Dict, List, Optional, Sequence


# "database is locked/busy" flavors sqlite raises when busy_timeout runs
# out under write contention. WAL + busy_timeout absorb most of it, but at
# hundreds of concurrent writers (submit-storm scale) the timeout itself
# can expire — those writes go through a bounded RetryPolicy instead of
# surfacing a transient as a hard failure.
_LOCKED_MARKERS = ("database is locked", "database is busy",
                   "database table is locked")
_LOCKED = object()  # sentinel: the attempt hit a locked error
_LOCKED_POLICY = None


def _locked_error(e: BaseException) -> bool:
    return isinstance(e, sqlite3.OperationalError) and any(
        m in str(e).lower() for m in _LOCKED_MARKERS
    )


def _locked_policy():
    global _LOCKED_POLICY
    if _LOCKED_POLICY is None:
        # Lazy import: resilience pulls in telemetry/numpy; the repo layer
        # must stay importable without them at module-import time.
        from olearning_sim_tpu_torch.resilience.retry import RetryPolicy

        # retry_on=(): raised exceptions are NEVER absorbed here — only
        # the locked sentinel routed through the bool contract retries, so
        # a real error (missing table, corrupt file) surfaces immediately.
        _LOCKED_POLICY = RetryPolicy(max_attempts=6, base_delay=0.01,
                                     max_delay=0.25, jitter=0.25,
                                     retry_on=())
    return _LOCKED_POLICY


def retry_locked(fn, policy=None, point: str = "repo.sqlite_locked"):
    """Run ``fn`` under a bounded retry on sqlite lock contention.

    Only ``OperationalError: database is locked/busy`` is retried (and
    recorded as ``retry`` resilience events under ``point``); every other
    error propagates immediately. When the budget runs out the last locked
    error is re-raised — the caller's normal sqlite3.Error handling
    applies, so contracts (False/None returns) survive unchanged.
    """
    pol = policy if policy is not None else _locked_policy()
    last: List[BaseException] = []

    def attempt():
        try:
            return fn()
        except sqlite3.OperationalError as e:
            if not _locked_error(e):
                raise
            last.append(e)
            return _LOCKED

    result = pol.call(attempt, retry_if=lambda r: r is _LOCKED, point=point)
    if result is _LOCKED:
        raise last[-1]
    return result


def connect_sqlite(path: str, *, busy_timeout_s: float = 30.0,
                   synchronous: str = "NORMAL") -> sqlite3.Connection:
    """The one way the platform opens a sqlite control-plane DB.

    Every raw ``sqlite3.connect(..., check_same_thread=False)`` call site
    (task table, intake queue, durable deviceflow rooms) used to set its own
    pragmas — or none, so a supervisor thread writing while a gRPC thread
    read would hit ``database is locked``. This helper enables WAL (readers
    never block the writer and vice versa) and a busy timeout (a second
    writer waits instead of raising) for all of them.
    """
    conn = sqlite3.connect(path, check_same_thread=False,
                           timeout=busy_timeout_s)
    with contextlib.suppress(sqlite3.Error):
        # ":memory:" and some read-only mounts refuse WAL; the connection is
        # still usable, just without multi-process concurrency.
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute(f"PRAGMA synchronous={synchronous}")
    conn.execute(f"PRAGMA busy_timeout={int(busy_timeout_s * 1000)}")
    return conn


class TableRepo(abc.ABC):
    """Narrow table interface shared by all control-plane state."""

    @abc.abstractmethod
    def add_item(self, item: Dict[str, List[Any]]) -> bool:
        """Insert rows given a column->values mapping (reference
        ``SqlDataBase.add_item`` signature)."""

    @abc.abstractmethod
    def get_item_value(self, identify_name: str, identify_value: Any, item: str) -> Optional[Any]:
        """Value of column ``item`` for the first row where
        ``identify_name == identify_value``."""

    @abc.abstractmethod
    def set_item_value(self, identify_name: str, identify_value: Any, item: str, value: Any) -> bool:
        """Set column ``item`` on all rows matching the identifier."""

    @abc.abstractmethod
    def delete_items(self, **conditions: Any) -> bool:
        """Delete all rows matching the conditions."""

    @abc.abstractmethod
    def get_values_by_conditions(self, item: str, **conditions: Any) -> List[Any]:
        """All values of column ``item`` over rows matching the conditions."""

    @abc.abstractmethod
    def query_all(self) -> List[Dict[str, Any]]:
        """Every row as a dict."""

    # Convenience shared helpers -------------------------------------------------
    def has_item(self, identify_name: str, identify_value: Any) -> bool:
        return len(self.get_values_by_conditions(identify_name, **{identify_name: identify_value})) > 0

    @staticmethod
    def _lease_claimable(owner: Any, expires: Any, owner_value: str,
                         now: float, steal: bool) -> bool:
        """Shared claim predicate. With ``steal`` a row is claimable when it
        is already ours, unowned, or its lease has expired (a set owner with
        no parseable expiry is a legacy/torn row — treated as expired).
        Without ``steal`` (renewal) ONLY the current owner qualifies — a
        renewal that succeeded on an unowned row would let a fenced/stale
        process silently re-adopt a task that was already finalized."""
        if owner == owner_value:
            return True
        if not steal:
            return False
        if owner in (None, ""):
            return True
        try:
            return float(expires) < now
        except (TypeError, ValueError):
            return True

    def claim_row(self, identify_name: str, identify_value: Any,
                  owner_item: str, owner_value: str, expires_item: str,
                  new_expires: float, now: float, steal: bool = True) -> bool:
        """Atomic conditional ownership write (the lease CAS): set
        ``owner_item = owner_value`` and ``expires_item = new_expires`` iff
        the row is currently unowned, already owned by ``owner_value``, or
        (when ``steal``) its lease expired before ``now``. Returns True iff
        this caller owns the row after the call.

        This base implementation is read-check-write and therefore only
        best-effort for exotic backends; :class:`MemoryTableRepo` (process
        lock), :class:`SqliteTableRepo`, and :class:`MySqlTableRepo`
        (single conditional UPDATE) override it with genuinely atomic
        versions.
        """
        owner = self.get_item_value(identify_name, identify_value, owner_item)
        expires = self.get_item_value(identify_name, identify_value, expires_item)
        if not self._lease_claimable(owner, expires, owner_value, now, steal):
            return False
        ok = self.set_item_value(identify_name, identify_value, owner_item,
                                 owner_value)
        if not ok:
            return False
        self.set_item_value(identify_name, identify_value, expires_item,
                            repr(float(new_expires)))
        return True

    def release_row(self, identify_name: str, identify_value: Any,
                    owner_item: str, owner_value: str,
                    expires_item: str) -> bool:
        """Conditionally drop ownership: clear ``owner_item`` and
        ``expires_item`` iff ``owner_item == owner_value``. Like claim_row,
        the base version is read-check-write; the concrete backends make it
        a single atomic conditional UPDATE so a release racing a steal can
        never wipe the new owner's live lease."""
        owner = self.get_item_value(identify_name, identify_value, owner_item)
        if owner != owner_value:
            return False
        self.set_item_value(identify_name, identify_value, owner_item, "")
        self.set_item_value(identify_name, identify_value, expires_item, "")
        return True


class MemoryTableRepo(TableRepo):
    def __init__(self, columns: Sequence[str]):
        self.columns = list(columns)
        self._rows: List[Dict[str, Any]] = []
        self._lock = threading.RLock()

    def add_item(self, item: Dict[str, List[Any]]) -> bool:
        with self._lock:
            lengths = {len(v) for v in item.values()}
            if len(lengths) > 1:
                return False
            n = lengths.pop() if lengths else 0
            for i in range(n):
                row = {c: None for c in self.columns}
                for k, vals in item.items():
                    if k not in self.columns:
                        return False
                    row[k] = vals[i]
                self._rows.append(row)
            return True

    def get_item_value(self, identify_name, identify_value, item):
        with self._lock:
            for row in self._rows:
                if row.get(identify_name) == identify_value:
                    return row.get(item)
            return None

    def set_item_value(self, identify_name, identify_value, item, value) -> bool:
        with self._lock:
            if item not in self.columns:
                return False
            hit = False
            for row in self._rows:
                if row.get(identify_name) == identify_value:
                    row[item] = value
                    hit = True
            return hit

    def delete_items(self, **conditions) -> bool:
        with self._lock:
            before = len(self._rows)
            self._rows = [
                r for r in self._rows
                if not all(r.get(k) == v for k, v in conditions.items())
            ]
            return len(self._rows) < before

    def get_values_by_conditions(self, item, **conditions):
        with self._lock:
            return [
                r.get(item) for r in self._rows
                if all(r.get(k) == v for k, v in conditions.items())
            ]

    def query_all(self):
        with self._lock:
            return [dict(r) for r in self._rows]

    def claim_row(self, identify_name, identify_value, owner_item,
                  owner_value, expires_item, new_expires, now,
                  steal: bool = True) -> bool:
        with self._lock:
            for row in self._rows:
                if row.get(identify_name) != identify_value:
                    continue
                if not self._lease_claimable(
                    row.get(owner_item), row.get(expires_item),
                    owner_value, now, steal,
                ):
                    return False
                row[owner_item] = owner_value
                row[expires_item] = repr(float(new_expires))
                return True
            return False

    def release_row(self, identify_name, identify_value, owner_item,
                    owner_value, expires_item) -> bool:
        with self._lock:
            for row in self._rows:
                if row.get(identify_name) != identify_value:
                    continue
                if row.get(owner_item) != owner_value:
                    return False
                row[owner_item] = ""
                row[expires_item] = ""
                return True
            return False


class SqliteTableRepo(TableRepo):
    """sqlite3-backed repo; one table per instance, TEXT columns.

    check_same_thread=False + a process lock gives the same
    many-threads/one-writer discipline the reference relies on (its services
    share one SqlDataBase handle across daemon threads).
    """

    def __init__(self, path: str, table: str, columns: Sequence[str]):
        if not table.isidentifier():
            raise ValueError(f"invalid table name {table!r}")
        for c in columns:
            if not c.isidentifier():
                raise ValueError(f"invalid column name {c!r}")
        self.table = table
        self.columns = list(columns)
        self._lock = threading.RLock()
        self._conn = connect_sqlite(path)
        cols = ", ".join(f"{c} TEXT" for c in self.columns)
        with self._lock:
            self._conn.execute(f"CREATE TABLE IF NOT EXISTS {table} ({cols})")
            # Schema evolution: a DB file created by an older build may lack
            # columns added since (e.g. "resilience"); CREATE IF NOT EXISTS
            # keeps the old table, so add any missing ones in place.
            existing = {
                row[1] for row in
                self._conn.execute(f"PRAGMA table_info({table})")
            }
            for c in self.columns:
                if c not in existing:
                    self._conn.execute(
                        f"ALTER TABLE {table} ADD COLUMN {c} TEXT"
                    )
            self._conn.commit()

    def _col(self, name: str) -> str:
        if name not in self.columns:
            raise KeyError(f"unknown column {name!r} for table {self.table}")
        return name

    def add_item(self, item: Dict[str, List[Any]]) -> bool:
        try:
            keys = [self._col(k) for k in item]
            lengths = {len(v) for v in item.values()}
            if len(lengths) > 1:
                return False
            n = lengths.pop() if lengths else 0
            placeholders = ", ".join("?" for _ in keys)
            sql = f"INSERT INTO {self.table} ({', '.join(keys)}) VALUES ({placeholders})"
            with self._lock:
                for i in range(n):
                    self._conn.execute(sql, [item[k][i] for k in keys])
                self._conn.commit()
            return True
        except (sqlite3.Error, KeyError):
            return False

    def get_item_value(self, identify_name, identify_value, item):
        sql = (
            f"SELECT {self._col(item)} FROM {self.table} "
            f"WHERE {self._col(identify_name)} = ? LIMIT 1"
        )
        with self._lock:
            cur = self._conn.execute(sql, (identify_value,))
            row = cur.fetchone()
        return row[0] if row else None

    def set_item_value(self, identify_name, identify_value, item, value) -> bool:
        try:
            sql = (
                f"UPDATE {self.table} SET {self._col(item)} = ? "
                f"WHERE {self._col(identify_name)} = ?"
            )

            def op():
                with self._lock:
                    cur = self._conn.execute(sql, (value, identify_value))
                    self._conn.commit()
                return cur.rowcount > 0

            return retry_locked(op)
        except sqlite3.Error:
            return False

    def delete_items(self, **conditions) -> bool:
        try:
            clause = " AND ".join(f"{self._col(k)} = ?" for k in conditions)
            sql = f"DELETE FROM {self.table}" + (f" WHERE {clause}" if clause else "")
            with self._lock:
                cur = self._conn.execute(sql, list(conditions.values()))
                self._conn.commit()
            return cur.rowcount > 0
        except sqlite3.Error:
            return False

    def get_values_by_conditions(self, item, **conditions):
        clause = " AND ".join(f"{self._col(k)} = ?" for k in conditions)
        sql = f"SELECT {self._col(item)} FROM {self.table}" + (
            f" WHERE {clause}" if clause else ""
        )
        with self._lock:
            cur = self._conn.execute(sql, list(conditions.values()))
            return [r[0] for r in cur.fetchall()]

    def query_all(self):
        with self._lock:
            cur = self._conn.execute(f"SELECT {', '.join(self.columns)} FROM {self.table}")
            rows = cur.fetchall()
        return [dict(zip(self.columns, r)) for r in rows]

    def _claim_sql(self, identify_name: str, owner_item: str,
                   expires_item: str, steal: bool, ph: str = "?") -> str:
        """One conditional UPDATE = the whole CAS: the WHERE clause encodes
        the claim predicate (renewal: current owner ONLY; steal: owner, or
        unowned, or expired/torn lease), so two processes racing on the
        same file DB cannot both win (sqlite serializes writers; rowcount
        arbitrates)."""
        cond = f"({owner_item} = {ph}"
        if steal:
            cond += (f" OR {owner_item} IS NULL OR {owner_item} = ''"
                     f" OR {expires_item} IS NULL OR {expires_item} = ''"
                     f" OR CAST({expires_item} AS REAL) < {ph}")
        cond += ")"
        return (f"UPDATE {self.table} SET {owner_item} = {ph}, "
                f"{expires_item} = {ph} WHERE {identify_name} = {ph} AND {cond}")

    def claim_row(self, identify_name, identify_value, owner_item,
                  owner_value, expires_item, new_expires, now,
                  steal: bool = True) -> bool:
        try:
            sql = self._claim_sql(self._col(identify_name),
                                  self._col(owner_item),
                                  self._col(expires_item), steal)
            params = [owner_value, repr(float(new_expires)), identify_value,
                      owner_value]
            if steal:
                params.append(float(now))

            # The lease CAS under storm concurrency: a locked error here is
            # NOT an arbitration loss (the UPDATE never ran) — retry it
            # bounded instead of reading it as "claim refused".
            def op():
                with self._lock:
                    cur = self._conn.execute(sql, params)
                    self._conn.commit()
                return cur.rowcount > 0

            return retry_locked(op)
        except sqlite3.Error:
            return False

    def release_row(self, identify_name, identify_value, owner_item,
                    owner_value, expires_item) -> bool:
        try:
            sql = (f"UPDATE {self.table} SET {self._col(owner_item)} = '', "
                   f"{self._col(expires_item)} = '' WHERE "
                   f"{self._col(identify_name)} = ? AND "
                   f"{self._col(owner_item)} = ?")

            def op():
                with self._lock:
                    cur = self._conn.execute(sql, (identify_value, owner_value))
                    self._conn.commit()
                return cur.rowcount > 0

            return retry_locked(op)
        except sqlite3.Error:
            return False


class MySqlTableRepo(TableRepo):
    """MySQL-backed repo over any DBAPI-2.0 connection.

    The reference's shared control-plane bus is MySQL behind SQLAlchemy
    (``ols_core/utils/repo_utils.py:31-36`` builds a ``mysql+pymysql``
    engine; every accessor catches OperationalError, re-initializes the
    connection ONCE, and retries — ``:49-56``, ``:89-104``). This adapter
    keeps that exact discipline over a plain DBAPI driver (no SQLAlchemy
    in this image): ``connect`` is a zero-arg factory returning a fresh
    connection, every operation retries once through a fresh connection on
    failure, and errors degrade to False/None/[] rather than raising (the
    reference's posture — callers poll).

    ``paramstyle``: "format" for pymysql/mysql-connector (%s), "qmark"
    for DBAPI drivers like sqlite3 (?) — which is also how the adapter's
    SQL generation and retry logic stay testable without a MySQL server.
    """

    def __init__(self, connect, table: str, columns: Sequence[str],
                 paramstyle: str = "format"):
        if not table.isidentifier():
            raise ValueError(f"invalid table name {table!r}")
        for c in columns:
            if not c.isidentifier():
                raise ValueError(f"invalid column name {c!r}")
        if paramstyle not in ("format", "qmark"):
            raise ValueError(f"unsupported paramstyle {paramstyle!r}")
        self.table = table
        self.columns = list(columns)
        self._connect = connect
        self._ph = "%s" if paramstyle == "format" else "?"
        self._lock = threading.RLock()
        self._conn = connect()

    @classmethod
    def from_config(cls, host: str, port: int, user: str, password: str,
                    database: str, table: str, columns: Sequence[str]):
        """Production constructor (reference ``SqlDataBase.__init__`` reads
        the same fields from table YAMLs, ``repo_utils.py:20-29``).
        Import-gated on pymysql."""
        import pymysql  # noqa: PLC0415 — only the MySQL path needs it

        def connect():
            return pymysql.connect(host=host, port=int(port), user=user,
                                   password=password, database=database,
                                   autocommit=False)

        return cls(connect, table, columns, paramstyle="format")

    def _col(self, name: str) -> str:
        if name not in self.columns:
            raise KeyError(f"unknown column {name!r} for table {self.table}")
        return name

    def _execute(self, sql: str, params: Sequence[Any]):
        """Run one statement; on ANY connection/driver error, reconnect once
        and retry (reference ``:49-56``). Raises only if the retry fails too
        — callers translate that into their False/None returns."""
        cur = self._execute_batch(sql, [tuple(params)])
        return cur

    def _execute_batch(self, sql: str, rows: Sequence[Sequence[Any]]):
        """Run one statement over many param rows in a SINGLE transaction
        (all rows, then one commit — same all-or-nothing semantics as
        SqliteTableRepo's add_item). On failure: roll back, reconnect once,
        retry the WHOLE batch; a second failure rolls back and raises, so a
        partial prefix is never left committed for the caller to re-insert."""
        with self._lock:
            for attempt in (0, 1):
                try:
                    cur = self._conn.cursor()
                    for row in rows:
                        cur.execute(sql, tuple(row))
                    self._conn.commit()
                    return cur
                except Exception:  # noqa: BLE001 — DBAPI error bases vary by driver
                    try:
                        self._conn.rollback()
                    except Exception:  # lint: allow-silent — cleanup of a
                        pass           # failed conn; original error re-raised
                    if attempt:
                        raise
                    try:
                        self._conn.close()
                    except Exception:  # lint: allow-silent — closing the
                        pass           # dead conn before the reconnect retry
                    self._conn = self._connect()

    def add_item(self, item: Dict[str, List[Any]]) -> bool:
        try:
            keys = [self._col(k) for k in item]
            lengths = {len(v) for v in item.values()}
            if len(lengths) > 1:
                return False
            n = lengths.pop() if lengths else 0
            placeholders = ", ".join(self._ph for _ in keys)
            sql = (f"INSERT INTO {self.table} ({', '.join(keys)}) "
                   f"VALUES ({placeholders})")
            self._execute_batch(sql, [[item[k][i] for k in keys]
                                      for i in range(n)])
            return True
        except Exception:  # noqa: BLE001
            return False

    def get_item_value(self, identify_name, identify_value, item):
        try:
            sql = (f"SELECT {self._col(item)} FROM {self.table} "
                   f"WHERE {self._col(identify_name)} = {self._ph} LIMIT 1")
            row = self._execute(sql, (identify_value,)).fetchone()
            return row[0] if row else None
        except Exception:  # noqa: BLE001
            return None

    def set_item_value(self, identify_name, identify_value, item, value) -> bool:
        try:
            sql = (f"UPDATE {self.table} SET {self._col(item)} = {self._ph} "
                   f"WHERE {self._col(identify_name)} = {self._ph}")
            return self._execute(sql, (value, identify_value)).rowcount > 0
        except Exception:  # noqa: BLE001
            return False

    def delete_items(self, **conditions) -> bool:
        try:
            clause = " AND ".join(
                f"{self._col(k)} = {self._ph}" for k in conditions
            )
            sql = f"DELETE FROM {self.table}" + (
                f" WHERE {clause}" if clause else ""
            )
            return self._execute(sql, list(conditions.values())).rowcount > 0
        except Exception:  # noqa: BLE001
            return False

    def get_values_by_conditions(self, item, **conditions):
        try:
            clause = " AND ".join(
                f"{self._col(k)} = {self._ph}" for k in conditions
            )
            sql = f"SELECT {self._col(item)} FROM {self.table}" + (
                f" WHERE {clause}" if clause else ""
            )
            return [r[0] for r in self._execute(
                sql, list(conditions.values())).fetchall()]
        except Exception:  # noqa: BLE001
            return []

    def query_all(self):
        try:
            cur = self._execute(
                f"SELECT {', '.join(self.columns)} FROM {self.table}", ()
            )
            return [dict(zip(self.columns, r)) for r in cur.fetchall()]
        except Exception:  # noqa: BLE001
            return []

    def claim_row(self, identify_name, identify_value, owner_item,
                  owner_value, expires_item, new_expires, now,
                  steal: bool = True) -> bool:
        """Single conditional UPDATE (see SqliteTableRepo._claim_sql); the
        DB serializes concurrent claimers and rowcount arbitrates.
        DECIMAL cast: valid in MySQL and mapped to NUMERIC affinity by the
        sqlite driver the adapter is tested against."""
        try:
            oi, ei = self._col(owner_item), self._col(expires_item)
            cond = f"({oi} = {self._ph}"
            if steal:
                cond += (f" OR {oi} IS NULL OR {oi} = ''"
                         f" OR {ei} IS NULL OR {ei} = ''"
                         f" OR CAST({ei} AS DECIMAL(20,6)) < {self._ph}")
            cond += ")"
            sql = (f"UPDATE {self.table} SET {oi} = {self._ph}, "
                   f"{ei} = {self._ph} WHERE "
                   f"{self._col(identify_name)} = {self._ph} AND {cond}")
            params = [owner_value, repr(float(new_expires)), identify_value,
                      owner_value]
            if steal:
                params.append(float(now))
            return self._execute(sql, params).rowcount > 0
        except Exception:  # noqa: BLE001
            return False

    def release_row(self, identify_name, identify_value, owner_item,
                    owner_value, expires_item) -> bool:
        try:
            sql = (f"UPDATE {self.table} SET {self._col(owner_item)} = '', "
                   f"{self._col(expires_item)} = '' WHERE "
                   f"{self._col(identify_name)} = {self._ph} AND "
                   f"{self._col(owner_item)} = {self._ph}")
            return self._execute(
                sql, (identify_value, owner_value)
            ).rowcount > 0
        except Exception:  # noqa: BLE001
            return False
