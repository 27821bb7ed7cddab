"""Table repositories: the narrow interface every piece of control-plane
state is kept behind, and its dict-backed implementation.

A copy of ``TableRepo`` and ``MemoryTableRepo`` from the JAX package's
``utils/repo.py`` (the reference keeps this state in MySQL through a generic
table accessor), with the lease rows (``claim_row`` / ``release_row``,
atomic under the in-memory repo's lock). The runner uses a task repo duck-typed (``has_task``,
``add_task``, ``set_item_value``), so a control plane may pass in its own
SQLite or MySQL-backed repo; the port itself needs only the in-memory one.

All values are stored as given (the reference serializes JSON into text
columns); typed access is the caller's concern.
"""

from __future__ import annotations

import abc
import threading
from typing import Any, Dict, List, Optional, Sequence


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
        """Atomic conditional ownership write (the lease CAS): set
        ``owner_item = owner_value`` and ``expires_item = new_expires`` iff
        the row is unowned, already owned by ``owner_value``, or (when
        ``steal``) its lease expired before ``now``. Returns True iff this
        caller owns the row after the call."""
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
        """Drop ownership iff ``owner_item == owner_value``, atomically, so a
        release racing a steal never wipes the new owner's live lease."""
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
