"""Metrics registry: thread-safe Counters / Gauges / Histograms.

The reference answers "what is my simulation doing" through
``PerformanceMgr.getPerformance`` backed by MySQL rows — end-of-run numbers,
one lens. This module is the always-on live layer underneath: every subsystem
registers named instruments here, and the exporters
(:mod:`olearning_sim_tpu_torch.telemetry.exporters`) render one coherent
snapshot in Prometheus text-exposition or JSON form at any moment of a run.
A copy of the JAX package's ``telemetry/metrics.py``.

Design constraints, in order:

- **Hot-path cost ~ a dict lookup + float add.** The round loop calls
  ``observe``/``inc`` thousands of times per second; no allocation beyond the
  first call per label set, no locking wider than one instrument. A disabled
  registry (``enabled=False``) reduces every mutation to one attribute check
  so the bench's registry-off baseline measures the true floor.
- **Process-global default plus injectable instances.** Deep call sites
  (a checkpointer three layers under the runner) use
  :func:`default_registry`; anything that wants isolation (tests, multi-task
  servers) passes its own :class:`MetricsRegistry`.
- **Fixed label schema per metric.** Label *names* are declared at
  registration; label *values* bind per call via :meth:`Metric.labels`.
  Unknown label names raise immediately — silent cardinality drift is how
  dashboards die.
- **Naming convention** ``ols_<subsystem>_<noun>_<unit>`` (checked by
  ``scripts/check_metrics.py``); counters additionally end in ``_total``.

No external dependencies: the standard library only.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Default histogram boundaries: wall-clock seconds from 100us to ~2min —
# covers per-batch dispatch latency through first rounds.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


class _NullChild:
    """Returned by ``labels()`` on a disabled registry: every mutation is a
    no-op, so overhead-baseline runs skip even the child bookkeeping."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def observe_many(self, values) -> None:
        pass


_NULL_CHILD = _NullChild()


class Metric:
    """One named instrument: a family of children keyed by label values.

    An unlabeled metric has exactly one child (the ``()`` key); a labeled one
    materializes a child per distinct label-value tuple on first use.
    """

    kind: str = ""

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (), registry=None):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._registry = registry
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        if not self.label_names:
            self._children[()] = self._new_child()

    # ------------------------------------------------------------- children
    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values: Any, **kv: Any):
        """Bind label values -> the child instrument. Accepts positional
        values in declared order, or keywords matching the declared names."""
        if not self._enabled:
            return _NULL_CHILD
        if kv:
            if values:
                raise ValueError(
                    f"{self.name}: pass label values positionally or by "
                    f"keyword, not both"
                )
            try:
                values = tuple(kv.pop(n) for n in self.label_names)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e.args[0]!r} "
                    f"(declared: {self.label_names})"
                ) from None
            if kv:
                raise ValueError(
                    f"{self.name}: unknown labels {sorted(kv)} "
                    f"(declared: {list(self.label_names)})"
                )
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: got {len(values)} label values for "
                f"{len(self.label_names)} declared labels {self.label_names}"
            )
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _default_child(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} declares labels {self.label_names}; "
                f"call .labels(...) first"
            )
        return self._children[()]

    @property
    def _enabled(self) -> bool:
        return self._registry is None or self._registry.enabled

    def children(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return sorted(self._children.items())

    def remove_children(self, **match: Any) -> int:
        """Drop children whose labels include ``match`` (e.g.
        ``task_id="t1"``); returns how many were removed. Prometheus
        scrapers treat a disappearing series as a counter reset."""
        want = {k: str(v) for k, v in match.items()}
        idx = {n: i for i, n in enumerate(self.label_names)}
        unknown = set(want) - set(idx)
        if unknown:
            raise ValueError(
                f"{self.name}: unknown labels {sorted(unknown)} "
                f"(declared: {list(self.label_names)})"
            )
        with self._lock:
            doomed = [
                key for key in self._children
                if key and all(key[idx[k]] == v for k, v in want.items())
            ]
            for key in doomed:
                del self._children[key]
            return len(doomed)


class _CounterChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        # Locked: `+=` is a read-modify-write across bytecodes, and counters
        # are hit from gRPC worker and dispatcher threads concurrently.
        with self._lock:
            self.value += amount


class Counter(Metric):
    kind = COUNTER

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        if self._enabled:
            self._default_child().inc(amount)

    def labels(self, *values: Any, **kv: Any) -> "_CounterChild":
        return super().labels(*values, **kv)


class _GaugeChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        self.value = float(value)  # plain store: atomic under the GIL

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount


class Gauge(Metric):
    kind = GAUGE

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        if self._enabled:
            self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        if self._enabled:
            self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        if self._enabled:
            self._default_child().dec(amount)

    def labels(self, *values: Any, **kv: Any) -> "_GaugeChild":
        return super().labels(*values, **kv)


class _HistogramChild:
    __slots__ = ("bounds", "counts", "sum", "count", "_lock")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = bounds
        # counts[i] is observations <= bounds[i]; the implicit +Inf bucket is
        # ``count`` itself (cumulative form is materialized at render time).
        self.counts = [0] * len(bounds)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.sum += value
            self.count += 1
            if i < len(self.bounds):
                self.counts[i] += 1

    def observe_many(self, values) -> None:
        """Bulk observation: one lock acquisition and one vectorized
        bucketing for a whole array (the per-client completion-time path
        observes thousands of samples per round — a Python loop of
        ``observe`` calls there would tax the round loop)."""
        import numpy as np

        arr = np.asarray(values, float).ravel()
        if arr.size == 0:
            return
        idx = np.searchsorted(self.bounds, arr, side="left")
        binned = np.bincount(idx, minlength=len(self.bounds) + 1)
        with self._lock:
            self.sum += float(arr.sum())
            self.count += int(arr.size)
            for i, c in enumerate(binned[:len(self.bounds)]):
                if c:
                    self.counts[i] += int(c)

    def cumulative(self) -> List[int]:
        """Per-bucket cumulative counts (Prometheus ``le`` semantics),
        excluding +Inf (which is ``count``)."""
        with self._lock:
            counts = list(self.counts)
        out, acc = [], 0
        for c in counts:
            acc += c
            out.append(acc)
        return out


class Histogram(Metric):
    kind = HISTOGRAM

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS, registry=None):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        if any(math.isinf(b) for b in bounds):
            # +Inf is implicit; an explicit one would double-render.
            bounds = tuple(b for b in bounds if not math.isinf(b))
        self.buckets = bounds
        super().__init__(name, help, label_names, registry=registry)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        if self._enabled:
            self._default_child().observe(value)

    def observe_many(self, values) -> None:
        if self._enabled:
            self._default_child().observe_many(values)

    def labels(self, *values: Any, **kv: Any) -> "_HistogramChild":
        return super().labels(*values, **kv)


_KINDS = {COUNTER: Counter, GAUGE: Gauge, HISTOGRAM: Histogram}


class MetricsRegistry:
    """Thread-safe name -> Metric map with idempotent registration.

    Re-registering the same (name, kind, labels) returns the existing
    instrument — modules register at import/constructor time and several
    components share one process registry. A name collision with a
    *different* schema raises: two meanings for one name is the lie no
    exporter can render.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[str, Metric] = {}

    # --------------------------------------------------------- registration
    def _register(self, kind: str, name: str, help: str,
                  label_names: Sequence[str], **kw) -> Metric:
        label_names = tuple(label_names)
        # Lock-free fast path: instrument() runs per metric event on hot
        # paths (publishes, dispatched batches, status writes), and dict
        # reads are atomic under the GIL — only genuine registration takes
        # the registry lock.
        existing = self._metrics.get(name)
        if existing is None:
            with self._lock:
                existing = self._metrics.get(name)
                if existing is None:
                    metric = _KINDS[kind](name, help, label_names,
                                          registry=self, **kw)
                    self._metrics[name] = metric
                    return metric
        if existing.kind != kind or existing.label_names != label_names:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{existing.kind}{existing.label_names}, "
                f"requested {kind}{label_names}"
            )
        return existing

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(COUNTER, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(GAUGE, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(HISTOGRAM, name, help, labels, buckets=buckets)

    # --------------------------------------------------------------- access
    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def retire_label_value(self, label_name: str, value: Any) -> int:
        """Drop every child series carrying ``label_name=value`` across all
        metrics — the retention lever for per-task labels in long-lived
        processes (call with ``("task_id", task_id)`` once a task's series
        no longer need scraping). Returns the number of series removed."""
        removed = 0
        for metric in self.metrics():
            if label_name in metric.label_names:
                removed += metric.remove_children(**{label_name: value})
        return removed

    def clear(self) -> None:
        """Drop every instrument (tests); registrants re-create on next use."""
        with self._lock:
            self._metrics.clear()


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide default sink (what instrumented modules use when no
    registry is injected)."""
    return _DEFAULT


def set_default_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (tests / embedding apps); returns the old
    one so callers can restore it."""
    global _DEFAULT
    old, _DEFAULT = _DEFAULT, registry
    return old
