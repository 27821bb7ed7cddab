"""Exporters: Prometheus text exposition, JSON snapshots, HTTP endpoint.

Everything stdlib: the scrape endpoint is a ``http.server`` on a daemon
thread (good enough for a per-host scrape target; production deployments can
front it with anything). The render format follows the Prometheus
text-exposition spec v0.0.4:

- ``# HELP`` / ``# TYPE`` per family;
- histograms render cumulative ``_bucket{le=...}`` series plus ``_sum`` /
  ``_count``; the ``+Inf`` bucket equals ``_count``;
- label values are escaped (backslash, double-quote, newline).

The JSON snapshot is the bench-artifact form: one dict per metric with kind,
labels, and values — stable keys so BENCH records diff cleanly across runs.

A copy of the JAX package's ``telemetry/exporters.py`` over the port's
``telemetry/metrics.py``: equal registries render byte-equal text in both
packages.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Any, Dict, List, Optional

from olearning_sim_tpu_torch.telemetry.metrics import (
    COUNTER,
    GAUGE,
    HISTOGRAM,
    MetricsRegistry,
    default_registry,
)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(names, values, extra: Optional[List[tuple]] = None) -> str:
    pairs = [(n, v) for n, v in zip(names, values)]
    if extra:
        pairs += extra
    if not pairs:
        return ""
    body = ",".join(f'{n}="{_escape_label_value(str(v))}"' for n, v in pairs)
    return "{" + body + "}"


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """The full registry in Prometheus text-exposition format."""
    registry = registry if registry is not None else default_registry()
    lines: List[str] = []
    for metric in registry.metrics():
        if metric.help:
            lines.append(f"# HELP {metric.name} {metric.help}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        for key, child in metric.children():
            if metric.kind in (COUNTER, GAUGE):
                lines.append(
                    f"{metric.name}"
                    f"{_labels_str(metric.label_names, key)} "
                    f"{_fmt(child.value)}"
                )
            elif metric.kind == HISTOGRAM:
                for bound, cum in zip(child.bounds, child.cumulative()):
                    lines.append(
                        f"{metric.name}_bucket"
                        f"{_labels_str(metric.label_names, key, [('le', _fmt(bound))])} "
                        f"{cum}"
                    )
                lines.append(
                    f"{metric.name}_bucket"
                    f"{_labels_str(metric.label_names, key, [('le', '+Inf')])} "
                    f"{child.count}"
                )
                lines.append(
                    f"{metric.name}_sum"
                    f"{_labels_str(metric.label_names, key)} {_fmt(child.sum)}"
                )
                lines.append(
                    f"{metric.name}_count"
                    f"{_labels_str(metric.label_names, key)} {child.count}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot(registry: Optional[MetricsRegistry] = None) -> Dict[str, Any]:
    """JSON-ready dump of every instrument (bench.py artifact form)."""
    registry = registry if registry is not None else default_registry()
    out: Dict[str, Any] = {}
    for metric in registry.metrics():
        series = []
        for key, child in metric.children():
            labels = dict(zip(metric.label_names, key))
            if metric.kind == HISTOGRAM:
                series.append({
                    "labels": labels,
                    "count": child.count,
                    "sum": child.sum,
                    "buckets": {
                        _fmt(b): c
                        for b, c in zip(child.bounds, child.cumulative())
                    },
                })
            else:
                series.append({"labels": labels, "value": child.value})
        out[metric.name] = {
            "kind": metric.kind,
            "help": metric.help,
            "series": series,
        }
    return out


def dump_json(path: str, registry: Optional[MetricsRegistry] = None) -> str:
    """Write the JSON snapshot to ``path`` (bench artifacts); returns it."""
    import os

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(snapshot(registry), f, indent=1, sort_keys=True)
    return path


class MetricsHTTPServer:
    """Minimal scrape endpoint: ``GET /metrics`` (Prometheus text) and
    ``GET /metrics.json`` (snapshot) on a daemon thread.

    ``port=0`` binds an ephemeral port (tests); the bound port is
    ``server.port`` after :meth:`start`.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        self.host = host
        self.port = port
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsHTTPServer":
        import http.server

        registry = self.registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib API
                path = self.path.split("?", 1)[0]
                if path in ("/metrics", "/"):
                    body = render_prometheus(registry).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/metrics.json":
                    body = json.dumps(snapshot(registry)).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet: scrapes are periodic
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler
        )
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ols-metrics-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "MetricsHTTPServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
