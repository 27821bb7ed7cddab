"""Metric-name lint over the port: every registered metric obeys the
naming convention.

Checks (one finding per violation):

1. Every name in the port's ``telemetry.CATALOG`` matches
   ``ols_<subsystem>_<noun...>_<unit>``: lowercase snake_case, a known
   subsystem, a known unit suffix; counters end in ``_total``; histograms
   end in a base-unit suffix (``_seconds`` / ``_bytes``, ``_ratio`` for
   dimensionless distributions like normalized anomaly scores, or
   ``_rounds`` for discrete round/commit-count distributions like async
   staleness).
2. No duplicate registrations: a name may be declared once in CATALOG and
   never re-registered with a string literal elsewhere in the package.
3. Every ``instrument(<name>)`` call site in the package references a
   cataloged name (typo detection), and every cataloged name has at least
   one call site (dead metrics rot the docs).
4. Direct counter / gauge / histogram registrations of an ``ols_`` name
   outside ``telemetry/`` are flagged: platform code must go through the
   catalog.

Standalone: ``python -m olearning_sim_tpu_torch.analysis.check_metrics``.
"""

from __future__ import annotations

import os
import re
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SUBSYSTEMS = {
    "engine", "fedcore", "checkpoint", "deviceflow", "taskmgr",
    "resilience", "storage", "parallel", "models", "services", "telemetry",
    "perf", "phonemgr", "resourcemgr", "clustermgr", "supervisor",
}
UNITS = {
    "total", "seconds", "bytes", "ratio", "info", "depth", "batches",
    "messages", "clients", "rounds", "count",
    # Model quality (fraction correct in [0, 1]) — the convergence
    # tracker's eval gauge (ols_engine_eval_accuracy).
    "accuracy",
}
# Per-metric exemptions from the unit-suffix rule: names whose trailing
# token is part of a compound noun, not a unit. Each entry is a
# deliberate one-off (never a suffix pattern).
SUFFIX_EXEMPT = {
    # "rounds to target": the dimension is the middle token (rounds).
    "ols_engine_rounds_to_target",
}
NAME_RE = re.compile(r"^ols_[a-z0-9]+(_[a-z0-9]+)+$")

INSTRUMENT_RE = re.compile(r"instrument\(\s*[\"']([^\"']+)[\"']")
DIRECT_REG_RE = re.compile(
    r"\.(?:counter|gauge|histogram)\(\s*[\"'](ols_[^\"']+)[\"']"
)


def _py_files(root):
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def check(catalog=None, pkg=None) -> list:
    """Returns the list of violations (empty = clean). ``catalog`` and
    ``pkg`` inject a seeded catalog or source tree (tests); the defaults
    are the port's."""
    from olearning_sim_tpu_torch import telemetry

    if catalog is None:
        catalog = telemetry.CATALOG
    pkg = pkg or PKG
    problems = []
    for name, spec in catalog.items():
        kind = spec[0]
        if not NAME_RE.match(name):
            problems.append(f"{name}: not snake_case ols_<...> form")
            continue
        parts = name.split("_")
        if parts[1] not in SUBSYSTEMS:
            problems.append(
                f"{name}: unknown subsystem {parts[1]!r} "
                f"(known: {sorted(SUBSYSTEMS)})"
            )
        if parts[-1] not in UNITS and name not in SUFFIX_EXEMPT:
            problems.append(
                f"{name}: unit suffix {parts[-1]!r} not in {sorted(UNITS)}"
            )
        if kind == telemetry.COUNTER and not name.endswith("_total"):
            problems.append(f"{name}: counters must end in _total")
        if kind == telemetry.HISTOGRAM and parts[-1] not in (
                "seconds", "bytes", "ratio", "rounds"):
            problems.append(
                f"{name}: histograms must measure a base unit "
                f"(_seconds/_bytes, _ratio for dimensionless, or _rounds "
                f"for discrete round/commit counts)"
            )

    referenced = {}
    for path in _py_files(pkg):
        rel = os.path.relpath(path, os.path.dirname(pkg))
        with open(path, encoding="utf-8") as f:
            src = f.read()
        for m in INSTRUMENT_RE.finditer(src):
            referenced.setdefault(m.group(1), []).append(rel)
        if os.sep + "telemetry" + os.sep not in path:
            for m in DIRECT_REG_RE.finditer(src):
                if m.group(1) in catalog:
                    problems.append(
                        f"{rel}: re-registers cataloged metric "
                        f"{m.group(1)!r} directly; use instrument()"
                    )
                else:
                    problems.append(
                        f"{rel}: direct registration of {m.group(1)!r}; "
                        f"declare it in telemetry.CATALOG"
                    )

    for name, sites in sorted(referenced.items()):
        if name not in catalog:
            problems.append(
                f"instrument({name!r}) at {sites[0]} references an "
                f"uncataloged metric"
            )
    for name in catalog:
        if name not in referenced:
            problems.append(
                f"{name}: declared in CATALOG but never instrumented "
                f"(dead metric)"
            )
    return problems


def main() -> int:
    from olearning_sim_tpu_torch.telemetry import CATALOG

    problems = check()
    for p in problems:
        print(f"check_metrics: {p}", file=sys.stderr)
    if problems:
        print(f"check_metrics: {len(problems)} violation(s)", file=sys.stderr)
        return 1
    print(f"check_metrics: {len(CATALOG)} metrics OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
