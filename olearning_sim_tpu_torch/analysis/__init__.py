"""Repository analysers of the port: static guarantees over its source and
over the operations its round dispatches.

The JAX package analyses its compiled round program. Eager PyTorch compiles
nothing, but every round dispatches a sequence of aten operations, which a
``TorchDispatchMode`` records on the CPU; the port's analysers hold that
sequence to the same promises:

- :mod:`op_trace` — the recorder: each operation's name, output shapes,
  dtypes and bytes, the host syncs, and the port's own collectives.
- :mod:`grid` — the variant grid (JAX's variant names at JAX's tiny
  shapes), each round run under two settings of its per-round knobs inside
  the recorder, once per process.
- :mod:`op_audit` — per-variant budgets (collective bytes per kind, the
  largest tensor, the dtype census, host syncs) against ``budgets.json``.
- :mod:`retrace` — knobs are data: both settings dispatch the same
  operation sequence and the same collectives.
- :mod:`collectives_check` — the defended dp-2 round gathers no clients x
  params buffer.
- :mod:`ast_rules`, :mod:`check_metrics`, :mod:`check_event_kinds`,
  :mod:`check_injection_points` — source lints: wall-clock discipline,
  sqlite routing, a host-sync-free engine, no invisible exception
  swallows, the metric catalog, the event vocabulary and the injection
  points.
- :mod:`tp_coverage` — every mp > 1 task config shards at least half of
  its parameter elements.
- :mod:`convergence_gate` — a small fixed-seed convergence grid against
  its blessed envelopes (``convergence.json``).

:mod:`check_all` drives them all under uniform exit codes and a JSON
report: ``python -m olearning_sim_tpu_torch.analysis.check_all``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional


def run_analyzers(
    registry: Dict[str, Callable[[], List[str]]],
    only: Optional[List[str]] = None,
    skip: Optional[List[str]] = None,
) -> Dict[str, Dict]:
    """Run each ``name -> check()`` analyzer, timing it and catching
    internal errors, into a uniform report::

        {name: {"ok": bool, "problems": [...], "seconds": float,
                "error": str | None}}

    ``ok`` is False for both findings and crashes; ``error`` is set only
    when the analyzer itself raised (exit code 2 territory for drivers).
    """
    report: Dict[str, Dict] = {}
    for name, fn in registry.items():
        if only is not None and name not in only:
            continue
        if skip is not None and name in skip:
            continue
        t0 = time.perf_counter()
        problems: List[str] = []
        error = None
        try:
            problems = list(fn())
        except Exception as e:  # noqa: BLE001 — a crashed analyzer is a report entry
            error = f"{type(e).__name__}: {e}"
        report[name] = {
            "ok": error is None and not problems,
            "problems": problems,
            "seconds": round(time.perf_counter() - t0, 3),
            "error": error,
        }
    return report
