"""One driver for every analyzer of the port.

====================  =====================================================
analyzer              what it guards
====================  =====================================================
ast_rules             repo invariants: wall-clock discipline, sqlite
                      routing, a host-sync-free round, no invisible
                      exception swallows (analysis/ast_rules)
metrics               telemetry naming and catalog (analysis/check_metrics)
event_kinds           resilience event vocabulary + docs
                      (analysis/check_event_kinds)
injection_points      chaos points documented + tested
                      (analysis/check_injection_points)
tp_coverage           every mp>1 task config shards >=50% of parameter
                      elements (analysis/tp_coverage; meta-device shapes)
convergence           model quality against the blessed envelopes
                      (analysis/convergence_gate; tens of seconds of tiny
                      training — --skip it for a quick pass)
collectives           the defended dp-2 round gathers no clients x params
                      buffer (analysis/collectives_check; shares the grid)
op_audit              per-variant budgets: collective bytes, largest
                      tensor, dtype census, host syncs against
                      analysis/budgets.json (analysis/op_audit)
retrace               per-round knobs are data: one operation sequence per
                      variant across knob settings (analysis/retrace)
====================  =====================================================

Exit codes: 0 = all clean, 1 = findings, 2 = an analyzer itself crashed.

Usage::

    python -m olearning_sim_tpu_torch.analysis.check_all
    python -m olearning_sim_tpu_torch.analysis.check_all --only ast_rules,metrics
    python -m olearning_sim_tpu_torch.analysis.check_all --skip convergence
    python -m olearning_sim_tpu_torch.analysis.check_all --json report.json
    python -m olearning_sim_tpu_torch.analysis.check_all --bless
    python -m olearning_sim_tpu_torch.analysis.check_all --list

The grid analyzers (collectives, op_audit, retrace) share one recording
of the variant grid (:mod:`~olearning_sim_tpu_torch.analysis.grid`): about
a minute on a CPU, most of it spawning the dp-2 and dp-2 x mp-2 worlds.
Everything measures on the CPU, where budgets.json and convergence.json
are blessed (the JAX package's driver forces its CPU platform the same
way); ``chip_smoke.py`` phase 19 runs the grid's dp-1 variants on the card
and phase 18a the convergence gate.
"""

from __future__ import annotations

import argparse
import json
import sys

GRID_ANALYZERS = ("collectives", "op_audit", "retrace")


def build_registry(grid_artifacts=None, start_grid=False):
    """name -> zero-arg check() callable, cheap analyzers first. The grid
    analyzers share one recording through a thunk (``grid_artifacts``
    injects a recorded grid — tests); ``start_grid`` starts the recording's
    worker worlds now, so that they record while the cheap analyzers run."""
    from olearning_sim_tpu_torch.analysis import (
        ast_rules,
        check_event_kinds,
        check_injection_points,
        check_metrics,
        collectives_check,
        convergence_gate,
        op_audit,
        retrace,
        tp_coverage,
    )

    from olearning_sim_tpu_torch.analysis import grid

    cache = {"arts": grid_artifacts, "recording": None}
    if grid_artifacts is None and start_grid:
        cache["recording"] = grid.GridRecording(progress=_progress)

    def arts():
        if cache["arts"] is None:
            recording = cache["recording"] or grid.GridRecording(progress=_progress)
            cache["arts"] = recording.artifacts()
        return cache["arts"]

    return {
        "ast_rules": ast_rules.check,
        "metrics": check_metrics.check,
        "event_kinds": check_event_kinds.check,
        "injection_points": check_injection_points.check,
        "tp_coverage": tp_coverage.check,
        "convergence": lambda: convergence_gate.check(device="cpu"),
        "collectives": lambda: collectives_check.check(arts()[collectives_check.VARIANT]),
        "op_audit": lambda: op_audit.check(artifacts_by_name=arts()),
        "retrace": lambda: retrace.check(artifacts_by_name=arts()),
    }


def _progress(name):
    print(f"  recording {name}", file=sys.stderr)


def run(only=None, skip=None, grid_artifacts=None):
    """(report dict, exit code). See the module docstring for the codes."""
    from olearning_sim_tpu_torch.analysis import run_analyzers

    names = list(build_registry(grid_artifacts={}))
    unknown = [n for n in (only or []) + (skip or []) if n not in names]
    if unknown:
        raise SystemExit(
            f"check_all: unknown analyzer(s) {unknown}; "
            f"known: {', '.join(names)}"
        )
    wanted = [n for n in names if (only is None or n in only)
              and (skip is None or n not in skip)]
    registry = build_registry(grid_artifacts,
                              start_grid=any(n in GRID_ANALYZERS for n in wanted))
    report = run_analyzers(registry, only=only, skip=skip)
    if any(r["error"] for r in report.values()):
        code = 2
    elif any(not r["ok"] for r in report.values()):
        code = 1
    else:
        code = 0
    return report, code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m olearning_sim_tpu_torch.analysis.check_all",
        description="run all analyzers of the port (see the module docstring)")
    ap.add_argument("--only", default=None,
                    help="comma-separated analyzer names to run")
    ap.add_argument("--skip", default=None,
                    help="comma-separated analyzer names to skip")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the machine-readable report here")
    ap.add_argument("--list", action="store_true",
                    help="list analyzer names and exit")
    ap.add_argument("--bless", action="store_true",
                    help="re-record the variant grid and rewrite "
                         "analysis/budgets.json (after an INTENTIONAL change "
                         "to what a round dispatches; commit the diff)")
    ap.add_argument("--bless-convergence", action="store_true",
                    help="re-run the convergence gate grid and rewrite "
                         "analysis/convergence.json (after an INTENTIONAL "
                         "quality change; commit the diff)")
    args = ap.parse_args(argv)

    if args.list:
        for name in build_registry(grid_artifacts={}):
            print(name)
        return 0
    if args.bless:
        from olearning_sim_tpu_torch.analysis import grid, op_audit

        budgets = op_audit.bless(grid.grid_artifacts())
        print(f"check_all: blessed {len(budgets['variants'])} variants "
              f"-> {op_audit.BUDGETS_PATH}")
        return 0
    if args.bless_convergence:
        from olearning_sim_tpu_torch.analysis import convergence_gate

        envelopes = convergence_gate.bless(device="cpu")
        print(f"check_all: blessed {len(envelopes['entries'])} convergence "
              f"entries -> {convergence_gate.ENVELOPES_PATH}")
        return 0

    only = args.only.split(",") if args.only else None
    skip = args.skip.split(",") if args.skip else None
    report, code = run(only=only, skip=skip)

    width = max(len(n) for n in report) if report else 0
    for name, r in report.items():
        if r["error"]:
            status = f"ERROR ({r['error']})"
        elif r["ok"]:
            status = "ok"
        else:
            status = f"{len(r['problems'])} finding(s)"
        print(f"check_all: {name:<{width}}  {status}  [{r['seconds']}s]")
        for p in r["problems"]:
            print(f"  {name}: {p}", file=sys.stderr)

    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"ok": code == 0, "exit_code": code,
                       "analyzers": report}, f, indent=1)
            f.write("\n")
        print(f"check_all: report -> {args.json}")
    print(f"check_all: {'CLEAN' if code == 0 else 'FAILED'} (exit {code})")
    return code


if __name__ == "__main__":
    sys.exit(main())
