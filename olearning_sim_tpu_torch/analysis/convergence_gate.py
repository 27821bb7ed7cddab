"""Convergence gate: model quality regressions fail like broken tests.

A port of the JAX package's ``analysis/convergence_gate.py`` over the
port's :func:`~olearning_sim_tpu_torch.engine.convergence.run_convergence_task`.
It runs a small fixed-seed convergence grid and diffs each entry's
deterministic record against the blessed envelopes in
``analysis/convergence.json`` (the port's own, blessed from its CPU run):

====================  ===================================================
entry                 engine config
====================  ===================================================
clean                 plain fedavg (the quality baseline)
async_staleness       buffered async commits, polynomial staleness
                      discount
attack_trimmed_mean   20% scale-factor-30 attackers + clip/trimmed-mean
                      defense — the defended entry must stay near the
                      clean baseline
attack_undefended     the same attack with NO defense — pins the attack's
                      measured damage (an attack that stops biting is also
                      a regression: the defended entry would pass
                      vacuously)
drift_trace           scenario label drift, resident execution
====================  ===================================================

Compared fields (per-entry tolerance, ``tolerances`` in the envelope
file, overridable per entry): ``final_accuracy`` / ``best_accuracy`` /
``accuracy_at_round_budget`` within ± ``accuracy``; ``reached`` must
match; ``rounds_to_target`` within ± ``rounds_to_target``. Wall-clock
fields are never compared (measured, non-deterministic); simulated-time
fields are recorded unenforced.

Run it with ``python -m olearning_sim_tpu_torch.analysis.convergence_gate
[--only a,b] [--device cpu]`` (the card by default); re-bless after an
INTENTIONAL quality change with ``--bless`` (on the CPU unless
``--device`` says otherwise) and commit the diff.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

ENVELOPES_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "convergence.json")

# |fresh - blessed| may not exceed these. The headroom absorbs the float
# reassociation between the CPU the envelopes are blessed on and the card,
# without letting a real quality regression (attacks move accuracy by
# >0.1) through.
DEFAULT_TOLERANCES = {
    "accuracy": 0.05,
    "rounds_to_target": 2,
}

# One shared tiny family: learnable blob population, fixed seeds, a
# budget small enough that the whole grid stays well under a minute. The
# JAX package's grid but for the seed, for two reasons found at its seed 3
# with both harnesses started from the same parameters and minibatch
# draws. (1) The undefended entry's best accuracy lands on either side of
# the 0.7 target in the two packages (0.7051 and 0.6992), and ``reached``
# has no tolerance: the attack's 30x scale amplifies their different bf16
# rounding round over round; with both models in f32 the two records are
# equal. (2) The defense moves the attacked entry's final accuracy by less
# than the gate's tolerance there (0.6934 against 0.6992 in the port, 0.6816
# in JAX), so switching it off would pass. At seed 2 the two packages agree
# on every entry, and switching the defense off moves that accuracy by
# twice the tolerance.
GATE_BASE = dict(
    seed=2, num_clients=64, n_local=8, input_shape=(16,), num_classes=4,
    class_sep=2.0, eval_n=512, rounds=12, batch=4, local_steps=4,
    block_clients=16, hidden=(16,), local_lr=0.3,
)
GATE_CONVERGENCE = {
    "target_accuracy": 0.7,
    "eval_every": 1,
    "round_budget": 8,
}

# A scale attack big enough that the undefended run measurably degrades
# while clip + trimmed-mean holds the defended run near the clean baseline.
_ATTACK = {"mode": "scale", "factor": 30.0, "fraction": 0.2}

GATE_ENTRIES: Dict[str, Dict] = {
    "clean": {},
    "async_staleness": {
        "async_config": {"buffer_size": 16, "schedule": "polynomial",
                         "staleness_alpha": 0.5, "default_step_s": 0.05,
                         "jitter": 0.2},
    },
    "attack_trimmed_mean": {
        "attack": dict(_ATTACK),
        "defense": {"clip_norm": 5.0, "aggregator": "trimmed_mean",
                    "trim_fraction": 0.25},
    },
    "attack_undefended": {
        "attack": dict(_ATTACK),
    },
    "drift_trace": {
        "scenario": {"drift_period_rounds": 4, "round_seconds": 600.0},
    },
}

# Deterministic accuracy fields diffed against the envelope; simulated
# clocks are recorded unenforced (they move with pacing-config edits that
# are not quality regressions).
ACCURACY_FIELDS = ("final_accuracy", "best_accuracy",
                   "accuracy_at_round_budget")
RECORDED_FIELDS = ACCURACY_FIELDS + (
    "target_accuracy", "reached", "rounds_to_target",
    "sim_seconds_to_target", "sim_seconds_total",
    "device_rounds_committed", "accuracy_per_1k_device_rounds",
)


def run_entry(name: str, overrides: Optional[Dict] = None,
              device="cuda") -> Dict:
    """Run one gate entry end-to-end on ``device``; returns its convergence
    record. ``overrides`` merges into the entry's engine-config kwargs (a
    test's planted regression: ``{"defense": None}``, an aggressive
    ``staleness_alpha``, ...)."""
    from olearning_sim_tpu_torch.engine.convergence import run_convergence_task

    spec = dict(GATE_ENTRIES[name])
    for k, v in (overrides or {}).items():
        if v is None:
            spec.pop(k, None)
        elif isinstance(v, dict) and isinstance(spec.get(k), dict):
            spec[k] = {**spec[k], **v}
        else:
            spec[k] = v
    return run_convergence_task(
        name=name, convergence=dict(GATE_CONVERGENCE), device=device,
        **GATE_BASE, **spec,
    )


def _envelope_entry(record: Dict) -> Dict:
    return {k: record.get(k) for k in RECORDED_FIELDS}


def compare(name: str, measured: Dict, golden: Dict,
            tolerances: Optional[Dict] = None) -> List[str]:
    """Findings for one entry: fresh record vs its blessed envelope."""
    tol = dict(DEFAULT_TOLERANCES)
    tol.update(tolerances or {})
    tol.update(golden.get("tolerances") or {})
    problems = []
    for field in ACCURACY_FIELDS:
        m, g = measured.get(field), golden.get(field)
        if m is None or g is None:
            if m != g:
                problems.append(
                    f"{name}: {field} is "
                    f"{'missing' if m is None else m} but the envelope "
                    f"says {g} — the eval series changed shape; re-bless "
                    f"if intentional"
                )
            continue
        if abs(float(m) - float(g)) > tol["accuracy"]:
            direction = "degraded" if m < g else "moved"
            problems.append(
                f"{name}: {field} {direction} to {float(m):.4f} (blessed "
                f"{float(g):.4f}, tolerance ±{tol['accuracy']}) — a "
                f"change shifted this entry's model quality; fix it or "
                f"re-bless with the diff justified"
            )
    if bool(measured.get("reached")) != bool(golden.get("reached")):
        problems.append(
            f"{name}: target {GATE_CONVERGENCE['target_accuracy']} "
            f"reached={bool(measured.get('reached'))} vs blessed "
            f"reached={bool(golden.get('reached'))} — the entry "
            f"{'no longer' if golden.get('reached') else 'suddenly'} "
            f"converges to target within the budget"
        )
    else:
        m_r, g_r = measured.get("rounds_to_target"), \
            golden.get("rounds_to_target")
        if m_r is not None and g_r is not None and \
                abs(int(m_r) - int(g_r)) > tol["rounds_to_target"]:
            problems.append(
                f"{name}: rounds_to_target moved to {m_r} (blessed {g_r}, "
                f"tolerance ±{tol['rounds_to_target']}) — time-to-accuracy "
                f"shifted; fix it or re-bless"
            )
    return problems


def load_envelopes(path: Optional[str] = None) -> Dict:
    with open(path or ENVELOPES_PATH, encoding="utf-8") as f:
        return json.load(f)


def check(only: Optional[List[str]] = None,
          overrides: Optional[Dict[str, Dict]] = None,
          envelopes: Optional[Dict] = None,
          envelopes_path: Optional[str] = None,
          device="cuda") -> List[str]:
    """Run the gate grid (or the ``only`` subset) on ``device`` and diff
    against the blessed envelopes; returns findings (empty = clean).
    ``overrides`` plants per-entry engine-config changes (the
    seeded-regression tests prove the gate bites)."""
    if envelopes is None:
        try:
            envelopes = load_envelopes(envelopes_path)
        except OSError as e:
            return [
                f"cannot read blessed convergence envelopes ({e}); "
                f"generate with `python -m "
                f"olearning_sim_tpu_torch.analysis.convergence_gate --bless`"
            ]
    entries = envelopes.get("entries", {})
    tolerances = envelopes.get("tolerances")
    names = list(GATE_ENTRIES) if only is None else list(only)
    unknown = [n for n in names if n not in GATE_ENTRIES]
    if unknown:
        raise ValueError(
            f"unknown convergence-gate entries {unknown} "
            f"(known: {sorted(GATE_ENTRIES)})"
        )
    problems: List[str] = []
    for name in names:
        golden = entries.get(name)
        if golden is None:
            problems.append(
                f"{name}: entry missing from convergence.json — bless the "
                f"grid (`python -m "
                f"olearning_sim_tpu_torch.analysis.convergence_gate --bless`)"
            )
            continue
        record = run_entry(name, (overrides or {}).get(name), device=device)
        problems.extend(compare(name, record, golden, tolerances))
    if only is None:
        for stale in sorted(set(entries) - set(GATE_ENTRIES)):
            problems.append(
                f"{stale}: envelope entry no longer in the gate grid — "
                f"remove it (re-bless)"
            )
    return problems


def bless(path: Optional[str] = None, device="cpu") -> Dict:
    """Run the full grid on ``device`` and (re)write the blessed envelope
    file. Hand-added per-entry ``tolerances`` overrides in the existing file
    survive the re-bless (they are configuration, not measurement)."""
    out = path or ENVELOPES_PATH
    prior_tol: Dict[str, Dict] = {}
    try:
        for name, entry in load_envelopes(out).get("entries", {}).items():
            if entry.get("tolerances"):
                prior_tol[name] = entry["tolerances"]
    except (OSError, ValueError):
        pass
    envelopes = {
        "_comment": (
            "Blessed convergence envelopes per (family x engine-config) "
            "gate entry, from the port's CPU run. Regenerate with `python -m "
            "olearning_sim_tpu_torch.analysis.convergence_gate --bless` "
            "after an INTENTIONAL quality change and commit the diff."
        ),
        "tolerances": dict(DEFAULT_TOLERANCES),
        "base": {**GATE_BASE, "input_shape": list(GATE_BASE["input_shape"]),
                 "hidden": list(GATE_BASE["hidden"]),
                 "convergence": dict(GATE_CONVERGENCE)},
        "entries": {
            name: {**_envelope_entry(run_entry(name, device=device)),
                   **({"tolerances": prior_tol[name]}
                      if name in prior_tol else {})}
            for name in GATE_ENTRIES
        },
    }
    with open(out, "w", encoding="utf-8") as f:
        json.dump(envelopes, f, indent=1, sort_keys=True)
        f.write("\n")
    return envelopes


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m olearning_sim_tpu_torch.analysis.convergence_gate")
    parser.add_argument("--bless", action="store_true",
                        help="rewrite convergence.json from a fresh run")
    parser.add_argument("--only", default=None,
                        help="comma-separated entries to check")
    parser.add_argument("--device", default=None,
                        help="cuda (the default when checking) or cpu (the "
                             "default when blessing)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.bless:
        envelopes = bless(device=args.device or "cpu")
        print(f"convergence_gate: blessed {len(envelopes['entries'])} "
              f"entries -> {ENVELOPES_PATH}")
        return 0
    only = args.only.split(",") if args.only else None
    problems = check(only=only, device=args.device or "cuda")
    for p in problems:
        print(f"convergence_gate: {p}", file=sys.stderr)
    if problems:
        print(f"convergence_gate: {len(problems)} violation(s)",
              file=sys.stderr)
        return 1
    print("convergence_gate: OK — quality within blessed envelopes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
