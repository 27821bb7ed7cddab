"""Resilience event-kind lint over the port: every event kind the port
emits must be declared in ``resilience/events.py`` and documented in
``docs/resilience.md`` (an undeclared kind silently fragments the
``ols_resilience_events_total{kind}`` label space and never shows up in
the operator docs).

Checks (one finding per violation):

1. Every event-log record call in the package names a kind declared in
   ``resilience/events.py`` as its first argument — either an imported
   UPPER_CASE constant defined there, or a string literal equal to a
   declared kind's value.
2. Every declared kind is documented (its snake_case value appears) in
   ``docs/resilience.md``.
3. The reverse doc-rot check: every declared kind is actually emitted
   somewhere in the package (a kind nothing records is dead vocabulary).

Standalone: ``python -m olearning_sim_tpu_torch.analysis.check_event_kinds``.
"""

from __future__ import annotations

import os
import re
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
EVENTS = os.path.join(PKG, "resilience", "events.py")
DOC = os.path.join(REPO, "docs", "resilience.md")

# Declarations: module-level UPPER = "snake_case" assignments in events.py.
DECL_RE = re.compile(r"^([A-Z][A-Z_0-9]*)\s*=\s*\"([a-z_]+)\"", re.MULTILINE)
# Emissions: a record call's first argument — constant name or string
# literal. \s* spans newlines so wrapped call sites match.
RECORD_RE = re.compile(
    r"\.record\(\s*(?:([A-Z][A-Z_0-9]*)|[\"']([a-z_]+)[\"'])"
)


def _py_files(root):
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def declared_kinds(events=None):
    """constant name -> kind value, from resilience/events.py (or an
    injected declarations file — seeded-violation tests)."""
    with open(events or EVENTS, encoding="utf-8") as f:
        src = f.read()
    return {m.group(1): m.group(2) for m in DECL_RE.finditer(src)}


def emitted_kinds(pkg=None):
    """(constant-or-None, literal-or-None) -> [package-relative call sites]."""
    emissions = {}
    root = pkg or PKG
    for path in _py_files(root):
        rel = os.path.relpath(path, os.path.dirname(root))
        with open(path, encoding="utf-8") as f:
            src = f.read()
        for m in RECORD_RE.finditer(src):
            emissions.setdefault((m.group(1), m.group(2)), []).append(rel)
    return emissions


def check(events=None, doc_path=None, pkg=None) -> list:
    """Returns the list of violations (empty = clean). The path
    parameters inject seeded trees (tests); defaults are the port's."""
    problems = []
    decls = declared_kinds(events)
    if not decls:
        return ["no event kinds declared — the events.py regex rotted"]
    doc_path = doc_path or DOC
    try:
        with open(doc_path, encoding="utf-8") as f:
            doc = f.read()
    except OSError as e:
        return [f"cannot read {doc_path}: {e}"]

    emitted_values = set()
    for (const, literal), sites in sorted(emitted_kinds(pkg).items(),
                                          key=lambda kv: (kv[0][0] or "",
                                                          kv[0][1] or "")):
        if const is not None:
            if const not in decls:
                problems.append(
                    f"{const}: recorded at {sites[0]} but not declared in "
                    f"resilience/events.py"
                )
            else:
                emitted_values.add(decls[const])
        else:
            if literal not in decls.values():
                problems.append(
                    f"\"{literal}\": recorded as a literal at {sites[0]} but "
                    f"not declared in resilience/events.py"
                )
            else:
                emitted_values.add(literal)

    for const, value in sorted(decls.items()):
        if f"`{value}`" not in doc and value not in doc:
            problems.append(
                f"{const} (\"{value}\"): declared in resilience/events.py "
                f"but not documented in docs/resilience.md"
            )
        if value not in emitted_values:
            problems.append(
                f"{const} (\"{value}\"): declared in resilience/events.py "
                f"but nothing in the package records it (dead kind)"
            )
    return problems


def main() -> int:
    problems = check()
    for p in problems:
        print(p)
    if problems:
        print(f"{len(problems)} event-kind lint violation(s)")
        return 1
    print(f"event-kind lint clean ({len(declared_kinds())} kinds)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
