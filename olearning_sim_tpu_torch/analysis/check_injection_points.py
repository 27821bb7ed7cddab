"""Fault-injection-point lint over the port: every named injection point
the port consults must be documented and tested.

Checks (one finding per violation):

1. Every injection point consulted in the package — through the fault
   injector's ``fire`` / ``inject`` directly, or through the ``_call``
   retry seams (``ResilientFileRepo``, ``RoundCheckpointer``) that forward
   the name to the injector — is referenced in ``docs/resilience.md`` (the
   operator-facing chaos catalog).
2. Every such point appears as a string in at least one ``tests/*.py``
   file — an injection point nothing exercises is a chaos capability that
   silently rots.
3. The reverse: every ``x.y``-shaped point named in resilience.md's
   "Fault-injection points" section exists in the code (doc rot check).

Standalone: ``python -m olearning_sim_tpu_torch.analysis.check_injection_points``.
"""

from __future__ import annotations

import os
import re
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
TESTS = os.path.join(REPO, "tests")
DOC = os.path.join(REPO, "docs", "resilience.md")

# Direct consultations of the injector — \s* spans newlines, so wrapped
# call sites match too.
DIRECT_RE = re.compile(
    r"faults\.(?:fire|inject)\(\s*[\"']([a-z_]+(?:\.[a-z_]+)+)[\"']"
)
# Indirect seams: _call wrappers whose body forwards the point name to the
# injector (ResilientFileRepo, RoundCheckpointer).
SEAM_RE = re.compile(r"\._call\(\s*[\"']([a-z_]+(?:\.[a-z_]+)+)[\"']")
# Doc side: `point.name` code spans inside the Fault-injection points table.
DOC_POINT_RE = re.compile(r"`([a-z_]+(?:\.[a-z_]+)+)`")


def _py_files(root):
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def collect_points(pkg=None):
    """point name -> [package-relative call sites]."""
    points = {}
    root = pkg or PKG
    for path in _py_files(root):
        rel = os.path.relpath(path, os.path.dirname(root))
        with open(path, encoding="utf-8") as f:
            src = f.read()
        for regex in (DIRECT_RE, SEAM_RE):
            for m in regex.finditer(src):
                points.setdefault(m.group(1), []).append(rel)
    return points


def _doc_injection_section(doc_text: str) -> str:
    """The body of the '## Fault-injection points' section only (other
    sections legitimately mention x.y-shaped non-point names)."""
    m = re.search(r"^## Fault-injection points$(.*?)(?=^## )", doc_text,
                  re.MULTILINE | re.DOTALL)
    return m.group(1) if m else ""


def check(pkg=None, doc_path=None, tests_dir=None) -> list:
    """Returns the list of violations (empty = clean). The path
    parameters inject seeded trees (tests); defaults are the port's."""
    problems = []
    points = collect_points(pkg)
    if not points:
        return ["no injection points found — the collector regexes rotted"]

    doc_path = doc_path or DOC
    try:
        with open(doc_path, encoding="utf-8") as f:
            doc = f.read()
    except OSError as e:
        return [f"cannot read {doc_path}: {e}"]
    section = _doc_injection_section(doc)
    if not section:
        problems.append(
            "docs/resilience.md has no '## Fault-injection points' section"
        )
    doc_points = set(DOC_POINT_RE.findall(section))

    test_srcs = {}
    for path in _py_files(tests_dir or TESTS):
        with open(path, encoding="utf-8") as f:
            test_srcs[path] = f.read()

    for point, sites in sorted(points.items()):
        if point not in doc:
            problems.append(
                f"{point}: consulted at {sites[0]} but not documented in "
                f"docs/resilience.md"
            )
        if not any(point in src for src in test_srcs.values()):
            problems.append(
                f"{point}: consulted at {sites[0]} but exercised by no test "
                f"under tests/"
            )

    for point in sorted(doc_points - set(points)):
        problems.append(
            f"{point}: documented in docs/resilience.md's injection-point "
            f"table but no code consults it"
        )
    return problems


def main() -> int:
    problems = check()
    for p in problems:
        print(p)
    if problems:
        print(f"{len(problems)} injection-point lint violation(s)")
        return 1
    print(f"injection-point lint clean ({len(collect_points())} points)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
