"""Repo-invariant AST lints over the port: the invariants this codebase
learned the hard way, enforced so they stay learned.

Rules (each with its waiver marker; see WAIVERS for the policy):

- **wall-clock** — no ``time.time()`` outside ``utils/clocks.py``.
  Wall-clock steps (NTP, manual set, VM migration) once made polling
  barriers stall or expire instantly; interval math must use
  ``utils.clocks``. The ONLY legitimate wall-clock sites are the persisted
  lease/queue timestamps compared ACROSS processes (monotonic clocks have
  per-process epochs) — those carry explicit waivers.
- **sqlite-connect** — no ``sqlite3.connect`` outside ``utils/repo.py``.
  Raw connections skip WAL + busy_timeout and deadlock concurrent writers
  (every site goes through ``connect_sqlite``).
- **host-sync** — inside ``engine/fedcore.py`` / ``engine/defense.py``, no
  ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()`` on anything, no
  ``torch.cuda.synchronize`` (through any alias) and no ``.synchronize()``
  of a tensor, stream or event. Each waits for the card; the round must
  stay asynchronously launched, and host syncs belong in the runner, which
  accounts them as the ``host_transfer`` phase.
- **silent-except** — no ``except Exception: pass`` (or bare /
  ``BaseException``) without a waiver. An invisible swallow turns
  degraded-path failures into unobservable no-ops; either narrow it, log
  it, or waive it with a rationale.

Waiver policy: a flagged line is waived ONLY when (a) the line (or its
neighbor) carries the rule's marker comment AND (b) the file is listed in
WAIVERS with a rationale. A marker in an unlisted file, or a WAIVERS entry
with no live marker, is itself a violation — intentional sites are
documented, not invisible, and the table cannot rot.

Standalone: ``python -m olearning_sim_tpu_torch.analysis.ast_rules``.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
PKG_NAME = "olearning_sim_tpu_torch"

# Built by concatenation so this module's own strings never read as live
# waiver markers to the orphan-marker scan.
_M = "lint: " + "allow-"
MARKERS = {
    "wall-clock": _M + "wall-clock",
    "sqlite-connect": _M + "sqlite",
    "host-sync": _M + "host-sync",
    "silent-except": _M + "silent",
}

# Files a rule never applies to (the blessed implementation homes).
EXEMPT = {
    "wall-clock": {f"{PKG_NAME}/utils/clocks.py"},
    "sqlite-connect": {f"{PKG_NAME}/utils/repo.py"},
}

# host-sync applies ONLY inside the round's modules.
HOST_SYNC_SCOPE = (
    f"{PKG_NAME}/engine/fedcore.py",
    f"{PKG_NAME}/engine/defense.py",
)

# Method calls that wait for the card, on any receiver.
HOST_SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")

# rule -> {repo-relative file: rationale}. The ONLY files where that
# rule's marker is legal; every entry must have at least one live marker.
WAIVERS: Dict[str, Dict[str, str]] = {
    "wall-clock": {
        f"{PKG_NAME}/taskmgr/task_repo.py":
            "lease claim/renew/expiry timestamps are persisted in the task "
            "table and compared across processes; monotonic clocks have "
            "per-process epochs, so cross-process lease math MUST be "
            "wall-clock",
        f"{PKG_NAME}/taskmgr/task_manager.py":
            "heartbeat renewal, stranded-task adoption and the interrupt "
            "watchdog compare against repo-persisted wall-clock lease/queue "
            "timestamps written by other processes",
        f"{PKG_NAME}/supervisor/supervisor.py":
            "lease-expiry scans compare repo-persisted wall-clock "
            "timestamps written by the owning worker process",
        f"{PKG_NAME}/taskmgr/pool.py":
            "planned migration renews the cross-process wall-clock lease "
            "and stamps the durable supervision ledger's last_resume_ts, "
            "both compared by other processes (supervisor backoff math)",
        f"{PKG_NAME}/clustermgr/launcher.py":
            "the launch time is handed to worker processes in "
            "OLS_LAUNCH_TIME; a monotonic clock's epoch is its own "
            "process's, so the spawn cost across processes needs the wall "
            "clock",
        f"{PKG_NAME}/clustermgr/worker.py":
            "the worker's start is compared with the launcher's "
            "OLS_LAUNCH_TIME, a wall-clock stamp from another process",
    },
    "silent-except": {
        f"{PKG_NAME}/utils/repo.py":
            "rollback/close during connection recycling: cleanup of an "
            "already-failed connection; the original error is re-raised "
            "after the second attempt",
        f"{PKG_NAME}/supervisor/supervisor.py":
            "a deviceflow hiccup during finalization must not block it "
            "forever; the scan retries on a later pass",
    },
    "sqlite-connect": {},
    "host-sync": {
        f"{PKG_NAME}/engine/fedcore.py":
            "draw_indices draws the round's minibatch indices on the CPU "
            "generator, a function of (seed, round, stream) alone, so a "
            "resumed or re-sharded run draws what the original did (the RNG "
            "contract); it reads each client's sample count on the host. "
            "Callers that must not sync hand round_step indices drawn "
            "before the round",
    },
}


def _py_files(root: str):
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


class _ImportMap(ast.NodeVisitor):
    """local alias -> module ("import time as t"), and
    local name -> (module, original) ("from time import time")."""

    def __init__(self):
        self.modules: Dict[str, str] = {}
        self.froms: Dict[str, Tuple[str, str]] = {}

    def visit_Import(self, node):
        for a in node.names:
            if a.asname:
                self.modules[a.asname] = a.name
            else:
                # "import torch.cuda" binds "torch" to the package.
                top = a.name.split(".")[0]
                self.modules[top] = top

    def visit_ImportFrom(self, node):
        for a in node.names:
            if node.module:
                self.froms[a.asname or a.name] = (node.module, a.name)


def _dotted(node, imports: _ImportMap) -> Optional[str]:
    """The module path a Name/Attribute chain resolves to through the
    file's imports (``tc.synchronize`` with ``import torch.cuda as tc`` ->
    ``torch.cuda.synchronize``), or None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    if node.id in imports.modules:
        head = imports.modules[node.id]
    elif node.id in imports.froms:
        mod, name = imports.froms[node.id]
        head = f"{mod}.{name}"
    else:
        return None
    return ".".join([head] + parts[::-1])


def _is_module_call(node: ast.Call, imports: _ImportMap,
                    module: str, attr: str) -> bool:
    """``module.attr(...)`` through any alias, or ``from module import
    attr`` used bare."""
    return _dotted(node.func, imports) == f"{module}.{attr}"


def _is_host_sync(node: ast.Call, imports: _ImportMap) -> bool:
    f = node.func
    if _is_module_call(node, imports, "torch.cuda", "synchronize"):
        return True
    return isinstance(f, ast.Attribute) and f.attr in HOST_SYNC_METHODS


def _is_silent_handler(node: ast.ExceptHandler) -> bool:
    """``except [Exception|BaseException|<bare>]: pass`` exactly."""
    if not (len(node.body) == 1 and isinstance(node.body[0], ast.Pass)):
        return False
    t = node.type
    if t is None:
        return True
    names = []
    for n in ast.walk(t):  # covers Name, Attribute tails, and tuples
        if isinstance(n, ast.Name):
            names.append(n.id)
        elif isinstance(n, ast.Attribute):
            names.append(n.attr)
    return any(n in ("Exception", "BaseException") for n in names)


def lint_source(src: str, relpath: str) -> List[Dict]:
    """All rule hits in one file's source, waivers NOT yet applied:
    ``[{"rule", "line", "message"}]``. ``check()`` applies the waiver
    policy on top; tests feed planted snippets straight in."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [{"rule": "parse", "line": e.lineno or 0,
                 "message": f"unparseable: {e.msg}"}]
    imports = _ImportMap()
    imports.visit(tree)
    hits: List[Dict] = []
    in_scope_host = relpath in HOST_SYNC_SCOPE
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            if relpath not in EXEMPT["wall-clock"] \
                    and _is_module_call(node, imports, "time", "time"):
                hits.append({
                    "rule": "wall-clock", "line": node.lineno,
                    "message": "time.time() outside utils/clocks.py — use "
                               "utils.clocks for interval math, or waive "
                               "a genuine cross-process wall-clock site",
                })
            if relpath not in EXEMPT["sqlite-connect"] \
                    and _is_module_call(node, imports, "sqlite3", "connect"):
                hits.append({
                    "rule": "sqlite-connect", "line": node.lineno,
                    "message": "raw sqlite3.connect outside utils/repo.py "
                               "— route through utils.repo.connect_sqlite "
                               "(WAL + busy_timeout)",
                })
            if in_scope_host and _is_host_sync(node, imports):
                hits.append({
                    "rule": "host-sync", "line": node.lineno,
                    "message": "host sync inside the round's module — "
                               ".item()/.tolist()/.cpu()/.numpy()/"
                               "synchronize belong in the runner "
                               "(host_transfer phase)",
                })
        elif isinstance(node, ast.ExceptHandler) \
                and _is_silent_handler(node):
            hits.append({
                "rule": "silent-except", "line": node.lineno,
                "message": "except Exception: pass — narrow it, log it, or "
                           "waive it with a rationale (degraded paths must "
                           "be observable)",
            })
    return hits


def _marker_lines(lines: List[str], marker: str) -> List[int]:
    """1-based line numbers whose comment text carries the marker."""
    out = []
    for i, line in enumerate(lines, 1):
        if "#" in line and marker in line.split("#", 1)[1]:
            out.append(i)
    return out


def check(pkg_root: Optional[str] = None,
          waivers: Optional[Dict[str, Dict[str, str]]] = None) -> List[str]:
    """Lint the whole package, applying the waiver policy; returns
    findings (empty = clean)."""
    root = pkg_root or os.path.join(REPO, PKG_NAME)
    waivers = WAIVERS if waivers is None else waivers
    self_rel = f"{PKG_NAME}/analysis/ast_rules.py"
    problems: List[str] = []
    used_waiver_files = {rule: set() for rule in MARKERS}
    for path in _py_files(root):
        rel = os.path.relpath(path, os.path.dirname(root)).replace(
            os.sep, "/")
        with open(path, encoding="utf-8") as f:
            src = f.read()
        lines = src.splitlines()
        marker_lines = {rule: set(_marker_lines(lines, marker))
                        for rule, marker in MARKERS.items()}
        consumed: set = set()
        for hit in lint_source(src, rel):
            rule = hit["rule"]
            if rule == "parse":
                problems.append(f"{rel}:{hit['line']}: {hit['message']}")
                continue
            # A marker waives the flagged line itself, the line after
            # (the `pass` of an except), or a comment up to two lines
            # above (rationales are usually two-line comment blocks).
            window = [n for n in (hit["line"] - 2, hit["line"] - 1,
                                  hit["line"], hit["line"] + 1)
                      if n in marker_lines[rule]]
            if window and rel in waivers.get(rule, {}):
                used_waiver_files[rule].add(rel)
                consumed.update((rule, n) for n in window)
                continue
            if window:
                problems.append(
                    f"{rel}:{hit['line']}: [{rule}] waiver marker present "
                    f"but {rel} is not in the ast_rules WAIVERS table — "
                    f"document the rationale there"
                )
                consumed.update((rule, n) for n in window)
                continue
            problems.append(
                f"{rel}:{hit['line']}: [{rule}] {hit['message']}"
            )
        # Orphan markers: a waiver comment with no flagged site right
        # there is stale documentation (the code it excused is gone).
        if rel == self_rel:
            continue
        for rule in MARKERS:
            for n in sorted(marker_lines[rule]):
                if (rule, n) not in consumed:
                    problems.append(
                        f"{rel}:{n}: [{rule}] stale waiver marker — no "
                        f"flagged site within one line; remove it"
                    )
    for rule, table in waivers.items():
        for rel in sorted(set(table) - used_waiver_files.get(rule, set())):
            problems.append(
                f"{rel}: [{rule}] WAIVERS entry has no live waived site — "
                f"remove the table entry"
            )
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    problems = check()
    for p in problems:
        print(f"ast_rules: {p}", file=sys.stderr)
    if problems:
        print(f"ast_rules: {len(problems)} violation(s)", file=sys.stderr)
        return 1
    print("ast_rules: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
