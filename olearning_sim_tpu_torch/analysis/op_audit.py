"""Operation budget audit: every round variant's recorded operations must
stay within the checked-in budgets (the counterpart of the JAX package's
HLO budget audit, read off the aten operations the round dispatches
rather than a compiled program).

For each grid variant (:mod:`~olearning_sim_tpu_torch.analysis.grid`), knob
setting ``a``'s trace is measured:

- **collectives** — bytes each rank sends per collective kind of the port
  (``psum``, ``psum_scatter``, ``all_gather``, ``all_to_all``, ``pmax``,
  ``mp_psum``, ...). A new kind, a kind disappearing, or bytes growing past
  the tolerance (1.0: collective bytes are shape arithmetic) fails — the
  clients x params all-gather class of regression, grid-wide.
- **largest_tensor_bytes** — the largest tensor storage any operation's
  output lives in (an input's when the output is a view), tolerance
  1.25. A clients x params intermediate shows up here.
- **dtypes** — the census of output dtypes. ``float64`` anywhere fails (a
  Python double or a numpy array leaked into the round); any other NEW
  dtype fails against the budget.
- **host_syncs** — operations that wait for the card inside the recorded
  window (:data:`~olearning_sim_tpu_torch.analysis.op_trace.SYNC_OPS`):
  pinned to the budget, and 0 for every round (the round's source carries
  no sync but the waived ones of ``ast_rules``, which the grid keeps out
  of the window). Only the flash evaluate reads values back by design.
- **flash_calls** — the flash evaluate's calls of the flash-attention
  wrapper (depth x batches), pinned.
- **ops** — the number of operations: recorded, not enforced, since aten
  decompositions differ between torch releases (the card's and the CPU
  image's).

The JAX audit also pins buffer donation. Eager PyTorch has no
counterpart: a round returns new tensors and the caching allocator reuses
the old ones' memory once they are dropped, so nothing here records it;
``chip_smoke.py`` phase 19 records each round's peak device memory in its
place.

Budgets live in ``analysis/budgets.json``. Regenerate them on the CPU with
``python -m olearning_sim_tpu_torch.analysis.check_all --bless`` after an
INTENTIONAL change to what a round dispatches, and commit the diff.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

BUDGETS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "budgets.json")

# Measured value may not exceed budget * ratio.
DEFAULT_TOLERANCES = {
    "collective_bytes": 1.0,
    "largest_tensor_bytes": 1.25,
}

# Programs whose recorded window reads values back to the host by design.
HOST_SYNC_WAIVERS = {
    "flash_eval": "FedCore.evaluate reads each eval batch's loss and "
                  "accuracy back to the host (two reads a batch)",
}


def measure(art: Dict) -> Dict:
    """The budgetable facts of one variant's artifacts (grid.record_variant)."""
    tr = art["a"]
    out = {
        "collectives": tr.collective_bytes(),
        "largest_tensor_bytes": tr.largest_bytes,
        "largest_tensor_op": tr.largest_op,
        "dtypes": tr.dtypes,
        "host_syncs": tr.syncs,
        "ops": len(tr.ops),
        "params_bytes": art["params_bytes"],
        "state_bytes": art["state_bytes"],
        "clients": art["clients"],
    }
    if "flash_calls" in art["info"]["a"]:
        out["flash_calls"] = art["info"]["a"]["flash_calls"]
    return out


def compare(name: str, measured: Dict, golden: Dict,
            tolerances: Optional[Dict] = None, program: Optional[str] = None) -> List[str]:
    """Findings for one variant: measured against its budget entry."""
    tol = dict(DEFAULT_TOLERANCES)
    tol.update(tolerances or {})
    tol.update(golden.get("tolerances") or {})
    problems = []

    if "float64" in measured["dtypes"] and not golden.get("allow_float64"):
        problems.append(
            f"{name}: float64 appears in the round (dtype census "
            f"{measured['dtypes']}) — a Python double or a numpy array "
            f"leaked into the round (precision + 2x memory regression)"
        )
    new_dtypes = set(measured["dtypes"]) - set(golden.get("dtypes", []))
    new_dtypes.discard("float64")  # already reported above, more precisely
    if new_dtypes:
        problems.append(
            f"{name}: new dtypes {sorted(new_dtypes)} in the round (budget "
            f"census: {golden.get('dtypes')}); re-bless if intentional"
        )

    g_coll = golden.get("collectives", {})
    m_coll = measured["collectives"]
    for kind in sorted(set(m_coll) - set(g_coll)):
        problems.append(
            f"{name}: new collective kind {kind!r} ({m_coll[kind]} bytes sent "
            f"a rank) not in the budget — the round's communication shape "
            f"changed; re-bless if intentional"
        )
    for kind in sorted(set(g_coll) - set(m_coll)):
        problems.append(
            f"{name}: collective {kind!r} disappeared from the round (budget: "
            f"{g_coll[kind]} bytes a rank) — a sharded path silently "
            f"vanishing also passes byte checks, so this fails loudly"
        )
    ratio = tol["collective_bytes"]
    for kind in sorted(set(g_coll) & set(m_coll)):
        if m_coll[kind] > g_coll[kind] * ratio:
            problems.append(
                f"{name}: {kind} grew to {m_coll[kind]} bytes a rank (budget "
                f"{g_coll[kind]}, tolerance x{ratio}) — collective bytes are "
                f"shape arithmetic, so this is a real layout change"
            )

    g_big = golden.get("largest_tensor_bytes", 0)
    if measured["largest_tensor_bytes"] > g_big * tol["largest_tensor_bytes"]:
        problems.append(
            f"{name}: largest tensor grew to {measured['largest_tensor_bytes']} "
            f"bytes ({measured['largest_tensor_op']}; budget {g_big}, tolerance "
            f"x{tol['largest_tensor_bytes']}) — check for a clients x params "
            f"intermediate"
        )

    syncs = measured["host_syncs"]
    if syncs != golden.get("host_syncs", 0):
        problems.append(
            f"{name}: {syncs} host syncs in the recorded window (budget "
            f"{golden.get('host_syncs', 0)}) — an .item()/float()/bool() of a "
            f"tensor, or a data-sized output, waits for the card"
        )
    elif syncs and program not in HOST_SYNC_WAIVERS:
        problems.append(
            f"{name}: the round syncs the host {syncs} times — a round must "
            f"launch without waiting for the card"
        )
    if "flash_calls" in golden and measured.get("flash_calls") != golden["flash_calls"]:
        problems.append(
            f"{name}: the flash-attention wrapper ran {measured.get('flash_calls')} "
            f"times (budget {golden['flash_calls']}: depth x eval batches)"
        )
    return problems


def load_budgets(path: Optional[str] = None) -> Dict:
    with open(path or BUDGETS_PATH, encoding="utf-8") as f:
        return json.load(f)


def check(artifacts_by_name: Dict[str, Dict],
          budgets: Optional[Dict] = None,
          budgets_path: Optional[str] = None) -> List[str]:
    """Audit the grid's artifacts (``grid.grid_artifacts``) against the
    budgets; returns findings (empty = clean)."""
    if budgets is None:
        try:
            budgets = load_budgets(budgets_path)
        except OSError as e:
            return [
                f"cannot read the operation budgets ({e}); generate them with "
                f"`python -m olearning_sim_tpu_torch.analysis.check_all --bless`"
            ]
    tolerances = budgets.get("tolerances")
    entries = budgets.get("variants", {})
    problems: List[str] = []
    for name, art in sorted(artifacts_by_name.items()):
        golden = entries.get(name)
        if golden is None:
            problems.append(
                f"{name}: variant missing from budgets.json — bless the grid "
                f"(`python -m olearning_sim_tpu_torch.analysis.check_all --bless`)"
            )
            continue
        problems.extend(compare(name, measure(art), golden, tolerances,
                                program=art["program"]))
    for stale in sorted(set(entries) - set(artifacts_by_name)):
        problems.append(
            f"{stale}: budget entry no longer in the variant grid — remove it "
            f"(re-bless)"
        )
    return problems


def bless(artifacts_by_name: Dict[str, Dict], path: Optional[str] = None) -> Dict:
    """Measure the grid's artifacts and (re)write the budgets file."""
    variants = {}
    for name, art in sorted(artifacts_by_name.items()):
        entry = measure(art)
        if art["program"] in HOST_SYNC_WAIVERS:
            entry["host_syncs_reason"] = HOST_SYNC_WAIVERS[art["program"]]
        variants[name] = entry
    budgets = {
        "_comment": (
            "Operation budgets per round variant, recorded on the CPU. "
            "Regenerate with `python -m "
            "olearning_sim_tpu_torch.analysis.check_all --bless` after an "
            "intentional change to what a round dispatches and commit the "
            "diff. 'ops' is recorded, not enforced."
        ),
        "tolerances": dict(DEFAULT_TOLERANCES),
        "variants": variants,
    }
    out = path or BUDGETS_PATH
    with open(out, "w", encoding="utf-8") as f:
        json.dump(budgets, f, indent=1, sort_keys=True)
        f.write("\n")
    return budgets
