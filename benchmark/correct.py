"""The comparison that decides ``correct``: the program's evaluate at the
initial weights, its first rounds and the round after its window against
the reference's, number by number, each held to its limit.

The program's evaluate operator at the initial weights, and its first
three rounds (run in set-up through the runner's own ``step()``, on the
window's batch, blocks and population), are followed by the reference from
the same weights, rows, minibatch draws and availability. After the
window, one more round runs through the same ``step()`` from the state the
window left; the reference follows that round from a copy of that state.
Compared, each as one number:

- ``eval_logits_diff``: the evaluate operator's logits over the whole
  eval set at the initial weights, each side centred on its mean row,
  ``||a - b|| / ||b||``: rounding alone, before any training, so the
  compute's precision shows undamped;

- ``loss_gap``: the largest relative gap of a round's mean training loss;
- ``eval_loss_gap``: the largest relative gap of a round's central eval
  loss;
- ``eval_acc_gap``: the largest absolute gap of a round's eval accuracy;
- ``grad1_gap``: the first round's pseudo-gradient as the server
  optimizer gets it (the program's worked out from its optimizer state
  after one round), by the worst leaf: the gap between the two norms of a
  leaf over the larger of the reference's norm of that leaf and of the
  median leaf;
- ``change_gap``: the same of each leaf's change over the three rounds;
- ``grad1_diff`` and ``change_diff``: the same two by the worst leaf of
  the norm of their difference, ``||a - b||`` over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``last_loss_gap``: the relative gap of the round after the window's
  mean training loss;
- ``last_grad_gap`` and ``last_change_gap``: that round's pseudo-gradient
  and change of the global model, by the worst leaf's gap of norms, as
  ``grad1_gap``;
- ``last_grad_diff`` and ``last_change_diff``: the same two by the worst
  leaf of the norm of the difference, as ``grad1_diff``;
- ``trained_mismatch``: rounds, of every round the run made, whose count
  of clients that trained differs from the reference's availability
  (exact: limit 0).

A cell's limits file (``benchmark/limits/<cell>.json``) names the numbers
compared and gives each its limit; the others are printed beside "not
compared".

Leaves whose reference gradient is under a thousandth of the median
leaf's (a key's bias under softmax) move by round-off alone under Adam and
are left out of both norms' numbers by that rule (for the round after
the window, by its own reference gradient).
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Dict, List, Optional, Tuple

NUMBERS = ("eval_logits_diff", "loss_gap", "eval_loss_gap", "eval_acc_gap", "grad1_gap",
           "change_gap", "grad1_diff", "change_diff", "last_loss_gap", "last_grad_gap",
           "last_change_gap", "last_grad_diff", "last_change_diff", "trained_mismatch")
QUIET_LEAF = 1e-3


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def quiet_leaves(ref_grad1: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad1.values())
    return sorted(k for k, v in ref_grad1.items() if v < QUIET_LEAF * med)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], skip) -> float:
    keys = [k for k in ref if k not in skip]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def worst_diff(prog: dict, ref: dict, skip) -> float:
    """The worst leaf of ``||a - b||`` over the larger of the reference's
    norm of that leaf and of the median leaf (tensors, either device)."""
    keys = [k for k in ref if k not in skip]
    norms = {k: float(ref[k].norm()) for k in keys}
    med = statistics.median(norms.values())
    return max(float((prog[k].to(ref[k].device) - ref[k]).norm()) / max(norms[k], med, 1e-30)
               for k in keys)


def centered_diff(a, b) -> float:
    """``||a' - b'|| / ||b'||`` of two ``[rows, classes]`` tensors (either
    device), each centred on its mean row. At the initial weights every
    row's logits share a large part whose size swings with the seed's
    draw of the head; what tells the rows apart, and its rounding, is
    steady from seed to seed."""
    b = b.float()
    a = a.to(b.device).float()
    a, b = a - a.mean(0), b - b.mean(0)
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def numbers(prog: dict, ref: dict, trained_all: List[int], ref_trained_all: List[int]) -> dict:
    """Every number. ``prog`` and ``ref`` hold ``eval_logits`` (a tensor),
    ``loss``, ``eval_loss``, ``eval_acc`` (per round), ``grad1`` and
    ``change`` (per leaf norms), ``grad1_t`` and ``change_t`` (per leaf
    tensors) and ``last`` (the round after the window: ``loss``,
    ``grad_t``, ``change_t``); ``trained_all`` the program's clients
    trained in every round it ran, ``ref_trained_all`` the reference's."""
    skip = set(quiet_leaves(ref["grad1"]))
    last, ref_last = prog["last"], ref["last"]
    norms = {side: {key: {k: float(t.norm()) for k, t in s[key].items()}
                    for key in ("grad_t", "change_t")}
             for side, s in (("prog", last), ("ref", ref_last))}
    last_skip = set(quiet_leaves(norms["ref"]["grad_t"]))
    n = len(ref["loss"])
    return {
        "eval_logits_diff": centered_diff(prog["eval_logits"], ref["eval_logits"]),
        "loss_gap": max(_rel(prog["loss"][r], ref["loss"][r]) for r in range(n)),
        "eval_loss_gap": max(_rel(prog["eval_loss"][r], ref["eval_loss"][r]) for r in range(n)),
        "eval_acc_gap": max(abs(prog["eval_acc"][r] - ref["eval_acc"][r]) for r in range(n)),
        "grad1_gap": worst_leaf(prog["grad1"], ref["grad1"], skip),
        "change_gap": worst_leaf(prog["change"], ref["change"], skip),
        "grad1_diff": worst_diff(prog["grad1_t"], ref["grad1_t"], skip),
        "change_diff": worst_diff(prog["change_t"], ref["change_t"], skip),
        "last_loss_gap": _rel(last["loss"], ref_last["loss"]),
        "last_grad_gap": worst_leaf(norms["prog"]["grad_t"], norms["ref"]["grad_t"], last_skip),
        "last_change_gap": worst_leaf(norms["prog"]["change_t"], norms["ref"]["change_t"],
                                      last_skip),
        "last_grad_diff": worst_diff(last["grad_t"], ref_last["grad_t"], last_skip),
        "last_change_diff": worst_diff(last["change_t"], ref_last["change_t"], last_skip),
        "trained_mismatch": float(sum(a != b for a, b in zip(trained_all, ref_trained_all))
                                  + abs(len(trained_all) - len(ref_trained_all))),
    }


def leaf_report(prog: dict, ref: dict, top: int = 5) -> dict:
    """Where the leaf numbers come from: for ``grad1`` and ``change`` the
    ``top`` leaves by gap ``[leaf, gap, reference norm, program norm]`` and
    the median leaf's gap; and every round's eval loss on both sides."""
    skip = set(quiet_leaves(ref["grad1"]))
    out = {"quiet": sorted(skip), "eval_loss": prog["eval_loss"],
           "ref_eval_loss": ref["eval_loss"]}
    for key in ("grad1", "change"):
        keys = [k for k in ref[key] if k not in skip]
        med = statistics.median(ref[key][k] for k in keys)
        gaps = sorted(((abs(prog[key][k] - ref[key][k]) / max(ref[key][k], med, 1e-30), k)
                       for k in keys), reverse=True)
        out[f"{key}_top"] = [[k, g, ref[key][k], prog[key][k]] for g, k in gaps[:top]]
        out[f"{key}_median_gap"] = statistics.median(g for g, _ in gaps)
        t, rt = prog[key + "_t"], ref[key + "_t"]
        diffs = sorted(((float((t[k].to(rt[k].device) - rt[k]).norm()) / max(ref[key][k], med,
                                                                            1e-30), k)
                        for k in keys), reverse=True)
        out[f"{key}_diff_top"] = [[k, g] for g, k in diffs[:top]]
        out[f"{key}_median_diff"] = statistics.median(g for g, _ in diffs)
    return out


def load_limits(root: str, cell: str) -> Optional[dict]:
    path = os.path.join(root, "benchmark", "limits", f"{cell}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["limits"]


def judge(nums: dict, limits: Optional[dict]) -> Tuple[bool, dict]:
    """``(correct, checks)``: every number beside its limit, or beside "not
    compared". Without a limits file nothing is correct; a compared number
    over its limit, or not finite, fails."""
    checks, ok = {}, limits is not None
    for name in NUMBERS:
        v = nums.get(name)
        if limits is None or name not in limits:
            checks[name] = {"value": v, "limit": "not compared"}
            continue
        checks[name] = {"value": v, "limit": limits[name]}
        if v is None or not (v == v) or v > limits[name]:
            ok = False
    return ok, checks
