"""Knobs-are-data detector: per-round scalar knobs must be data.

The JAX package learned this when a literal ``inf`` clip value re-keyed
its executable cache, so that toggling clipping recompiled the round; it
now holds every scalar knob — clip norm, trim fraction, deadline, attack
scales — to be a traced input, one executable per program. Eager PyTorch
compiles nothing, but the same fault has an eager form: a knob read
through a Python branch (``if deadline > 1.0:``), or turned into a Python
number that sizes a tensor, makes the round dispatch other operations for
other values. Such a round cannot be captured once and replayed (a CUDA
graph of a round, ``PERF.md`` B4) and its launches depend on the knob.

For every variant the grid runs the round under two knob settings (clip
5.0 against disabled, deadline 1.75 against 0.5, trim 0.1 against 0.4,
attack scales -1 against 7.5, two async arrival orders and staleness
settings, two stream participation draws). On every rank the two runs
must dispatch the same sequence of (operation, output shapes, output
dtypes) and the same collectives with the same bytes; a finding points at
the first difference.

``check_all`` runs it (``retrace``).
"""

from __future__ import annotations

from typing import Dict, List


def compare_variant(art: Dict) -> List[str]:
    """Findings for one variant's grid artifacts (empty = clean)."""
    from olearning_sim_tpu_torch.analysis.op_trace import first_diff

    problems = []
    for rank, (a, b) in enumerate(art["rank_traces"]):
        diff = first_diff(a, b)
        if diff is not None:
            where = f" on rank {rank}" if len(art["rank_traces"]) > 1 else ""
            problems.append(
                f"{art['variant']}: the two knob settings dispatched different "
                f"operations{where} — a per-round knob steers the round from "
                f"the host (a Python branch or a host number sizing a tensor) "
                f"instead of entering it as data; {diff}"
            )
    return problems


def check(artifacts_by_name: Dict[str, Dict]) -> List[str]:
    """Findings across the grid's artifacts (empty = clean)."""
    problems: List[str] = []
    for _, art in sorted(artifacts_by_name.items()):
        problems.extend(compare_variant(art))
    return problems
