"""Collective lint: the defended round must stay scale-out clean — no
collective may gather the per-client delta matrix onto every rank.

A robust aggregator that all-gathers every client's clipped delta puts
O(clients x params) on each rank, which caps the cohort a defense can
survive. The port's defended round instead re-lays the deltas with one
``all_to_all`` (``engine/defense.py``), so each rank holds every client
for 1/dp of the coordinates. This lint keeps that true of what the round
really launches, at the JAX package's threshold:

1. The grid's defended dp-2 variant (clip + trimmed mean + anomaly scores,
   ``defense/shard0/dp2``) is recorded on two gloo ranks.
2. A finding for any ``all_gather`` whose output is at least the
   per-client delta matrix's share of one rank (clients x params bytes /
   dp): the gathered formulation coming back.
3. A finding when the round holds no ``all_to_all`` at all: the sharded
   aggregation vanishing would also pass check 2.

``check_all`` runs it (``collectives``) on the grid's recording.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

VARIANT = "defense/shard0/dp2"


def analyze(art: Dict) -> Tuple[List[str], Dict[str, int]]:
    """(findings, bytes sent per collective kind) for the defended round's
    artifacts (``grid.grid_artifacts()[VARIANT]``)."""
    dp, clients, params_bytes = art["dp"], art["clients"], art["params_bytes"]
    threshold = clients * params_bytes // dp
    trace = art["a"]
    problems = []
    for kind, sent, received in trace.collectives:
        if kind == "all_gather" and received >= threshold:
            problems.append(
                f"defended round (dp={dp}) all-gathers {received} bytes >= the "
                f"per-client delta matrix's share of a rank, {threshold} bytes "
                f"({clients} clients x {params_bytes} param bytes / dp={dp}) — "
                f"the O(clients x params) gathered aggregation must not return; "
                f"use the all_to_all re-lay (engine/defense.py)"
            )
    if not any(kind == "all_to_all" for kind, _, _ in trace.collectives):
        problems.append(
            f"defended round (dp={dp}) launches no all_to_all: the sharded "
            f"robust aggregation is missing entirely"
        )
    return problems, trace.collective_bytes()


def check(art: Dict) -> List[str]:
    """Findings (empty = clean)."""
    return analyze(art)[0]
