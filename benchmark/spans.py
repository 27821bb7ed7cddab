"""The program's spans of the traced rounds, for the readers of
``program_span`` metrics.

The port's runner and round record their spans in the process's default
tracer (``olearning_sim_tpu_torch.telemetry.default_tracer``), which the
harness clears before the bridge's build. The traced rounds are the
``ctx.traced_rounds`` rounds after the harness's set-up rounds; each is
marked by the runner's ``round.train.<phase>`` span and its ``round_idx``.
A program that has no such span gives an empty list, and its reader
nothing."""

from typing import List


def traced_phases(ctx, phase: str) -> list:
    """The runner's ``round.train.<phase>`` spans of the traced rounds."""
    from benchmark.run import SETUP_ROUNDS
    from olearning_sim_tpu_torch.telemetry import default_tracer

    rounds = range(SETUP_ROUNDS, SETUP_ROUNDS + int(ctx.traced_rounds or 0))
    return [s for s in default_tracer().spans(f"round.train.{phase}")
            if s.attrs.get("round_idx") in rounds]


def under(ctx, phase: str, name: str) -> List:
    """The spans named ``name`` inside the traced rounds' ``phase`` spans
    (at any depth, by their parent links)."""
    from olearning_sim_tpu_torch.telemetry import default_tracer

    roots = {s.span_id for s in traced_phases(ctx, phase)}
    spans = default_tracer().spans()
    parent = {s.span_id: s.parent_id for s in spans}
    out = []
    for s in spans:
        if s.name != name:
            continue
        p = s.parent_id
        while p is not None and p not in roots:
            p = parent.get(p)
        if p is not None:
            out.append(s)
    return out
