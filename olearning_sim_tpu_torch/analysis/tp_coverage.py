"""Tensor-parallel coverage lint: an ``mp > 1`` config must actually shard.

The per-leaf indivisibility fallback in ``parallel/tp.tp_param_specs`` is
silent by design — a head count that doesn't divide ``mp`` replicates that
leaf and the round stays correct. But a checked-in task config asking for
``{"parallel": {"mp": N}}`` on a model whose tensors mostly can't shard is a
configuration bug: every card holds (almost) the full model, the mp axis
burns cards for no memory or FLOP win, and nothing fails at run time
(``warn_if_unsharded`` warns below 1%, which a CI log swallows).

This analyzer makes the threshold a repo invariant: for every JSON task
config under ``configs/`` whose engine params request ``mp > 1``, the
port's model is built on the ``meta`` device (shapes only — no weights, no
device work), its parameter shapes go through ``tp_param_specs``, and the
spec coverage must shard at least :data:`MIN_SHARDED_FRACTION` of the
parameter ELEMENTS; a violation names the unmatched (replicated) leaves so
the fix — pick divisible head/FFN counts, or drop the mp request — is one
read away. It is the number every build at mp > 1 publishes as the
``ols_engine_tp_sharded_ratio`` gauge (``build_fedcore``), measured
statically at lint time.

Standalone: ``python -m olearning_sim_tpu_torch.analysis.tp_coverage``.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

# An mp>1 request must distribute at least half of the parameter volume;
# below that the dominant memory term is replicated and the axis is
# (mostly) decorative.
MIN_SHARDED_FRACTION = 0.5

CONFIGS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs",
)


def _engine_param_blocks(cfg: Dict) -> List[Dict]:
    """Every operator's parsed engine-params dict in one task config."""
    blocks = []
    for op in (cfg.get("operatorflow") or {}).get("operators", []):
        sim = op.get("logical_simulation") or {}
        raw = sim.get("operator_params")
        if not raw:
            continue
        try:
            params = json.loads(raw) if isinstance(raw, str) else raw
        except json.JSONDecodeError:
            continue  # malformed params are the submit validator's finding
        if isinstance(params, dict):
            blocks.append(params)
    return blocks


def measure_config(params: Dict) -> Optional[Tuple[float, List[str], int]]:
    """(sharded_fraction, replicated parameter names, mp) for one
    engine-params block, or None when the block doesn't request tensor
    parallelism."""
    from olearning_sim_tpu_torch.parallel.mesh import ParallelConfig

    par = params.get("parallel")
    if not par:
        return None
    parallel = ParallelConfig.from_dict(par)
    if parallel.mp <= 1:
        return None
    import torch

    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.parallel.tp import sharded_fraction, tp_param_specs

    model_cfg = params.get("model", {})
    # Same default as the task bridge's build path: a name-less model block
    # is a VALID config (mlp2), not an unmeasurable one.
    spec = get_model(model_cfg.get("name", "mlp2"))
    in_shape = tuple(model_cfg.get("input_shape") or spec.example_input_shape)
    with torch.device("meta"):
        model = spec.build(input_shape=in_shape, **(model_cfg.get("overrides") or {}))
    shapes = {k: v.shape for k, v in model.named_parameters()}
    specs = tp_param_specs(shapes, parallel.mp, getattr(model, "heads", None))
    frac = sharded_fraction(shapes, specs)
    unsharded = [k for k, d in specs.items() if d is None]
    return frac, unsharded, parallel.mp


def check(configs_dir: Optional[str] = None,
          min_fraction: float = MIN_SHARDED_FRACTION) -> List[str]:
    """Findings for every mp>1 config below the coverage threshold
    (empty = clean). ``configs_dir`` is injectable for tests."""
    root = configs_dir or CONFIGS_DIR
    problems: List[str] = []
    for path in sorted(glob.glob(os.path.join(root, "*.json"))):
        rel = os.path.basename(path)
        try:
            with open(path, encoding="utf-8") as f:
                cfg = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue  # unreadable/malformed configs are other lints' findings
        for params in _engine_param_blocks(cfg):
            try:
                measured = measure_config(params)
            except Exception as e:  # noqa: BLE001 — name the config, keep linting
                problems.append(
                    f"{rel}: mp coverage could not be measured ({e}) — a "
                    f"parallel block whose model cannot be built on the meta "
                    f"device will also fail at build time"
                )
                continue
            if measured is None:
                continue
            frac, unsharded, mp = measured
            if frac < min_fraction:
                preview = ", ".join(unsharded[:6])
                more = (f" (+{len(unsharded) - 6} more)"
                        if len(unsharded) > 6 else "")
                problems.append(
                    f"{rel}: parallel.mp={mp} shards only {frac:.1%} of "
                    f"parameter elements (threshold {min_fraction:.0%}) — "
                    f"the mp axis is mostly replication; unmatched leaves: "
                    f"{preview}{more}. Pick head/FFN counts divisible by "
                    f"{mp}, or drop the parallel block "
                    f"(docs/performance.md, 'Model parallelism')"
                )
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    problems = check()
    for p in problems:
        print(f"tp_coverage: {p}", file=sys.stderr)
    if problems:
        print(f"tp_coverage: {len(problems)} violation(s)", file=sys.stderr)
        return 1
    print("tp_coverage: OK — every mp>1 config shards "
          f">={MIN_SHARDED_FRACTION:.0%} of parameter elements")
    return 0


if __name__ == "__main__":
    sys.exit(main())
