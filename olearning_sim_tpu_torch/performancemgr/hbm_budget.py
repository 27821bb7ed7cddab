"""One round's memory on the card, filed as the chip-pool oracle's static
budget.

The JAX package's oracle reads compiled-HLO buffer assignments; eager
PyTorch compiles no program, so the port measures a round instead and
writes ``{variant: {params_bytes, largest_buffer_bytes, clients}}`` to a
JSON file that ``taskmgr.pool.CostOracle(budgets_path=...)`` reads. The
measurement lives here, beside the engine it drives, so the scheduler
itself never runs a round.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

from olearning_sim_tpu_torch.taskmgr.pool import DEFAULT_HBM_VARIANT


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a nest of dicts, lists, tuples and
    dataclass-like objects (each tensor counted once)."""
    import torch

    seen, total, stack = set(), 0, [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "__dict__"):
            stack.extend(vars(x).values())
    return total


def measure_hbm_budget(core, state, dataset, path: str,
                       variant: str = DEFAULT_HBM_VARIANT,
                       **round_kwargs) -> Dict[str, float]:
    """Measure one round's memory on the card and file it as ``variant`` in
    the budgets file at ``path`` (other variants kept): one
    ``core.round_step(state, dataset, **round_kwargs)`` after
    ``torch.cuda.reset_peak_memory_stats()``. The round's peak is what the
    card held for it: the state and the dataset resident before the round,
    plus the most the round allocated above what was allocated when it
    began (other tenants of the process are not counted).
    ``params_bytes`` is the global parameters' bytes,
    ``largest_buffer_bytes`` the peak less four times that (the oracle adds
    the four slots back), ``clients`` the block of clients the round holds
    at once. A CPU round is refused: the budget is a card's measurement or
    nothing."""
    import torch

    dev = next(iter(state.params.values())).device
    if dev.type != "cuda":
        raise ValueError(f"measure_hbm_budget: the state lies on {dev}; a "
                         f"memory budget is measured on a CUDA card only")
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    core.round_step(state, dataset, **round_kwargs)
    torch.cuda.synchronize(dev)
    resident = tensor_bytes(state) + tensor_bytes(dataset)
    peak = int(torch.cuda.max_memory_allocated(dev) - before + resident)
    params_bytes = tensor_bytes(state.params)
    entry = {"params_bytes": params_bytes,
             "largest_buffer_bytes": max(0, peak - 4 * params_bytes),
             "clients": int(core.config.block_clients),
             "peak_bytes": peak}
    budgets: Dict[str, Any] = {}
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            budgets = dict(json.load(f))
    budgets[variant] = entry
    with open(path, "w", encoding="utf-8") as f:
        json.dump(budgets, f, indent=1, sort_keys=True)
    return entry
