"""Tensor parallelism for the transformer families over the plan's ``mp``
ranks: the port of the JAX package's ``parallel/tp.py``.

The JAX engine annotates the model's tensors with ``PartitionSpec``\\ s and
lets GSPMD insert the collectives. The port runs one process per rank, so
each rank holds its own shards of the split tensors (:func:`shard_params`)
and the blocks run on them with Megatron's two collectives
(:func:`~olearning_sim_tpu_torch.parallel.collectives.copy_to` before a
column-parallel product, :func:`~olearning_sim_tpu_torch.parallel.collectives.reduce_from`
after a row-parallel one). The layout is JAX's, leaf for leaf, over the
port's parameter names (a torch ``Linear`` weight is ``[out, in]``, so the
split dimension is flipped against flax's ``[in, out]`` kernel):

- attention ``query``/``key``/``value``: weight ``[H*D, W]`` and bias
  ``[H*D]`` split on dim 0 by heads (flax ``P(None, mp, None)`` and
  ``P(mp, None)``);
- attention ``out``: weight ``[W, H*D]`` split on dim 1 by heads (row
  parallel, flax ``P(mp, None, None)``); its bias stays replicated and is
  added once, after the reduction;
- the FFN's up projection (``mlp_in``; ViT's ``dense.0``): weight ``[M, W]``
  and bias ``[M]`` on dim 0; its down projection (``mlp_out``;
  ``dense.1``): weight ``[W, M]`` on dim 1, bias replicated;
- embeddings, LayerNorms, heads, the flash branch's fused ``qkv`` and
  ``attn_out`` (JAX's rules match only ``query/key/value/out``), the MoE
  router and experts, and everything outside a block: replicated.

A leaf whose split dimension does not divide ``mp`` (counted in heads for
attention: ViT-Tiny's 3 heads at mp 2) stays replicated, as in JAX: its
block then computes that part whole on every rank.
"""

from __future__ import annotations

import logging
import math
import warnings
from typing import Dict, Mapping, Optional

import torch

from olearning_sim_tpu_torch.parallel import collectives

Params = Dict[str, torch.Tensor]
# name -> the dimension split over mp, or None (replicated).
Specs = Dict[str, Optional[int]]

_COLUMN = ("query", "key", "value")


def _rule(name: str, shape, heads: Optional[int]):
    """``(dim, count)`` for one leaf: the dimension split over mp and the
    number of units it splits into (heads or FFN columns), or None."""
    parts = name.split(".")
    if parts[0] != "blocks" or len(parts) < 3:
        return None
    leaf, parent = parts[-1], parts[-2]
    if parent in _COLUMN and heads:
        if leaf == "weight" and len(shape) == 2:
            return 0, heads
        if leaf == "bias" and len(shape) == 1:
            return 0, heads
        return None
    if parent == "out" and heads:
        return (1, heads) if leaf == "weight" and len(shape) == 2 else None
    up = parent == "mlp_in" or parts[-3:-1] == ["dense", "0"]
    down = parent == "mlp_out" or parts[-3:-1] == ["dense", "1"]
    if up and leaf in ("weight", "bias"):
        return 0, shape[0]
    if down and leaf == "weight" and len(shape) == 2:
        return 1, shape[1]
    return None


def tp_param_specs(shapes: Mapping[str, torch.Size], mp: int,
                   heads: Optional[int] = None) -> Specs:
    """For each parameter (``name -> shape``, e.g. a model's
    ``named_parameters`` on the meta device), the dimension split over
    ``mp`` or None. ``heads`` is the model's head count (the port's
    attention weights do not record it). Leaves whose units do not divide
    ``mp`` come back replicated, so the result is valid at any ``mp``."""
    specs: Specs = {}
    for name, shape in shapes.items():
        shape = tuple(getattr(shape, "shape", shape))
        rule = None if mp <= 1 else _rule(name, shape, heads)
        specs[name] = rule[0] if rule is not None and rule[1] % mp == 0 else None
    return specs


def sharded_fraction(shapes: Mapping[str, torch.Size], specs: Specs) -> float:
    """Fraction of parameter elements on mp-sharded leaves."""
    total = sharded = 0
    for name, shape in shapes.items():
        n = math.prod(tuple(getattr(shape, "shape", shape)))
        total += n
        if specs.get(name) is not None:
            sharded += n
    return sharded / max(total, 1)


def warn_if_unsharded(shapes, specs: Specs, n_way: int, axis: str = "mp") -> float:
    """Log the sharding coverage of a plan; warn when a requested model axis
    degrades to (almost) full replication. Returns the fraction."""
    frac = sharded_fraction(shapes, specs)
    logging.getLogger(__name__).info(
        "%s=%d sharding coverage: %.1f%% of parameter elements", axis, n_way, frac * 100.0)
    if frac < 0.01:
        warnings.warn(
            f"{axis}={n_way} was requested but only {frac:.1%} of parameter "
            f"elements are sharded (dimensions indivisible by {n_way} fall "
            f"back to replication) — the model axis is doing no useful "
            f"work; pick a divisor of the model's head/FFN/expert counts",
            stacklevel=3,
        )
    return frac


def shard_params(params: Mapping[str, torch.Tensor], specs: Specs, n: int, index: int,
                 lead: int = 0) -> Params:
    """Rank ``index`` of ``n``'s shard of every split leaf (a contiguous
    slice, a view), the others as they are. ``lead`` leading axes come
    first (1 for per-client state ``[C, ...]``)."""
    out = {}
    for k, v in params.items():
        d = specs.get(k)
        if d is None or n <= 1:
            out[k] = v
        else:
            size = v.shape[lead + d] // n
            out[k] = v.narrow(lead + d, index * size, size)
    return out


def unshard_params(shards: Mapping[str, torch.Tensor], specs: Specs, group,
                   lead: int = 0) -> Params:
    """The inverse of :func:`shard_params` over ``group`` (a collective:
    every rank calls it): each split leaf gathered from its ranks' shards
    in rank order, the others as they are."""
    keys = [k for k in shards if specs.get(k) is not None]
    if not keys or not collectives.active(group):
        return dict(shards)
    out = dict(shards)
    # One all_gather per split dimension (the dims share a flat buffer).
    for d in sorted({specs[k] for k in keys}):
        ks = [k for k in keys if specs[k] == d]
        for k, full in zip(ks, collectives.all_gather([shards[k] for k in ks], group,
                                                      dim=lead + d)):
            out[k] = full
    return out
