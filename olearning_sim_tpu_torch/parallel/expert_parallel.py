"""Expert parallelism (``ep``): the MoE text family's experts split over the
plan's ``ep`` ranks. The port of the JAX package's
``parallel/expert_parallel.py``.

The JAX package annotates every per-expert leaf (``expert_*``, leading dim
``num_experts``) with ``PartitionSpec("ep", ...)`` and lets GSPMD place
the token exchange. Here each rank holds its contiguous slice of the
experts (:func:`ep_place_params`); every rank routes every token of its
batch alike (the router is replicated), runs its own experts on the tokens
routed to them, and the combine is summed over the ep group
(:class:`~olearning_sim_tpu_torch.models.moe.SwitchFFN` under
``ep_group``). The tokens and the gate values enter the expert part through
Megatron's *f*, so their gradients sum over the group and every replicated
leaf's gradient is whole on every rank.

The batch splits over ``dp``. Each rank routes its own rows, so the
capacity is counted over a rank's ``B/dp`` rows (JAX's program routes the
global batch; the two agree at dp 1).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from olearning_sim_tpu_torch.parallel import collectives
from olearning_sim_tpu_torch.parallel.long_context import _device_of, _rows
from olearning_sim_tpu_torch.parallel.mesh import MeshPlan
from olearning_sim_tpu_torch.parallel.tp import sharded_fraction, warn_if_unsharded

Params = Dict[str, torch.Tensor]
Specs = Dict[str, Optional[int]]

_EXPERT_PREFIX = "expert_"

# The same "fraction of elements on sharded leaves" as tensor parallelism;
# under ep only expert leaves are split.
sharded_expert_fraction = sharded_fraction


def ep_param_specs(shapes, ep: int) -> Specs:
    """For each parameter (``name -> shape``), 0 when it is a per-expert
    leaf (``expert_*`` with a leading expert dim divisible by ``ep``),
    split over ep on that dim; else None (replicated)."""
    specs: Specs = {}
    for name, shape in shapes.items():
        shape = tuple(getattr(shape, "shape", shape))
        leaf = name.rsplit(".", 1)[-1]
        specs[name] = (0 if leaf.startswith(_EXPERT_PREFIX) and shape and shape[0] % ep == 0
                       else None)
    return specs


def ep_place_params(params: Params, plan: MeshPlan) -> Tuple[Params, Specs]:
    """This rank's params under :func:`ep_param_specs` (its slice of each
    expert leaf, copies) and the specs."""
    if plan.ep <= 1:
        raise ValueError(
            "ep_place_params needs a mesh with an ep axis (make_mesh_plan(ep=...))"
        )
    specs = ep_param_specs(params, plan.ep)
    warn_if_unsharded(params, specs, plan.ep, axis="ep")
    out = {}
    for k, v in params.items():
        if specs[k] is None:
            out[k] = v.detach().clone()
        else:
            n = v.shape[0] // plan.ep
            out[k] = v[plan.ep_rank * n:(plan.ep_rank + 1) * n].detach().clone()
    return out, specs


def ep_train_step(model, params: Params, opt_state, tokens, labels, optimizer,
                  plan: MeshPlan, aux_weight: float = 0.01):
    """One optimizer step on a MoE text model with its experts split over
    ``ep`` and the batch ``tokens [B, L]`` over ``dp``. ``params`` are this
    rank's (:func:`ep_place_params`); ``optimizer`` is functional
    (``engine/algorithms.py``). The loss is the cross-entropy plus
    ``aux_weight`` times the Switch load-balancing loss averaged over the
    blocks. Returns ``(new_params, new_opt_state, loss)``, ``loss`` the
    mean cross-entropy over the global batch."""
    if plan.ep <= 1:
        raise ValueError(
            "ep_train_step needs a mesh with an ep axis (make_mesh_plan(ep=...))"
        )
    B = tokens.shape[0]
    if B % plan.dp:
        raise ValueError(f"dp={plan.dp} must divide the batch {B}")
    dev = _device_of(params)
    rows = _rows(B, plan)
    tok = torch.as_tensor(np.asarray(tokens)[rows], dtype=torch.long, device=dev)
    lab = torch.as_tensor(np.asarray(labels)[rows], dtype=torch.long, device=dev)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    logits, aux = functional_call(model, leaves, (tok,),
                                  {"return_aux": True, "ep_group": plan.ep_group})
    ce = F.cross_entropy(logits.float(), lab)
    grads = torch.autograd.grad(ce + aux_weight * aux.float(), list(leaves.values()))
    keys = list(leaves)
    reduced = collectives.psum(list(grads) + [ce.detach().reshape(1)], plan.dp_group)
    grad_dict = {k: g / plan.dp for k, g in zip(keys, reduced)}
    updates, opt_state = optimizer.update(grad_dict, opt_state)
    new = {k: (p + updates[k]).detach() for k, p in params.items()}
    return new, opt_state, float(reduced[-1][0]) / plan.dp
