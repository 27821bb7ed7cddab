"""Long-context sequence parallelism: run and train the text family over
sequences split over the ``sp`` ranks of a :class:`MeshPlan`.

The port of the JAX package's ``parallel/long_context.py``. Every rank
calls these functions with the same global host batch (``tokens`` [B, L]
numpy, ``labels`` [B]) and the same parameters; each takes its own
``(dp, sp)`` block, ``tokens[dp_rank * B/dp : ..., sp_rank * L/sp : ...]``,
and the model (built with ``attention_impl="ring"``) runs ring attention
over the plan's ``sp_group``. Parameters are a dict of tensors with the
port's names (``model.state_dict()`` names), on the device the work runs
on.

:class:`~olearning_sim_tpu_torch.parallel.ring_attention.RingSelfAttention`
is parameter-compatible with the dense attention, so the same parameters
evaluate here unchanged, and one :func:`sp_train_step` lands on the same
parameters as one dense step on the same global batch.

On a single GPU the sp group has one rank, which these entry points refuse
as the JAX ones do (they need an sp axis): call the model directly there,
``model(tokens)``, which is ring attention over a ring of one.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.func import functional_call

from olearning_sim_tpu_torch.parallel.mesh import MeshPlan

Params = Dict[str, torch.Tensor]


def _validate_sp_inputs(model, tokens, plan: MeshPlan, caller: str) -> None:
    if plan.sp <= 1:
        raise ValueError(
            f"{caller} needs a mesh with an sp axis (make_mesh_plan(sp=...))"
        )
    B, L = tokens.shape
    if L % plan.sp:
        raise ValueError(
            f"sp={plan.sp} must divide the sequence length {L}; pad the "
            f"sequences (pad_id tokens are masked out)"
        )
    if B % plan.dp:
        raise ValueError(f"dp={plan.dp} must divide the batch {B}")
    max_len = getattr(model, "max_len", None)
    if max_len is not None and L > max_len:
        raise ValueError(
            f"global sequence length {L} exceeds the model's max_len "
            f"{max_len}; build the model with max_len >= {L}"
        )


def _device_of(params: Params) -> torch.device:
    return next(iter(params.values())).device


def _rows(n: int, plan: MeshPlan) -> slice:
    b = n // plan.dp
    return slice(plan.dp_rank * b, (plan.dp_rank + 1) * b)


def _local_tokens(tokens, plan: MeshPlan, device) -> torch.Tensor:
    B, L = tokens.shape
    c = L // plan.sp
    block = np.asarray(tokens)[_rows(B, plan), plan.sp_rank * c:(plan.sp_rank + 1) * c]
    return torch.as_tensor(block, dtype=torch.long, device=device)


def sp_forward(model, params: Params, tokens, plan: MeshPlan) -> torch.Tensor:
    """Forward the text ``model`` (built with ``attention_impl="ring"``)
    over ``tokens`` [B, L] with L split over the plan's ``sp`` ranks and
    the batch over ``dp``. Returns the global logits [B, num_classes] f32
    on every rank.

    ``sp`` must divide ``L`` and ``dp`` must divide ``B`` (pad with the
    model's pad_id or repeat rows if not; padding tokens are masked out of
    attention and pooling)."""
    _validate_sp_inputs(model, tokens, plan, "sp_forward")
    tok = _local_tokens(tokens, plan, _device_of(params))
    with torch.no_grad():
        # Replicated over sp after the model's pooled sum over sp_group.
        logits = functional_call(model, params, (tok,), {"sp_group": plan.sp_group})
        if plan.dp_group is None:
            return logits
        parts = [torch.empty_like(logits) for _ in range(plan.dp)]
        dist.all_gather(parts, logits.contiguous(), group=plan.dp_group)
        return torch.cat(parts)


def sp_train_step(model, params: Params, opt_state, tokens, labels, optimizer,
                  plan: MeshPlan) -> Tuple[Params, object, float]:
    """One optimizer step on a text model with the sequence split over
    ``sp`` (ring attention) and the batch over ``dp``.

    ``optimizer`` is functional (``engine/algorithms.py``'s ``SGD`` or
    ``Adam``: ``update(grads, state) -> (updates, state)``). Returns
    ``(new_params, new_opt_state, loss)``, the same on every rank; ``loss``
    is the mean cross-entropy over the global batch.

    The gradient's scale. Rank (d, s) differentiates its own objective, the
    mean loss ``loss_d`` of its dp block of B/dp rows, whose logits every
    rank of the sp ring computes alike. Every cross-rank op in the forward
    has its transpose in the backward: the ring rotation sends K/V
    gradients back to their owners, and the pooled sum over sp
    (``all_reduce_sum``) sums its incoming gradients over sp. The sum over
    all ranks of these objectives is ``sp * sum_d loss_d``, and the sum over
    all ranks of their parameter gradients is its gradient. The global loss
    is ``mean_d loss_d``, so its gradient is that sum divided by
    ``dp * sp``: one all-reduce over the world, then a division."""
    _validate_sp_inputs(model, tokens, plan, "sp_train_step")
    device = _device_of(params)
    tok = _local_tokens(tokens, plan, device)
    lab = torch.as_tensor(np.asarray(labels)[_rows(len(labels), plan)],
                          dtype=torch.long, device=device)
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    logits = functional_call(model, leaves, (tok,), {"sp_group": plan.sp_group})
    loss_d = F.cross_entropy(logits.float(), lab)
    grads = torch.autograd.grad(loss_d, list(leaves.values()))

    flat = torch.cat([g.reshape(-1) for g in grads] + [loss_d.detach().reshape(1)])
    dist.all_reduce(flat, group=plan.world_group)
    flat /= plan.dp * plan.sp
    grad_dict, at = {}, 0
    for (k, p), g in zip(params.items(), grads):
        grad_dict[k] = flat[at:at + g.numel()].view_as(p)
        at += g.numel()
    loss = float(flat[at])  # mean over ranks of loss_d = mean over the batch
    updates, new_state = optimizer.update(grad_dict, opt_state)
    new_params = {k: (p + updates[k]).detach() for k, p in params.items()}
    return new_params, new_state, loss


def sp_evaluate(model, params: Params, tokens, labels, plan: MeshPlan,
                batch: Optional[int] = None) -> Tuple[float, float]:
    """Central eval (loss, accuracy) of a text model over long sequences,
    batched on the host; the same on every rank."""
    n = tokens.shape[0]
    if n == 0 or (batch is not None and batch <= 0):
        raise ValueError(
            f"sp_evaluate needs a non-empty eval set and positive batch "
            f"(n={n}, batch={batch})"
        )
    batch = batch or n
    batch += (-batch) % plan.dp
    # Pad the tail slice to the full batch by repeating its last row; the
    # padded rows are dropped via [:real] below.
    losses = accs = seen = 0.0
    for i in range(0, n, batch):
        tb, yb = tokens[i:i + batch], labels[i:i + batch]
        real = len(yb)
        pad = batch - real
        if pad:
            tb = np.concatenate([tb, np.repeat(tb[-1:], pad, 0)])
        logits = sp_forward(model, params, tb, plan)[:real].float()
        y = torch.as_tensor(np.asarray(yb), dtype=torch.long, device=logits.device)
        losses += float(F.cross_entropy(logits, y, reduction="sum"))
        accs += float((logits.argmax(-1) == y).sum())
        seen += real
    return losses / seen, accs / seen
