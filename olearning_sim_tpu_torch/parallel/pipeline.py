"""Pipeline parallelism (``pp``): GPipe stage pipelining of the text family
over the plan's ``pp`` ranks. The port of the JAX package's
``parallel/pipeline.py``.

- The model's blocks are stacked into one ``[depth, ...]`` tensor per leaf
  (:func:`~olearning_sim_tpu_torch.weights.stack_block_params`) and stage
  ``p`` owns blocks ``[p * depth/pp, (p + 1) * depth/pp)``.
- The batch is split into M microbatches that stream through the stages
  in ``M + pp - 1`` ticks. At every tick every stage applies its blocks and
  hands the result one stage on
  (:func:`~olearning_sim_tpu_torch.parallel.collectives.hop`, JAX's
  ``ppermute``). Stage 0 feeds embeddings in; the last stage collects its
  outputs, pools them and applies the head; the logits are summed over the
  stages (only the last contributes), so every stage holds them.
- Parameters are the dense model's, so params trained densely pipeline
  unchanged and the other way round.

Every stage must reach every hop in the same order, forward and backward.
Autograd runs a hop's backward only if the hop's output reaches the loss,
and stage 0 never reads what it receives, nor does any stage but the last
read its final output. So stage 0 takes its input as ``where(True,
embeddings, received)`` and the other stages tie their last output into
their (zero) logits with ``where(False, ...)``: the values are unchanged,
the gradients through those edges are exact zeros, and every hop's
backward runs on every stage, from the last tick down to the first.

The gradient's scale. Unlike JAX's ``shard_map(check_vma=False)``, whose
transposes inflate every gradient by the product of the axis sizes
(``parallel/scale_check.py`` there), the port's collectives are their own
exact transposes: the logits' sum over stages differentiates as the
identity (each stage differentiates its own copy of the loss), and a hop's
backward hops back. Block gradients come out stage-local and exact; the
embedding's gradient lives on stage 0 and the head's on the last stage, so
the replicated leaves' gradients are summed over the stages once.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from olearning_sim_tpu_torch.models.transformer import LN_EPS
from olearning_sim_tpu_torch.parallel import collectives
from olearning_sim_tpu_torch.parallel.long_context import _device_of, _rows
from olearning_sim_tpu_torch.parallel.mesh import MeshPlan
from olearning_sim_tpu_torch.weights import stack_block_params, unstack_block_params

Params = Dict[str, torch.Tensor]


def _validate_pp_inputs(model, plan: MeshPlan, caller: str, tokens,
                        num_microbatches) -> int:
    """Validate and return the resolved microbatch count M."""
    if plan.pp <= 1:
        raise ValueError(
            f"{caller} needs a mesh with a pp axis (make_mesh_plan(pp=...))"
        )
    if model.depth % plan.pp:
        raise ValueError(
            f"pp={plan.pp} must divide the model depth {model.depth}"
        )
    impl = getattr(model, "attention_impl", "dense")
    if impl != "dense":
        raise ValueError(
            f"pipeline parallelism requires attention_impl='dense', the "
            f"model was built with {impl!r}"
        )
    M = num_microbatches if num_microbatches is not None else plan.pp
    if M <= 0:
        raise ValueError(f"num_microbatches must be positive, got {M}")
    B = np.asarray(tokens).shape[0]
    if B % (plan.dp * M):
        raise ValueError(
            f"dp*num_microbatches = {plan.dp}*{M} must divide the batch {B} "
            f"(microbatching applies to each dp shard's local batch)"
        )
    return M


_REST, _STACK = "rest/", "stack/"


def pp_tree(rest: Params, stacked: Params) -> Params:
    """The stage layout as one dict: the replicated leaves as
    ``rest/<name>`` and the block stack's leaves as ``stack/<leaf>``. It is
    the per-client carry of the pipelined round and the tree an optimizer
    state of :func:`pp_train_step` is over."""
    return {**{_REST + k: v for k, v in rest.items()},
            **{_STACK + k: v for k, v in stacked.items()}}


def split_tree(tree: Params) -> Tuple[Params, Params]:
    """The inverse of :func:`pp_tree`: ``(rest, stacked)``."""
    return ({k[len(_REST):]: v for k, v in tree.items() if k.startswith(_REST)},
            {k[len(_STACK):]: v for k, v in tree.items() if k.startswith(_STACK)})


def stage_params(params: Params, plan: MeshPlan) -> Params:
    """Full params -> this rank's stage layout (views): the replicated
    leaves whole, blocks ``[p * depth/pp, (p + 1) * depth/pp)`` of stage
    ``p``."""
    rest, stacked = stack_block_params(params)
    d = next(iter(stacked.values())).shape[0] // plan.pp
    lo = plan.pp_rank * d
    return pp_tree(rest, {k: v[lo:lo + d] for k, v in stacked.items()})


class PipelinedBody:
    """The pipelined logits of a dense-attention ``TextTransformer`` and the
    stage layout (:func:`pp_tree`) they run on, shared by :func:`pp_forward`,
    :func:`pp_train_step` and the pipelined round
    (``engine/pp_rounds.py``): the layout's conversions, FedProx's
    whole-model pull and the replicated leaves' gradient sum over pp.
    :meth:`logits` works under ``vmap`` and ``grad`` alike."""

    def __init__(self, model, plan: MeshPlan, microbatches: int):
        self.model, self.plan, self.M = model, plan, microbatches
        self.group, self.stage, self.pp = plan.pp_group, plan.pp_rank, plan.pp
        self.order = [k for k, _ in model.named_parameters()]
        # A skeleton block for functional_call (the model may live on meta).
        self.block = copy.deepcopy(model.blocks[0])

    def to_local(self, params: Params) -> Params:
        """Full params -> this stage's layout (views)."""
        return stage_params(params, self.plan)

    def to_full(self, local: Params) -> Params:
        """This stage's layout -> the model's layout, the block stack
        gathered over pp (a collective)."""
        rest, stacked = split_tree(local)
        full = collectives.all_gather(list(stacked.values()), self.group, dim=0)
        out = unstack_block_params(rest, dict(zip(stacked, full)))
        return {k: out[k] for k in self.order}

    def prox_sq(self, q: Params, anchor: Params) -> torch.Tensor:
        """The whole model's ``||q - anchor||^2`` on every stage: the
        stage-local block terms and stage 0's term of the replicated leaves,
        summed over pp."""
        blocks = sum((q[k] - anchor[k]).square().sum() for k in q if k.startswith(_STACK))
        if self.stage == 0:
            blocks = blocks + sum((q[k] - anchor[k]).square().sum()
                                  for k in q if k.startswith(_REST))
        return collectives.reduce_from(blocks, self.group, "pp_psum")

    def fix_grads(self, grads: Params) -> Params:
        """The replicated leaves' stage partials summed over pp (the
        embedding's gradient lives on stage 0, the head's on the last)."""
        keys = [k for k in grads if k.startswith(_REST)]
        out = dict(grads)
        out.update(zip(keys, collectives.psum([grads[k] for k in keys], self.group)))
        return out

    def embed(self, rest: Params, toks: torch.Tensor) -> torch.Tensor:
        m = self.model
        L = toks.shape[-1]
        x = (F.embedding(toks, rest["embed.weight"])
             + rest["pos_embedding"][:, :L]).to(m.dtype)
        W = x.shape[-1]
        y = F.layer_norm(x.float(), (W,), rest["ln_emb.weight"].float(),
                         rest["ln_emb.bias"].float(), LN_EPS)
        return y.to(m.dtype)

    def head(self, rest: Params, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        msk = pad_mask[..., None].float()
        pooled = (x.float() * msk).sum(1) / torch.clamp(msk.sum(1), min=1.0)
        return F.linear(pooled, rest["head.weight"], rest["head.bias"])

    def stage_apply(self, stacked: Params, x: torch.Tensor, pad_mask) -> torch.Tensor:
        depth = next(iter(stacked.values())).shape[0]
        for i in range(depth):
            x = functional_call(self.block, {k: v[i] for k, v in stacked.items()},
                                (x, pad_mask))
        return x

    def logits(self, local: Params, tokens: torch.Tensor) -> torch.Tensor:
        """The logits ``[B, classes]`` of ``tokens [B, L]`` on every stage,
        ``local`` in this stage's layout."""
        rest, stacked = split_tree(local)
        M, pp, stage = self.M, self.pp, self.stage
        B, L = tokens.shape
        if B % M:
            raise ValueError(
                f"pipelined minibatch of {B} samples is not divisible by "
                f"microbatches={M}; pick batch_size (and, in multiplicity "
                f"sample mode, n_local) divisible by M"
            )
        mb = B // M
        toks = tokens.reshape(M, mb, L)
        pads = toks != self.model.pad_id
        W, dt = self.model.width, self.model.dtype
        dev = tokens.device
        zeros = torch.zeros((mb, L, W), dtype=dt, device=dev)
        true = torch.ones((), dtype=torch.bool, device=dev)
        last = stage == pp - 1
        total = M + pp - 1
        recv, outs, y = None, [], None
        for t in range(total):
            if stage == 0:
                x0 = self.embed(rest, toks[t]) if t < M else zeros
                # The received value is never read on stage 0, but its hop's
                # backward must run here too (module docstring).
                xin = x0 if recv is None else torch.where(true, x0, recv)
            else:
                xin = zeros if recv is None else recv
            y = self.stage_apply(stacked, xin, pads[min(max(t - stage, 0), M - 1)])
            if t < total - 1:
                recv = collectives.hop(y, self.group)
            if last and t >= pp - 1:
                outs.append(y)
        C = rest["head.bias"].shape[-1]
        if last:
            local = torch.cat([self.head(rest, o, pads[m]) for m, o in enumerate(outs)])
        else:
            # Zero logits that the last output still reaches (module docstring).
            local = torch.where(~true, y.float().sum(),
                                torch.zeros((B, C), dtype=torch.float32, device=dev))
        return collectives.reduce_from(local, self.group, "pp_psum")


def pp_place_params(params: Params, plan: MeshPlan) -> Tuple[Params, Params]:
    """Split dense params into ``(rest, stacked)`` for this rank: ``rest``
    the replicated leaves, ``stacked`` this stage's ``[depth/pp, ...]``
    slice of the block stack (copies)."""
    if plan.pp <= 1:
        raise ValueError(
            "pp_place_params needs a mesh with a pp axis (make_mesh_plan(pp=...))"
        )
    return split_tree({k: v.detach().clone() for k, v in stage_params(params, plan).items()})


def pp_forward(model, params, tokens, plan: MeshPlan,
               num_microbatches: Optional[int] = None) -> torch.Tensor:
    """Forward the dense-attention text ``model`` with its blocks pipelined
    over the plan's ``pp`` ranks and the batch ``tokens [B, L]`` over
    ``dp``. ``params`` is the dense dict or ``pp_place_params``'s pair.
    Returns the global logits ``[B, num_classes]`` on every rank."""
    M = _validate_pp_inputs(model, plan, "pp_forward", tokens, num_microbatches)
    rest, stacked = params if isinstance(params, tuple) else pp_place_params(params, plan)
    dev = _device_of(rest)
    tok = torch.as_tensor(np.asarray(tokens)[_rows(len(tokens), plan)], dtype=torch.long,
                          device=dev)
    with torch.no_grad():
        logits = PipelinedBody(model, plan, M).logits(pp_tree(rest, stacked), tok)
    return collectives.all_gather([logits], plan.dp_group)[0]


def pp_train_step(model, rest: Params, stacked: Params, opt_state, tokens, labels,
                  optimizer, plan: MeshPlan, num_microbatches: Optional[int] = None):
    """One optimizer step with the block stack pipelined over ``pp`` and the
    batch over ``dp``. ``rest``/``stacked`` come from
    :func:`pp_place_params`; ``optimizer`` is functional
    (``engine/algorithms.py``), its state made by ``optimizer.init(
    pp_tree(rest, stacked))``. Returns ``(rest, stacked, opt_state,
    loss)``, ``loss`` the mean cross-entropy over the global batch.

    Each rank differentiates the mean loss of its dp rows: its block
    gradients are exact for its stage, and its replicated leaves hold its
    stage's partial (the embedding's on stage 0, the head's on the last),
    so those sum over ``pp``; everything then averages over ``dp``."""
    M = _validate_pp_inputs(model, plan, "pp_train_step", tokens, num_microbatches)
    dev = _device_of(rest)
    rows = _rows(len(tokens), plan)
    tok = torch.as_tensor(np.asarray(tokens)[rows], dtype=torch.long, device=dev)
    lab = torch.as_tensor(np.asarray(labels)[rows], dtype=torch.long, device=dev)
    tree = pp_tree(rest, stacked)
    leaves = {k: v.detach().requires_grad_(True) for k, v in tree.items()}
    body = PipelinedBody(model, plan, M)
    loss_d = F.cross_entropy(body.logits(leaves, tok).float(), lab)
    # A stage uses only its own replicated leaves (the embedding on stage 0,
    # the head on the last): the others' gradients here are zero.
    raw = torch.autograd.grad(loss_d, list(leaves.values()), allow_unused=True)
    grads = body.fix_grads({k: torch.zeros_like(v) if g is None else g
                            for (k, v), g in zip(leaves.items(), raw)})
    keys = list(grads)
    reduced = collectives.psum([grads[k] for k in keys] + [loss_d.detach().reshape(1)],
                               plan.dp_group)
    grads = {k: g / plan.dp for k, g in zip(keys, reduced)}
    loss = float(reduced[-1][0]) / plan.dp
    updates, opt_state = optimizer.update(grads, opt_state)
    rest, stacked = split_tree({k: (p + updates[k]).detach() for k, p in tree.items()})
    return rest, stacked, opt_state, loss
