"""Mixture-of-Experts text family (``moe_text``): Switch-style top-1 routing
with a static capacity, in every block of a post-LN text transformer.

The JAX package's ``models/moe.py`` as ``torch.nn`` modules. Routing is
one-hot einsums, not scatters, as there:

- the router is an f32 Dense on ``x.float()``; each token goes to the
  ``argmax`` expert (the first maximum), weighted by its gate probability;
- pads make no queue entry: their one-hot row is zeroed before the cumsum
  that gives each token its slot, so their slot is -1;
- the capacity is ``max(1, int(capacity_factor * S / E))`` with ``S = B *
  T`` tokens of one call: one client's batch inside ``vmap``,
  ``eval_batch_size`` rows in ``evaluate``. Pads and tokens past the
  capacity ride the residual unchanged;
- both one-hots are ``idx[..., None] == arange(n)``, which gives a zero row
  for -1 and for ``>= n`` (``F.one_hot`` refuses negative ids);
- the load-balancing loss ``E * sum_e f_e * P_e`` is taken over real
  tokens only. flax sows it into ``intermediates``; here
  ``forward(tokens, return_aux=True)`` returns ``(logits, aux)`` with the
  mean of the blocks' losses, and ``sows_aux_loss`` tells the round engine
  to add ``aux_loss_weight * aux`` to each client's loss.

The expert weights keep flax's layout (``expert_w1 [E, W, M]``,
``expert_b1 [E, 1, M]``, ``expert_w2 [E, M, W]``, ``expert_b2 [E, 1, W]``).
Layers are ``embed``, ``norm.i`` / ``dense.i`` / ``blocks.i`` in flax's
``LayerNorm_i`` / ``Dense_i`` / ``MoEBlock_i`` order, and a block's
``switch`` is its ``SwitchFFN_0``.

Model parallelism, through ``forward``'s groups:

- ``ep_group`` (expert parallelism,
  :mod:`~olearning_sim_tpu_torch.parallel.expert_parallel`): a switch
  handed its ranks' slice of the ``expert_*`` leaves routes every token as
  before (the router is replicated), runs its own experts on the tokens
  routed to them, and the combine is summed over the group; the tokens and
  gate values enter through Megatron's *f*, so their gradients sum too;
- ``mp_group`` (tensor parallelism): the blocks' attention runs on its
  local heads, as the text family's; the switch stays whole, as JAX's
  rules leave it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from olearning_sim_tpu_torch.models.common import (
    default_init_params,
    dense,
    flax_special,
    lecun_normal_,
    resolve_dtype,
)
from olearning_sim_tpu_torch.models.registry import ModelSpec, register_model
from olearning_sim_tpu_torch.models.transformer import dense_attention, layer_norm
from olearning_sim_tpu_torch.parallel import collectives


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)``: a zero row for ids outside ``[0, n)``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


class SwitchFFN(nn.Module):
    """Top-1 (Switch) MoE feed-forward: each token goes to one of
    ``num_experts`` expert FFNs, weighted by its gate probability."""

    def __init__(self, num_experts: int, width: int, mlp_dim: int,
                 capacity_factor: float = 1.25, dtype: torch.dtype | str = torch.bfloat16):
        super().__init__()
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.dtype = resolve_dtype(dtype)
        E = num_experts
        self.gate = nn.Linear(width, E)
        self.expert_w1 = nn.Parameter(torch.zeros(E, width, mlp_dim))
        self.expert_b1 = nn.Parameter(torch.zeros(E, 1, mlp_dim))
        self.expert_w2 = nn.Parameter(torch.zeros(E, mlp_dim, width))
        self.expert_b2 = nn.Parameter(torch.zeros(E, 1, width))

    def route(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None):
        """The routing of ``x [B, T, W]``: router probabilities ``[S, E]``,
        each token's expert ``[S]``, its one-hot ``[S, E]`` (zero for pads),
        its slot in the expert's queue ``[S]`` (-1 for pads), whether it is
        kept ``[S]``, and the capacity."""
        B, T, W = x.shape
        E = self.num_experts
        S = B * T
        cap = max(1, int(self.capacity_factor * S / E))
        vf = (torch.ones(S, dtype=torch.bool, device=x.device) if valid is None
              else valid.reshape(S))
        logits = dense(x.reshape(S, W), self.gate, torch.float32)
        probs = torch.softmax(logits, dim=-1)
        expert = torch.argmax(probs, dim=-1)
        onehot = _one_hot(expert, E, torch.int32) * vf[:, None].to(torch.int32)
        pos = torch.cumsum(onehot, dim=0) * onehot
        pos_in_expert = pos.sum(dim=-1) - 1
        keep = (pos_in_expert >= 0) & (pos_in_expert < cap)
        return probs, expert, onehot, pos_in_expert, keep, vf, cap

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                ep_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
        # x: [B, T, W]; valid: [B, T] bool, True = real token. Returns the
        # expert mixture [B, T, W] in x's dtype and the aux loss (f32).
        # Under ep_group the expert_* leaves are this rank's contiguous
        # slice of the experts.
        B, T, W = x.shape
        E, dt = self.num_experts, self.dtype
        probs, expert, onehot, pos_in_expert, keep, vf, cap = self.route(x, valid)
        gate_val = torch.amax(probs, dim=-1)
        dispatch = (_one_hot(expert, E, dt)[:, :, None]
                    * _one_hot(pos_in_expert, cap, dt)[:, None, :]
                    * keep[:, None, None].to(dt))                     # [S, E, C]
        xs = x.reshape(B * T, W).to(dt)
        split = ep_group is not None and self.expert_w1.shape[0] != E
        if split:
            n = self.expert_w1.shape[0]
            lo = collectives.rank(ep_group) * n
            dispatch = dispatch[:, lo:lo + n]
            xs = collectives.copy_to(xs, ep_group, "ep_psum")
            gate_val = collectives.copy_to(gate_val, ep_group, "ep_psum")
        combine = dispatch * gate_val[:, None, None].to(dt)
        xe = torch.einsum("sec,sd->ecd", dispatch, xs)
        h = F.gelu(torch.einsum("ecd,edm->ecm", xe, self.expert_w1.to(dt))
                   + self.expert_b1.to(dt), approximate="tanh")
        ye = torch.einsum("ecm,emd->ecd", h, self.expert_w2.to(dt)) + self.expert_b2.to(dt)
        y = torch.einsum("sec,ecd->sd", combine, ye)
        if split:
            y = collectives.reduce_from(y, ep_group, "ep_psum")
        n_valid = torch.clamp(vf.sum().float(), min=1.0)
        f = onehot.float().sum(dim=0) / n_valid
        p = (probs * vf[:, None].float()).sum(dim=0) / n_valid
        aux = E * torch.sum(f * p)
        return y.reshape(B, T, W).to(x.dtype), aux


class MoEBlock(nn.Module):
    """Post-LN block: masked dense attention, residual, LayerNorm; Switch
    FFN, residual, LayerNorm."""

    def __init__(self, width: int, heads: int, mlp_dim: int, num_experts: int,
                 capacity_factor: float = 1.25, dtype: torch.dtype | str = torch.bfloat16):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} is not a multiple of heads {heads}")
        self.heads, self.dtype = heads, resolve_dtype(dtype)
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(width, width)
        self.value = nn.Linear(width, width)
        self.out = nn.Linear(width, width)
        self.norm = nn.ModuleList([nn.LayerNorm(width), nn.LayerNorm(width)])
        self.switch = SwitchFFN(num_experts, width, mlp_dim, capacity_factor, self.dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, mp_group=None,
                ep_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
        y = dense_attention(self, x, pad_mask, self.heads, self.dtype, mp_group)
        x = layer_norm(x + y, self.norm[0], self.dtype)
        y, aux = self.switch(x, pad_mask, ep_group)
        return layer_norm(x + y, self.norm[1], self.dtype), aux


class MoETextTransformer(nn.Module):
    """Text classifier with Switch-MoE FFNs in every block (the dense text
    family's conventions: integer tokens, ``pad_id`` masked out of
    attention, routing and the mean-pool)."""

    # The round engine adds aux_loss_weight * forward(x, return_aux=True)[1]
    # to each client's loss.
    sows_aux_loss = True

    def __init__(self, vocab_size: int = 30522, max_len: int = 128, width: int = 256,
                 depth: int = 4, heads: int = 8, mlp_dim: int = 512, num_experts: int = 8,
                 capacity_factor: float = 1.25, num_classes: int = 2, pad_id: int = 0,
                 dtype: torch.dtype | str = torch.bfloat16):
        super().__init__()
        self.pad_id, self.heads, self.max_len = pad_id, heads, max_len
        self.dtype = resolve_dtype(dtype)
        self.embed = nn.Embedding(vocab_size, width)
        self.pos_embedding = nn.Parameter(torch.zeros(1, max_len, width))
        self.norm = nn.ModuleList([nn.LayerNorm(width)])
        self.blocks = nn.ModuleList(
            MoEBlock(width, heads, mlp_dim, num_experts, capacity_factor, self.dtype)
            for _ in range(depth))
        self.dense = nn.ModuleList([nn.Linear(width, num_classes)])

    def forward(self, tokens: torch.Tensor, return_aux: bool = False, mp_group=None,
                ep_group=None):
        # tokens: [B, L] integer ids; returns [B, num_classes] f32 logits,
        # and with return_aux the mean of the blocks' aux losses.
        L = tokens.shape[1]
        if L > self.max_len:
            raise ValueError(f"sequence length {L} exceeds max_len {self.max_len}")
        pad_mask = tokens != self.pad_id
        x = (F.embedding(tokens, self.embed.weight) + self.pos_embedding[:, :L]).to(self.dtype)
        x = layer_norm(x, self.norm[0], self.dtype)
        auxes = []
        for block in self.blocks:
            x, aux = block(x, pad_mask, mp_group, ep_group)
            auxes.append(aux)
        m = pad_mask[..., None].float()
        pooled = (x.float() * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        logits = dense(pooled, self.dense[0], torch.float32)
        if return_aux:
            return logits, sum(auxes) / len(auxes)
        return logits

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Fresh f32 parameters with flax's initializers: normal(0.02)
        embeddings, lecun-normal kernels (an expert kernel ``[E, in, out]``
        has flax's fan-in ``E * in``), zero biases, unit LayerNorm scales."""
        norm_special = flax_special(generator)

        def special(name, t):
            if name.endswith(("expert_w1", "expert_w2")):
                lecun_normal_(t, generator, fan_in=t.shape[0] * t.shape[1])
                return True
            if name.endswith(("expert_b1", "expert_b2")):
                nn.init.zeros_(t)
                return True
            return norm_special(name, t)

        return default_init_params(self, generator, special)


register_model(
    ModelSpec(
        name="moe_text",
        builder=MoETextTransformer,
        example_input_shape=(64,),
        num_classes=2,
        input_dtype=np.int32,
        defaults={
            "vocab_size": 30522, "max_len": 128, "width": 256, "depth": 4,
            "heads": 8, "mlp_dim": 512, "num_experts": 8, "num_classes": 2,
        },
    )
)
