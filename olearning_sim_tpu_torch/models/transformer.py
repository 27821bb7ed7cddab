"""Text-transformer family: the DistilBERT-shaped encoder of
the JAX package's ``models/transformer.py`` as ``torch.nn`` modules.

6 layers, width 768, 12 heads, GELU FFN 3072, learned positional
embeddings, post-LN residuals. Token inputs are integers; padding id 0 is
masked out of attention and pooling. The flax modules are followed as
written, since the parity tests hold the two against each other:

- params are f32; compute is in ``dtype`` (bf16 by default): every Dense
  casts its input, kernel and bias to ``dtype``;
- embedding plus positional embedding is f32, then cast; the mean-pool and
  the classifier head are f32;
- LayerNorm has epsilon 1e-6 and takes its statistics in f32;
- GELU is the tanh approximation;
- ``attention_impl="dense"`` is flax's ``MultiHeadDotProductAttention``:
  separate query/key/value/out projections, the query scaled by
  1/sqrt(D), masked scores set to ``finfo(dtype).min`` and the softmax in
  the compute dtype (so a query row with no real key attends uniformly);
- ``attention_impl="flash"`` is one fused qkv projection, the
  :func:`~olearning_sim_tpu_torch.ops.flash_attention` kernel (forward
  only: evaluation, not training) and an ``attn_out`` projection;
- ``attention_impl="ring"`` is sequence-parallel ring attention
  (:mod:`olearning_sim_tpu_torch.parallel.ring_attention`) with the dense
  branch's ``query``/``key``/``value``/``out`` parameters, so the same
  weights apply under either. ``tokens`` is then this rank's chunk of the
  sequence: positions are offset by ``sp_rank * L``, and the mean-pool sums
  over the ``sp_group`` passed to ``forward`` (``None``: a ring of one).
  ``ring_use_flash`` takes each ring step through the stats kernel
  (trainable) instead of plain torch ops.

Tensor parallelism (``mp_group`` passed to ``forward``): a block handed
its shards (:func:`~olearning_sim_tpu_torch.parallel.tp.shard_params`)
runs the dense attention on its local heads and the FFN on its local
columns, each closed by a sum over the group; a leaf left whole (heads
that do not divide mp, the flash branch's ``qkv``/``attn_out``) computes
whole on every rank, so a flash forward at mp 2 runs the kernel on every
rank with all heads.

Linear layers keep PyTorch's ``[out, in]`` weight layout;
:mod:`olearning_sim_tpu_torch.weights` converts from and to the flax
parameter tree.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from olearning_sim_tpu_torch.models.common import dense as _dense
from olearning_sim_tpu_torch.models.common import (
    default_init_params,
    ffn,
    resolve_dtype,
    row_dense,
)
from olearning_sim_tpu_torch.models.registry import ModelSpec, register_model
from olearning_sim_tpu_torch.ops import flash_attention
from olearning_sim_tpu_torch.parallel import collectives
from olearning_sim_tpu_torch.parallel.ring_attention import (
    all_reduce_sum,
    group_rank,
    ring_self_attention,
)

LN_EPS = 1e-6


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=dtype)``: statistics, scale and bias in f32
    (whatever the parameters' dtype), the result cast to ``dtype``."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                     LN_EPS)
    return y.to(dtype)


def dense_attention(attn: nn.Module, x: torch.Tensor, pad_mask, heads: int,
                    dtype: torch.dtype, mp_group=None) -> torch.Tensor:
    """flax's ``MultiHeadDotProductAttention`` self-attention on ``x [B, L,
    W]`` with ``attn``'s ``query``/``key``/``value``/``out`` Linears: the
    query scaled by 1/sqrt(D), the softmax in ``dtype``; ``pad_mask [B, L]``
    (True = real token) masks both ends of a score to ``finfo(dtype).min``,
    and ``None`` masks nothing. When ``attn`` holds this rank's heads of an
    ``mp_group`` split (fewer than ``heads``), the projections run
    column-parallel on them and ``out`` row-parallel."""
    B, L, W = x.shape
    D = W // heads
    h = attn.query.weight.shape[0] // D
    split = mp_group is not None and h != heads
    # One f for the three column-parallel projections (the identity whole).
    xin = collectives.copy_to(x, mp_group) if split else x
    q, k, v = (_dense(xin, lin, dtype).view(B, L, h, D)
               for lin in (attn.query, attn.key, attn.value))
    q = q / torch.tensor(math.sqrt(D), dtype=dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if pad_mask is not None:
        mask = pad_mask[:, None, :, None] & pad_mask[:, None, None, :]
        s = torch.where(mask, s, torch.finfo(dtype).min)
    w = torch.softmax(s, dim=-1).to(dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, h * D)
    return row_dense(o, attn.out, dtype, mp_group) if split else _dense(o, attn.out, dtype)


class TransformerBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_dim: int,
                 dtype: torch.dtype | str = torch.bfloat16,
                 attention_impl: str = "dense", ring_use_flash: bool = False):
        super().__init__()
        if attention_impl not in ("dense", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        if width % heads:
            raise ValueError(f"width {width} is not a multiple of heads {heads}")
        self.heads, self.dtype, self.mlp_dim = heads, resolve_dtype(dtype), mlp_dim
        self.attention_impl = attention_impl
        self.ring_use_flash = ring_use_flash
        if attention_impl == "flash":
            self.qkv = nn.Linear(width, 3 * width)
            self.attn_out = nn.Linear(width, width)
        else:
            self.query = nn.Linear(width, width)
            self.key = nn.Linear(width, width)
            self.value = nn.Linear(width, width)
            self.out = nn.Linear(width, width)
        self.ln_1 = nn.LayerNorm(width)
        self.mlp_in = nn.Linear(width, mlp_dim)
        self.mlp_out = nn.Linear(mlp_dim, width)
        self.ln_2 = nn.LayerNorm(width)

    def _flash_attention(self, x, pad_mask):
        B, L, W = x.shape
        H = self.heads
        qkv = _dense(x, self.qkv, self.dtype).view(B, L, 3, H, W // H)
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        o = flash_attention(q, k, v, kv_mask=pad_mask)
        o = o.transpose(1, 2).reshape(B, L, W)
        return _dense(o, self.attn_out, self.dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, sp_group=None,
                mp_group=None) -> torch.Tensor:
        # pad_mask: [B, L] bool, True = real token.
        if self.attention_impl == "flash":
            y = self._flash_attention(x, pad_mask)
        elif self.attention_impl == "ring":
            y = ring_self_attention(self, x, pad_mask, sp_group, self.heads, self.dtype,
                                    self.ring_use_flash)
        else:
            y = dense_attention(self, x, pad_mask, self.heads, self.dtype, mp_group)
        x = layer_norm(x + y, self.ln_1, self.dtype)  # post-LN, BERT-style
        y = ffn(x, self.mlp_in, self.mlp_out, self.mlp_dim, self.dtype, mp_group)
        return layer_norm(x + y, self.ln_2, self.dtype)


class TextTransformer(nn.Module):
    def __init__(self, vocab_size: int = 30522, max_len: int = 128,
                 width: int = 768, depth: int = 6, heads: int = 12,
                 mlp_dim: int = 3072, num_classes: int = 2, pad_id: int = 0,
                 dtype: torch.dtype | str = torch.bfloat16,
                 attention_impl: str = "dense", ring_use_flash: bool = False):
        super().__init__()
        self.pad_id, self.dtype, self.heads = pad_id, resolve_dtype(dtype), heads
        self.max_len, self.attention_impl = max_len, attention_impl
        self.vocab_size, self.width, self.depth = vocab_size, width, depth
        self.mlp_dim, self.num_classes = mlp_dim, num_classes
        self.embed = nn.Embedding(vocab_size, width)
        self.pos_embedding = nn.Parameter(torch.zeros(1, max_len, width))
        self.ln_emb = nn.LayerNorm(width)
        self.blocks = nn.ModuleList(
            TransformerBlock(width, heads, mlp_dim, self.dtype, attention_impl, ring_use_flash)
            for _ in range(depth)
        )
        self.head = nn.Linear(width, num_classes)

    def forward(self, tokens: torch.Tensor, sp_group=None, mp_group=None) -> torch.Tensor:
        # tokens: [B, L] integer ids; returns [B, num_classes] f32 logits.
        # Under attention_impl="ring", tokens is this rank's chunk of the
        # sequence over sp_group (None: the whole sequence, a ring of one).
        # With mp_group the blocks run on their tensor-parallel shards.
        ring = self.attention_impl == "ring"
        if sp_group is not None and not ring:
            raise ValueError("sp_group needs attention_impl='ring'")
        if mp_group is not None and ring:
            raise ValueError("mp_group does not compose with attention_impl='ring'")
        pad_mask = tokens != self.pad_id
        L = tokens.shape[1]
        offset = group_rank(sp_group) * L if ring else 0
        if offset + L > self.max_len:
            raise ValueError(
                f"positions {offset}..{offset + L - 1} exceed max_len {self.max_len}")
        emb = F.embedding(tokens, self.embed.weight)
        x = (emb + self.pos_embedding[:, offset:offset + L]).to(self.dtype)
        x = layer_norm(x, self.ln_emb, self.dtype)
        for block in self.blocks:
            x = block(x, pad_mask, sp_group, mp_group)
        # Mean-pool over real tokens (of the global sequence under ring).
        m = pad_mask[..., None].float()
        s = all_reduce_sum((x.float() * m).sum(1), sp_group)
        c = all_reduce_sum(m.sum(1), sp_group)
        pooled = s / torch.clamp(c, min=1.0)
        return F.linear(pooled, self.head.weight, self.head.bias)

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Fresh f32 parameters on the CPU, drawn from ``generator`` with
        flax's initializers (normal(0.02) embeddings, lecun-normal kernels,
        zero biases, unit LayerNorm scales). The module itself is left
        untouched."""

        def special(name, t):
            if name in ("embed.weight", "pos_embedding"):
                nn.init.normal_(t, std=0.02, generator=generator)
            elif ".ln" in name or name.startswith("ln"):
                nn.init.constant_(t, 1.0 if name.endswith("weight") else 0.0)
            else:
                return False
            return True

        return default_init_params(self, generator, special)


register_model(
    ModelSpec(
        name="distilbert",
        builder=TextTransformer,
        example_input_shape=(64,),
        num_classes=2,
        defaults={
            "vocab_size": 30522,
            "max_len": 64,
            "width": 768,
            "depth": 6,
            "heads": 12,
            "mlp_dim": 3072,
            "num_classes": 2,
        },
        input_dtype=np.int32,
    )
)
