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
from olearning_sim_tpu_torch.models.common import default_init_params
from olearning_sim_tpu_torch.models.registry import ModelSpec, register_model
from olearning_sim_tpu_torch.ops import flash_attention
from olearning_sim_tpu_torch.parallel.ring_attention import (
    all_reduce_sum,
    group_rank,
    ring_self_attention,
)

LN_EPS = 1e-6


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, LN_EPS)
    return y.to(dtype)


class TransformerBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_impl: str = "dense", ring_use_flash: bool = False):
        super().__init__()
        if attention_impl not in ("dense", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        if width % heads:
            raise ValueError(f"width {width} is not a multiple of heads {heads}")
        self.heads, self.dtype = heads, dtype
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

    def _dense_attention(self, x, pad_mask):
        B, L, W = x.shape
        H, dt = self.heads, self.dtype
        D = W // H
        q = _dense(x, self.query, dt).view(B, L, H, D)
        k = _dense(x, self.key, dt).view(B, L, H, D)
        v = _dense(x, self.value, dt).view(B, L, H, D)
        q = q / torch.tensor(math.sqrt(D), dtype=dt)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        mask = pad_mask[:, None, :, None] & pad_mask[:, None, None, :]
        s = torch.where(mask, s, torch.finfo(dt).min)
        w = torch.softmax(s, dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, W)
        return _dense(o, self.out, dt)

    def _flash_attention(self, x, pad_mask):
        B, L, W = x.shape
        H = self.heads
        qkv = _dense(x, self.qkv, self.dtype).view(B, L, 3, H, W // H)
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        o = flash_attention(q, k, v, kv_mask=pad_mask)
        o = o.transpose(1, 2).reshape(B, L, W)
        return _dense(o, self.attn_out, self.dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, sp_group=None) -> torch.Tensor:
        # pad_mask: [B, L] bool, True = real token.
        if self.attention_impl == "flash":
            y = self._flash_attention(x, pad_mask)
        elif self.attention_impl == "ring":
            y = ring_self_attention(self, x, pad_mask, sp_group, self.heads, self.dtype,
                                    self.ring_use_flash)
        else:
            y = self._dense_attention(x, pad_mask)
        x = _layer_norm(x + y, self.ln_1, self.dtype)  # post-LN, BERT-style
        y = _dense(x, self.mlp_in, self.dtype)
        y = F.gelu(y, approximate="tanh")
        y = _dense(y, self.mlp_out, self.dtype)
        return _layer_norm(x + y, self.ln_2, self.dtype)


class TextTransformer(nn.Module):
    def __init__(self, vocab_size: int = 30522, max_len: int = 128,
                 width: int = 768, depth: int = 6, heads: int = 12,
                 mlp_dim: int = 3072, num_classes: int = 2, pad_id: int = 0,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_impl: str = "dense", ring_use_flash: bool = False):
        super().__init__()
        self.pad_id, self.dtype = pad_id, dtype
        self.max_len, self.attention_impl = max_len, attention_impl
        self.embed = nn.Embedding(vocab_size, width)
        self.pos_embedding = nn.Parameter(torch.zeros(1, max_len, width))
        self.ln_emb = nn.LayerNorm(width)
        self.blocks = nn.ModuleList(
            TransformerBlock(width, heads, mlp_dim, dtype, attention_impl, ring_use_flash)
            for _ in range(depth)
        )
        self.head = nn.Linear(width, num_classes)

    def forward(self, tokens: torch.Tensor, sp_group=None) -> torch.Tensor:
        # tokens: [B, L] integer ids; returns [B, num_classes] f32 logits.
        # Under attention_impl="ring", tokens is this rank's chunk of the
        # sequence over sp_group (None: the whole sequence, a ring of one).
        ring = self.attention_impl == "ring"
        if sp_group is not None and not ring:
            raise ValueError("sp_group needs attention_impl='ring'")
        pad_mask = tokens != self.pad_id
        L = tokens.shape[1]
        offset = group_rank(sp_group) * L if ring else 0
        if offset + L > self.max_len:
            raise ValueError(
                f"positions {offset}..{offset + L - 1} exceed max_len {self.max_len}")
        emb = F.embedding(tokens, self.embed.weight)
        x = (emb + self.pos_embedding[:, offset:offset + L]).to(self.dtype)
        x = _layer_norm(x, self.ln_emb, self.dtype)
        for block in self.blocks:
            x = block(x, pad_mask, sp_group)
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
