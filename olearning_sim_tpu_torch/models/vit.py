"""Vision Transformer family (``vit_tiny``: Ditto on CIFAR-100-shaped
inputs).

The JAX package's ``models/vit.py`` as ``torch.nn`` modules: ViT-Tiny with
patch 4 for 32x32 inputs, width 192, depth 12, 3 heads, MLP 768.

- Computation is in ``dtype`` (bf16 by default), as in flax's modules.
- The patch embedding is a VALID convolution with stride = patch and a
  bias; its NHWC output is flattened to ``[B, tokens, W]`` as
  flax reshapes it.
- ``cls`` is a zero-initialised f32 parameter ``[1, 1, W]``, broadcast and
  cast to ``dtype``; ``pos_embedding`` is ``[1, 1 + tokens, W]`` f32, cast
  and added. The registry derives the token count from the input
  shape (``in_shape``).
- The encoder blocks are pre-LN: LayerNorm, flax's dense
  ``MultiHeadDotProductAttention`` (no mask), residual; LayerNorm, Dense,
  tanh GELU, Dense, residual. LayerNorm has epsilon 1e-6 and f32
  statistics; every Dense computes in ``dtype``.
- A final LayerNorm, then an f32 Dense head on the ``cls`` token.
- With ``mp_group`` the blocks run on their tensor-parallel shards
  (:mod:`~olearning_sim_tpu_torch.parallel.tp`): at mp 2 ViT-Tiny's 3
  heads stay whole and its FFN columns split.

Layers are ``conv.0`` / ``norm.i`` / ``dense.i`` / ``blocks.i`` in flax's
``Conv_0`` / ``LayerNorm_i`` / ``Dense_i`` / ``EncoderBlock_i`` order; a
block's attention Linears are ``query``/``key``/``value``/``out`` as in the
text transformer.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from olearning_sim_tpu_torch.models.common import (
    default_init_params,
    dense,
    ffn,
    flax_special,
    resolve_dtype,
)
from olearning_sim_tpu_torch.models.registry import ModelSpec, register_model
from olearning_sim_tpu_torch.models.transformer import dense_attention, layer_norm


class EncoderBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_dim: int,
                 dtype: torch.dtype | str = torch.bfloat16):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} is not a multiple of heads {heads}")
        self.heads, self.dtype, self.mlp_dim = heads, resolve_dtype(dtype), mlp_dim
        self.norm = nn.ModuleList([nn.LayerNorm(width), nn.LayerNorm(width)])
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(width, width)
        self.value = nn.Linear(width, width)
        self.out = nn.Linear(width, width)
        self.dense = nn.ModuleList([nn.Linear(width, mlp_dim), nn.Linear(mlp_dim, width)])

    def forward(self, x: torch.Tensor, mp_group=None) -> torch.Tensor:
        dt = self.dtype
        y = layer_norm(x, self.norm[0], dt)
        x = x + dense_attention(self, y, None, self.heads, dt, mp_group)
        y = layer_norm(x, self.norm[1], dt)
        return x + ffn(y, self.dense[0], self.dense[1], self.mlp_dim, dt, mp_group)


class ViT(nn.Module):
    def __init__(self, patch: int = 4, width: int = 192, depth: int = 12, heads: int = 3,
                 mlp_dim: int = 768, num_classes: int = 100,
                 dtype: torch.dtype | str = torch.bfloat16,
                 in_shape: Tuple[int, int, int] = (32, 32, 3)):
        super().__init__()
        h, w, c = in_shape
        self.patch, self.width, self.heads, self.dtype = patch, width, heads, resolve_dtype(dtype)
        tokens = (h // patch) * (w // patch)
        self.conv = nn.ModuleList([nn.Conv2d(c, width, patch)])
        self.cls = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1 + tokens, width))
        self.blocks = nn.ModuleList(EncoderBlock(width, heads, mlp_dim, self.dtype)
                                    for _ in range(depth))
        self.norm = nn.ModuleList([nn.LayerNorm(width)])
        self.dense = nn.ModuleList([nn.Linear(width, num_classes)])

    def forward(self, x: torch.Tensor, mp_group=None) -> torch.Tensor:
        # x: [B, H, W, C]; returns [B, num_classes] f32 logits.
        dt = self.dtype
        b = x.shape[0]
        conv = self.conv[0]
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt), conv.bias.to(dt),
                     stride=self.patch)
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.width)
        x = torch.cat([self.cls.to(dt).expand(b, 1, self.width), x], dim=1)
        x = x + self.pos_embedding.to(dt)
        for block in self.blocks:
            x = block(x, mp_group)
        x = layer_norm(x, self.norm[0], dt)
        return dense(x[:, 0], self.dense[0], torch.float32)

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Fresh f32 parameters: lecun-normal kernels, zero biases and
        ``cls``, unit LayerNorm scales, normal(0.02) ``pos_embedding``."""
        return default_init_params(self, generator, flax_special(generator))


register_model(
    ModelSpec(
        name="vit_tiny",
        builder=ViT,
        example_input_shape=(32, 32, 3),
        num_classes=100,
        defaults={
            "patch": 4,
            "width": 192,
            "depth": 12,
            "heads": 3,
            "mlp_dim": 768,
            "num_classes": 100,
        },
        shape_kwargs=lambda shape: {"in_shape": tuple(int(s) for s in shape)},
    )
)
