"""ResNet family (``resnet18``: FedProx on FEMNIST-shaped inputs).

The JAX package's ``models/resnet.py`` as ``torch.nn`` modules. Inputs are
NHWC ``[N, H, W, C]``, as the data generators emit them; inside, the
activations are a permuted NCHW view for ``F.conv2d``.

- Computation is in ``dtype`` (bf16 by default), as in flax's modules.
- Convolutions are bias-free, with XLA's SAME padding
  (:func:`~olearning_sim_tpu_torch.models.common.same_conv`): a stride-2
  3x3 pads (0, 1) at 28 -> 14 and 14 -> 7 and (1, 1) at 7 -> 4; the 1x1
  stride-2 shortcut pads 0.
- GroupNorm is flax's: epsilon 1e-6, ``min(groups, features)`` groups of
  consecutive channels, statistics, scale and bias in f32, the result cast
  to ``dtype`` (``F.group_norm`` on NCHW groups channels as flax's NHWC reshape
  does).
- A residual block has a 1x1 projection shortcut exactly where flax's
  ``residual.shape != y.shape`` holds, which depends on the input shape:
  the registry passes it as ``in_shape``.
- ``small_inputs=False`` is the 7x7/2 stem with a 3x3/2 SAME max-pool,
  padded with -inf before and after as XLA's ``reduce_window`` pads it.
- The mean over H and W is taken in ``dtype``; the head is an f32 Dense.

Layers are ``conv.i`` / ``norm.i`` / ``dense.i`` / ``blocks.i`` in flax's
``Conv_i`` / ``GroupNorm_i`` / ``Dense_i`` / ``ResidualBlock_i`` order.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from olearning_sim_tpu_torch.models.common import (
    default_init_params,
    dense,
    flax_special,
    resolve_dtype,
    same_conv,
    same_pads,
)
from olearning_sim_tpu_torch.models.registry import ModelSpec, register_model

GN_EPS = 1e-6


def group_norm(x: torch.Tensor, gn: nn.GroupNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax ``GroupNorm(dtype=dtype)`` on NCHW ``x``."""
    y = F.group_norm(x.float(), gn.num_groups, gn.weight.float(), gn.bias.float(), GN_EPS)
    return y.to(dtype)


def _norm(groups: int, features: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(groups, features), features, eps=GN_EPS)


def _same_out(n: int, stride: int) -> int:
    return -(-n // stride)


class ResidualBlock(nn.Module):
    """Basic (non-bottleneck) residual block, 3x3 + 3x3, GroupNorm; a 1x1
    projection shortcut when the block changes the activation's shape."""

    def __init__(self, in_features: int, features: int, strides: int = 1, groups: int = 8,
                 in_hw: Tuple[int, int] = (1, 1), dtype: torch.dtype | str = torch.bfloat16):
        super().__init__()
        self.strides, self.dtype = strides, resolve_dtype(dtype)
        out_hw = tuple(_same_out(n, strides) for n in in_hw)
        self.project = (out_hw, features) != (tuple(in_hw), in_features)
        chans = [(in_features, features, 3), (features, features, 3)]
        if self.project:
            chans.append((in_features, features, 1))
        self.conv = nn.ModuleList(nn.Conv2d(a, b, k, bias=False) for a, b, k in chans)
        self.norm = nn.ModuleList(_norm(groups, features) for _ in chans)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, dt = self.strides, self.dtype
        y = F.relu(group_norm(same_conv(x, self.conv[0], s, dt), self.norm[0], dt))
        y = group_norm(same_conv(y, self.conv[1], 1, dt), self.norm[1], dt)
        residual = x
        if self.project:
            residual = group_norm(same_conv(x, self.conv[2], s, dt), self.norm[2], dt)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet-18-shaped network: stem + 4 stages x ``blocks_per_stage`` basic
    blocks + global average pool + f32 classifier head."""

    def __init__(self, stage_features: Sequence[int] = (64, 128, 256, 512),
                 blocks_per_stage: Sequence[int] = (2, 2, 2, 2), num_classes: int = 62,
                 groups: int = 8, small_inputs: bool = True,
                 dtype: torch.dtype | str = torch.bfloat16,
                 in_shape: Tuple[int, int, int] = (28, 28, 1)):
        super().__init__()
        h, w, c = in_shape
        self.small_inputs, self.dtype = small_inputs, resolve_dtype(dtype)
        stem = stage_features[0]
        self.conv = nn.ModuleList([nn.Conv2d(c, stem, 3 if small_inputs else 7, bias=False)])
        self.norm = nn.ModuleList([_norm(groups, stem)])
        if not small_inputs:
            h, w = (_same_out(_same_out(n, 2), 2) for n in (h, w))  # conv /2, pool /2
        blocks = []
        feats_in = stem
        for stage, (feats, nblocks) in enumerate(zip(stage_features, blocks_per_stage)):
            for block in range(nblocks):
                strides = 2 if stage > 0 and block == 0 else 1
                blocks.append(ResidualBlock(feats_in, feats, strides, groups, (h, w), self.dtype))
                h, w, feats_in = _same_out(h, strides), _same_out(w, strides), feats
        self.blocks = nn.ModuleList(blocks)
        self.dense = nn.ModuleList([nn.Linear(feats_in, num_classes)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [N, H, W, C]; returns [N, num_classes] f32 logits.
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        if self.small_inputs:
            x = same_conv(x, self.conv[0], 1, dt)
        else:
            x = same_conv(x, self.conv[0], 2, dt)
            x = F.max_pool2d(F.pad(x, same_pads(x, 3, 2), value=float("-inf")), 3, 2)
        x = F.relu(group_norm(x, self.norm[0], dt))
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return dense(x, self.dense[0], torch.float32)

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Fresh f32 parameters: lecun-normal kernels, zero biases, unit
        GroupNorm scales."""
        return default_init_params(self, generator, flax_special(generator))


register_model(
    ModelSpec(
        name="resnet18",
        builder=ResNet,
        example_input_shape=(28, 28, 1),
        num_classes=62,
        defaults={
            "stage_features": (64, 128, 256, 512),
            "blocks_per_stage": (2, 2, 2, 2),
            "num_classes": 62,
            "small_inputs": True,
        },
        shape_kwargs=lambda shape: {"in_shape": tuple(int(s) for s in shape)},
    )
)
