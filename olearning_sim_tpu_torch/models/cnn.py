"""CNN families (``cnn4``: FedAvg on CIFAR-10-shaped inputs; ``cnn4_pool``).

The JAX package's ``models/cnn.py`` as ``torch.nn`` modules. Inputs are
NHWC ``[N, H, W, C]``, as the data generators emit them; inside, the
activations are a permuted NCHW view for ``F.conv2d``.

- ``CNN``: three 3x3 stride-2 convolutions with SAME padding and ReLU in
  bf16, a mean over H and W, and an f32 Dense head.
- ``CNNPool``: 3x3 stride-1 SAME convolutions, each followed by ReLU and a
  2x2 stride-2 VALID max-pool, then a flatten in flax's NHWC order, a bf16
  Dense with ReLU and an f32 Dense head.

SAME padding is XLA's: the total pad ``max((ceil(n/s) - 1)*s + k - n, 0)``
goes ``total // 2`` before and the rest after, so a 3x3 stride-2
convolution of an even input pads 0 before and 1 after on each spatial
axis (``padding=1`` in ``F.conv2d`` would pad 1 and 1, another function).
Layers are ``conv.i`` and ``dense.j`` in flax's ``Conv_i`` / ``Dense_j``
order; the registry derives the input channels (and ``CNNPool``'s flatten
width) from the input shape, which flax infers at ``init``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from olearning_sim_tpu_torch.models.common import dense, default_init_params
from olearning_sim_tpu_torch.models.registry import ModelSpec, register_model


def _same_conv(x: torch.Tensor, conv: nn.Conv2d, stride: int) -> torch.Tensor:
    """flax ``Conv(padding="SAME", strides=stride, dtype=bf16)`` on NCHW ``x``."""
    k = conv.weight.shape[-1]
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad lists the last axis first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x.to(torch.bfloat16), pads)
    return F.conv2d(x, conv.weight.to(torch.bfloat16), conv.bias.to(torch.bfloat16),
                    stride=stride)


class CNN(nn.Module):
    """All-convolutional ``cnn4``: three stride-2 conv blocks, global average
    pool, f32 head."""

    def __init__(self, features: Sequence[int] = (32, 64, 128), num_classes: int = 10,
                 in_channels: int = 3):
        super().__init__()
        chans = [in_channels, *features]
        self.conv = nn.ModuleList(nn.Conv2d(a, b, 3) for a, b in zip(chans[:-1], chans[1:]))
        self.dense = nn.ModuleList([nn.Linear(chans[-1], num_classes)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [N, H, W, C]; returns [N, num_classes] f32 logits.
        x = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        for conv in self.conv:
            x = F.relu(_same_conv(x, conv, 2))
        x = x.mean(dim=(2, 3))
        return dense(x, self.dense[0], torch.float32)

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Fresh f32 parameters (lecun-normal kernels, zero biases)."""
        return default_init_params(self, generator)


class CNNPool(nn.Module):
    """The conv / max-pool / dense ``cnn4_pool``."""

    def __init__(self, features: Sequence[int] = (32, 64), dense: int = 128,
                 num_classes: int = 10, in_shape: Tuple[int, int, int] = (32, 32, 3)):
        super().__init__()
        h, w, c = in_shape
        chans = [c, *features]
        self.conv = nn.ModuleList(nn.Conv2d(a, b, 3) for a, b in zip(chans[:-1], chans[1:]))
        for _ in features:
            h, w = h // 2, w // 2
        self.dense = nn.ModuleList([nn.Linear(h * w * chans[-1], dense),
                                    nn.Linear(dense, num_classes)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        for conv in self.conv:
            x = F.max_pool2d(F.relu(_same_conv(x, conv, 1)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax flattens NHWC
        x = F.relu(dense(x, self.dense[0], torch.bfloat16))
        return dense(x, self.dense[1], torch.float32)

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Fresh f32 parameters (lecun-normal kernels, zero biases)."""
        return default_init_params(self, generator)


register_model(
    ModelSpec(
        name="cnn4",
        builder=CNN,
        example_input_shape=(32, 32, 3),
        num_classes=10,
        defaults={"features": (32, 64, 128), "num_classes": 10},
        shape_kwargs=lambda shape: {"in_channels": int(shape[-1])},
    )
)

register_model(
    ModelSpec(
        name="cnn4_pool",
        builder=CNNPool,
        example_input_shape=(32, 32, 3),
        num_classes=10,
        defaults={"features": (32, 64), "dense": 128, "num_classes": 10},
        shape_kwargs=lambda shape: {"in_shape": tuple(int(s) for s in shape)},
    )
)
