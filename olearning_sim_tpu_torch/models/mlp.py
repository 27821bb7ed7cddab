"""MLP family (``mlp2``: FedAvg on MNIST-shaped inputs, 784-200-10).

The JAX package's ``models/mlp.py`` as a ``torch.nn`` module: the input is
flattened and cast to bf16, each hidden Dense and its ReLU run in bf16, and
the head is a Dense in f32. Every layer casts its own weight and bias to its
compute dtype (flax's ``Dense(dtype=...)``), so the head computes in f32
from bf16 parameters as well.

flax infers the input width at ``init``; here it is a constructor argument
(``in_features``), which the registry derives from the input shape.
Layers are ``dense.0 .. dense.n`` in flax's ``Dense_0 .. Dense_n`` order.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from olearning_sim_tpu_torch.models.common import dense, default_init_params
from olearning_sim_tpu_torch.models.registry import ModelSpec, register_model


class MLP(nn.Module):
    def __init__(self, hidden: Sequence[int] = (200,), num_classes: int = 10,
                 in_features: int = 784):
        super().__init__()
        widths = [in_features, *hidden, num_classes]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [B, *feature]; returns [B, num_classes] f32 logits.
        x = x.reshape(x.shape[0], -1).to(torch.bfloat16)
        for lin in self.dense[:-1]:
            x = F.relu(dense(x, lin, torch.bfloat16))
        return dense(x, self.dense[-1], torch.float32)

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Fresh f32 parameters (lecun-normal kernels, zero biases)."""
        return default_init_params(self, generator)


register_model(
    ModelSpec(
        name="mlp2",
        builder=MLP,
        example_input_shape=(28, 28, 1),
        num_classes=10,
        defaults={"hidden": (200,), "num_classes": 10},
        shape_kwargs=lambda shape: {"in_features": math.prod(shape)},
    )
)
