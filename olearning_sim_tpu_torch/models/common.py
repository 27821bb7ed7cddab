"""Pieces shared by every model family of the port: flax's default
initializers, and a ``Dense`` with flax's dtype semantics.

A ``Dense`` or ``Conv`` kernel is lecun-normal (a normal truncated at +-2
sigma, rescaled to unit variance, times 1/sqrt(fan_in)), with fan-in = the
input width of a Linear weight ``[out, in]`` and kh*kw*c_in of a Conv2d
weight ``[c_out, c_in, kh, kw]``; biases are zero. A family with other
parameters (embeddings, LayerNorm) initializes those itself through the
``special`` hook of :func:`default_init_params`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# Standard deviation of a unit normal truncated at +-2 sigma: flax's
# lecun_normal divides by it so the truncated draw has unit variance.
_TRUNC_STD = 0.87962566103423978


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias are all cast to
    ``dtype`` (so an f32 head computes in f32 from bf16 parameters too)."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill a Linear ``[out, in]`` or Conv ``[c_out, c_in, kh, kw]`` weight
    in place with flax's ``lecun_normal``."""
    fan_in = math.prod(t.shape[1:])
    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def default_init_params(module: nn.Module, generator: torch.Generator,
                        special: Optional[Callable[[str, torch.Tensor], bool]] = None,
                        ) -> Dict[str, torch.Tensor]:
    """Fresh f32 CPU parameters for ``module``, drawn from ``generator`` in
    ``named_parameters`` order: ``special(name, t)`` may fill ``t`` and
    return True; otherwise biases are zero and weights lecun-normal. The
    module itself (which may live on ``meta``) is left untouched."""
    out = {}
    for name, p in module.named_parameters():
        t = torch.empty(p.shape, dtype=torch.float32)
        if special is None or not special(name, t):
            if name.rsplit(".", 1)[-1] == "bias":
                nn.init.zeros_(t)
            else:
                lecun_normal_(t, generator)
        out[name] = t
    return out
