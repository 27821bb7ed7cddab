"""Pieces shared by every model family of the port: flax's default
initializers, a ``Dense`` with flax's dtype semantics, and XLA's SAME
padding for convolutions and pools.

A ``Dense`` or ``Conv`` kernel is lecun-normal (a normal truncated at +-2
sigma, rescaled to unit variance, times 1/sqrt(fan_in)), with fan-in = the
input width of a Linear weight ``[out, in]`` and kh*kw*c_in of a Conv2d
weight ``[c_out, c_in, kh, kw]``; biases are zero. A family with other
parameters (embeddings, LayerNorm) initializes those itself through the
``special`` hook of :func:`default_init_params`.

SAME padding is XLA's: the total pad ``max((ceil(n/s) - 1)*s + k - n, 0)``
goes ``total // 2`` before and the rest after, so a 3x3 stride-2 window
over an even input pads 0 before and 1 after on each spatial axis
(``padding=1`` in ``F.conv2d`` would pad 1 and 1, another function).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from olearning_sim_tpu_torch.parallel import collectives

# Standard deviation of a unit normal truncated at +-2 sigma: flax's
# lecun_normal divides by it so the truncated draw has unit variance.
_TRUNC_STD = 0.87962566103423978


# The floating types a family's ``dtype`` takes by name, as flax's modules
# take them: a task JSON's ``model.overrides`` can only carry a name.
DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def resolve_dtype(dtype) -> torch.dtype:
    """``dtype`` as a ``torch.dtype``: a ``torch.dtype`` as it is, or one of
    :data:`DTYPE_NAMES`; any other name raises ``ValueError``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype in DTYPE_NAMES:
        return DTYPE_NAMES[dtype]
    raise ValueError(f"dtype {dtype!r} is not a torch.dtype or one of {sorted(DTYPE_NAMES)}")


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias are all cast to
    ``dtype`` (so an f32 head computes in f32 from bf16 parameters too)."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def row_dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype, group) -> torch.Tensor:
    """A row-parallel :func:`dense`: ``lin`` holds this rank's input rows
    and ``x`` its columns; the partial products are summed over ``group``
    (Megatron's *g*) and the replicated bias is added once, after."""
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return collectives.reduce_from(y, group) + lin.bias.to(dtype)


def ffn(x: torch.Tensor, up: nn.Linear, down: nn.Linear, mlp_dim: int,
        dtype: torch.dtype, mp_group=None) -> torch.Tensor:
    """The blocks' FFN, ``down(gelu_tanh(up(x)))``. When ``up`` holds fewer
    than ``mlp_dim`` columns (its shard over ``mp_group``), the up
    projection runs column-parallel (``x``, replicated, enters through
    Megatron's *f*, so its gradient sums over the group) and the down
    projection row-parallel."""
    if mp_group is not None and up.weight.shape[0] != mlp_dim:
        y = dense(collectives.copy_to(x, mp_group), up, dtype)
        return row_dense(F.gelu(y, approximate="tanh"), down, dtype, mp_group)
    y = F.gelu(dense(x, up, dtype), approximate="tanh")
    return dense(y, down, dtype)


def same_pads(x: torch.Tensor, k: int, stride: int) -> list:
    """``F.pad``'s list (last axis first) of XLA's SAME padding for a
    ``k`` x ``k`` window at ``stride`` over the H and W axes of NCHW ``x``."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


def same_conv(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """flax ``Conv(padding="SAME", strides=stride, dtype=dtype)`` on NCHW
    ``x``, with or without a bias (``use_bias=False``: ``conv.bias`` is
    None)."""
    x = F.pad(x.to(dtype), same_pads(x, conv.weight.shape[-1], stride))
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x, conv.weight.to(dtype), bias, stride=stride)


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place with a normal of mean 0 and ``std`` truncated to
    ``[-2 std, 2 std]``, by the inverse CDF of one uniform draw per element.
    torch's own ``nn.init.trunc_normal_`` samples this way in some releases
    and by rejection in others, so one seed would give other parameters
    under another torch; this draw depends only on the generator's uniform
    stream."""
    cdf = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0  # P(Z < -2)
    with torch.no_grad():
        t.uniform_(2 * cdf - 1, 1 - 2 * cdf, generator=generator)
        t.erfinv_()
        t.mul_(std * math.sqrt(2.0))
        return t.clamp_(min=-2 * std, max=2 * std)


def lecun_normal_(t: torch.Tensor, generator: torch.Generator,
                  fan_in: Optional[int] = None) -> torch.Tensor:
    """Fill a Linear ``[out, in]`` or Conv ``[c_out, c_in, kh, kw]`` weight
    in place with flax's ``lecun_normal``; ``fan_in`` overrides the fan-in
    for other layouts."""
    fan_in = fan_in or math.prod(t.shape[1:])
    return trunc_normal_(t, 1.0 / math.sqrt(fan_in) / _TRUNC_STD, generator)


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


def flax_special(generator: torch.Generator) -> Callable[[str, torch.Tensor], bool]:
    """A ``special`` hook for :func:`default_init_params` with flax's other
    initializers: unit scales and zero biases of the ``norm.i`` layers
    (GroupNorm, LayerNorm), normal(0.02) ``pos_embedding`` and
    ``embed.weight``, a zero ``cls`` token."""

    def special(name, t):
        if name.startswith("norm.") or ".norm." in name:
            nn.init.constant_(t, 1.0 if name.endswith("weight") else 0.0)
        elif name in ("pos_embedding", "embed.weight"):
            nn.init.normal_(t, std=0.02, generator=generator)
        elif name == "cls":
            nn.init.zeros_(t)
        else:
            return False
        return True

    return special
