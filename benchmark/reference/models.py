"""Plain PyTorch forward passes of the two architectures, over a dict of
float32 parameters, written from their published descriptions.

DistilBERT (Sanh et al., arXiv:1910.01108; distilbert-base-uncased's
``config.json``): token embedding plus learned position embedding, a
LayerNorm, then ``n_layers`` post-LN encoder blocks (multi-head
self-attention with separate query/key/value/output projections, the
query scaled by 1/sqrt(head size), keys of padding id 0 masked out;
residual and LayerNorm; a GELU feed-forward of ``hidden_dim``; residual
and LayerNorm), then a classifier over the mean of the real tokens.

ResNet-18 (He et al., arXiv:1512.03385) as the FEMNIST task states it: a
3x3 stride-1 stem of 64 channels (no max-pool, the inputs are 28x28),
four stages of two basic blocks of widths 64-128-256-512 (the first block
of stages 2-4 strides 2 and projects its shortcut with a 1x1 convolution),
GroupNorm of 8 groups after every convolution in place of BatchNorm
(federated clients hold too few rows for batch statistics), global average
pooling and a linear head.

Departures, each one the task's and not the papers':

- LayerNorm and GroupNorm take epsilon 1e-6 (flax's default), GELU is
  the tanh approximation;
- there is no dropout: the task trains without it;
- convolutions pad TensorFlow's "SAME" way (the total pad ``max((ceil(n /
  s) - 1) s + k - n, 0)``, its smaller half before), so a stride-2 3x3
  convolution over 28 pads (0, 1), and have no bias;
- a padded query row is excluded from the mean-pool, so only keys are
  masked here (the data hold no padding ids either way).

Parameter names are the layout the program's weights take (``blocks.i.
query.weight`` ``[out, in]``, ``conv.0.weight`` ``[c_out, c_in, kh,
kw]``), so one dict of tensors made by the benchmark feeds both sides.

``precision`` selects the arithmetic of every matrix product and
convolution: ``"f32"`` (the reference: float32 with TF32 off, which the
caller sets) or ``"fp8"`` (the control: both operands rounded to
float8 e4m3 with a per-tensor scale, the product taken in float32; the
rounding is a straight-through estimator, so gradients flow as in
``"f32"``). Normalisation, softmax and the loss stay float32 in both.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
NORM_EPS = 1e-6
FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to e4m3's largest, returned in float32; the gradient
    passes through unchanged."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def _ops(precision: str):
    if precision == "f32":
        return lambda t: t
    if precision == "fp8":
        return fp8_round
    raise ValueError(f"unknown precision {precision!r}")


# ------------------------------------------------------------------ DistilBERT
def distilbert_spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every parameter; ``init`` is ``"normal02"``
    (embeddings, std 0.02), ``"fan_in"`` (std 1/sqrt(fan-in)), ``"one"`` or
    ``"zero"``."""
    W, F_, V, L, C = cfg["dim"], cfg["hidden_dim"], cfg["vocab_size"], cfg["max_len"], cfg[
        "num_classes"]
    out = [("embed.weight", (V, W), "normal02"), ("pos_embedding", (1, L, W), "normal02"),
           ("ln_emb.weight", (W,), "one"), ("ln_emb.bias", (W,), "zero")]
    for i in range(cfg["n_layers"]):
        b = f"blocks.{i}."
        for lin in ("query", "key", "value", "out"):
            out += [(b + lin + ".weight", (W, W), "fan_in"), (b + lin + ".bias", (W,), "zero")]
        out += [(b + "ln_1.weight", (W,), "one"), (b + "ln_1.bias", (W,), "zero"),
                (b + "mlp_in.weight", (F_, W), "fan_in"), (b + "mlp_in.bias", (F_,), "zero"),
                (b + "mlp_out.weight", (W, F_), "fan_in"), (b + "mlp_out.bias", (W,), "zero"),
                (b + "ln_2.weight", (W,), "one"), (b + "ln_2.bias", (W,), "zero")]
    out += [("head.weight", (C, W), "fan_in"), ("head.bias", (C,), "zero")]
    return out


def distilbert_logits(p: Params, tokens: torch.Tensor, cfg: dict,
                      precision: str = "f32") -> torch.Tensor:
    """``tokens [B, L]`` int -> logits ``[B, classes]``."""
    q8 = _ops(precision)
    W, H = cfg["dim"], cfg["n_heads"]
    D = W // H
    B, L = tokens.shape
    real = tokens != 0

    def lin(x, name):
        return F.linear(q8(x), q8(p[name + ".weight"]), p[name + ".bias"])

    def ln(x, name):
        return F.layer_norm(x, (W,), p[name + ".weight"], p[name + ".bias"], NORM_EPS)

    x = p["embed.weight"][tokens] + p["pos_embedding"][0, :L]
    x = ln(x, "ln_emb")
    key_mask = real[:, None, None, :]
    for i in range(cfg["n_layers"]):
        b = f"blocks.{i}."
        q = lin(x, b + "query").view(B, L, H, D).transpose(1, 2) / math.sqrt(D)
        k = lin(x, b + "key").view(B, L, H, D).transpose(1, 2)
        v = lin(x, b + "value").view(B, L, H, D).transpose(1, 2)
        s = torch.matmul(q8(q), q8(k).transpose(-1, -2))
        s = s.masked_fill(~key_mask, float("-inf"))
        a = torch.matmul(q8(torch.softmax(s, dim=-1)), q8(v))
        a = a.transpose(1, 2).reshape(B, L, W)
        x = ln(x + lin(a, b + "out"), b + "ln_1")
        h = F.gelu(lin(x, b + "mlp_in"), approximate="tanh")
        x = ln(x + lin(h, b + "mlp_out"), b + "ln_2")
    m = real[..., None].float()
    pooled = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
    return F.linear(pooled, p["head.weight"], p["head.bias"])


# -------------------------------------------------------------------- ResNet-18
def _blocks(cfg: dict):
    """``(prefix, c_in, c_out, stride, projects)`` of each basic block, for
    28x28 inputs."""
    out, c_in, hw, i = [], cfg["stage_widths"][0], cfg["image_size"], 0
    for stage, width in enumerate(cfg["stage_widths"]):
        for j in range(cfg["blocks_per_stage"]):
            stride = 2 if stage > 0 and j == 0 else 1
            out_hw = -(-hw // stride)
            out.append((f"blocks.{i}.", c_in, width, stride, (out_hw, width) != (hw, c_in)))
            c_in, hw, i = width, out_hw, i + 1
    return out


def resnet_spec(cfg: dict) -> List[Tuple[str, tuple, str]]:
    stem, C = cfg["stage_widths"][0], cfg["num_classes"]
    out = [("conv.0.weight", (stem, cfg["channels"], 3, 3), "fan_in"),
           ("norm.0.weight", (stem,), "one"), ("norm.0.bias", (stem,), "zero")]
    for b, c_in, c_out, _, proj in _blocks(cfg):
        convs = [(c_out, c_in, 3, 3), (c_out, c_out, 3, 3)] + ([(c_out, c_in, 1, 1)] if proj else [])
        for j, shape in enumerate(convs):
            out += [(f"{b}conv.{j}.weight", shape, "fan_in"),
                    (f"{b}norm.{j}.weight", (c_out,), "one"),
                    (f"{b}norm.{j}.bias", (c_out,), "zero")]
    out += [("dense.0.weight", (C, cfg["stage_widths"][-1]), "fan_in"),
            ("dense.0.bias", (C,), "zero")]
    return out


def _same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def resnet_logits(p: Params, images: torch.Tensor, cfg: dict,
                  precision: str = "f32") -> torch.Tensor:
    """``images [N, H, W, C]`` -> logits ``[N, classes]``."""
    q8 = _ops(precision)
    groups = cfg["groups"]

    def conv(x, name, stride):
        w = p[name]
        return F.conv2d(q8(_same(x, w.shape[-1], stride)), q8(w), stride=stride)

    def gn(x, name):
        return F.group_norm(x, min(groups, x.shape[1]), p[name + ".weight"], p[name + ".bias"],
                            NORM_EPS)

    x = images.float().permute(0, 3, 1, 2)
    x = F.relu(gn(conv(x, "conv.0.weight", 1), "norm.0"))
    for b, _, _, stride, proj in _blocks(cfg):
        y = F.relu(gn(conv(x, b + "conv.0.weight", stride), b + "norm.0"))
        y = gn(conv(y, b + "conv.1.weight", 1), b + "norm.1")
        r = gn(conv(x, b + "conv.2.weight", stride), b + "norm.2") if proj else x
        x = F.relu(y + r)
    return F.linear(x.mean(dim=(2, 3)), p["dense.0.weight"], p["dense.0.bias"])


ARCHITECTURES = {
    "distilbert": (distilbert_spec, distilbert_logits),
    "resnet18": (resnet_spec, resnet_logits),
}
