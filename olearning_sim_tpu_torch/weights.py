"""Carry parameters between the JAX package's flax trees and the port.

:func:`params_from_jax` takes a flax parameter tree as nested dicts of
numpy arrays (for example ``jax.tree.map(np.asarray, state.params)``) and
returns the port's parameter dict (``state_dict`` names, f32 CPU tensors);
:func:`params_to_jax` is its inverse. Both dispatch on the tree: a
``TextTransformer`` (either attention layout), or a stack of ``Conv_i`` /
``Dense_j`` layers (``mlp2``, ``cnn4``, ``cnn4_pool``), which the port
names ``conv.i`` / ``dense.j``. Every conversion is a reshape or transpose,
so the round trip is exact.

Layouts: a flax ``Dense`` kernel is ``[in, out]`` and a torch ``Linear``
weight ``[out, in]``; a flax ``Conv`` kernel is ``[kh, kw, c_in, c_out]``
and a torch ``Conv2d`` weight ``[c_out, c_in, kh, kw]``. The dense
attention's ``DenseGeneral`` kernels are ``query/key/value: [W, H, D]``
and ``out: [H, D, W]``; the flash branch's fused ``qkv`` kernel is
``[W, 3, H, D]``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_MHA = "MultiHeadDotProductAttention_0"
# flax sub-module name -> port module name, inside a TransformerBlock.
_BLOCK_DENSE = {"LayerNorm_0": "ln_1", "Dense_0": "mlp_in",
                "Dense_1": "mlp_out", "LayerNorm_1": "ln_2"}
_TOP = {"LayerNorm_0": "ln_emb", "Dense_0": "head"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _linear_from(kernel, bias, n_in_axes: int = 1) -> Dict[str, torch.Tensor]:
    """flax kernel with ``n_in_axes`` leading input axes -> Linear weight."""
    k = np.asarray(kernel)
    n_in = int(np.prod(k.shape[:n_in_axes]))
    return {"weight": _t(k.reshape(n_in, -1).T),
            "bias": _t(np.asarray(bias).reshape(-1))}


def _norm_from(p) -> Dict[str, torch.Tensor]:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _layers_from(tree) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, p in tree.items():
        kind, i = name.split("_")
        k = np.asarray(p["kernel"])
        w = k.transpose(3, 2, 0, 1) if kind == "Conv" else k.T
        out[f"{kind.lower()}.{i}.weight"] = _t(w)
        out[f"{kind.lower()}.{i}.bias"] = _t(p["bias"])
    return out


def _layers_to(params) -> dict:
    tree = {}
    for name in params:
        kind, i, leaf = name.split(".")
        if leaf == "weight":
            w = _n(params[name])
            tree[f"{kind.capitalize()}_{i}"] = {
                "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0) if kind == "conv" else w.T),
                "bias": _n(params[f"{kind}.{i}.bias"]),
            }
    return tree


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax params (numpy leaves) -> port param dict."""
    if "Embed_0" not in tree:
        return _layers_from(tree)
    out: Dict[str, torch.Tensor] = {}

    def put(prefix, sub):
        for k, v in sub.items():
            out[f"{prefix}.{k}"] = v

    out["embed.weight"] = _t(tree["Embed_0"]["embedding"])
    out["pos_embedding"] = _t(tree["pos_embedding"])
    put("ln_emb", _norm_from(tree["LayerNorm_0"]))
    put("head", _linear_from(tree["Dense_0"]["kernel"], tree["Dense_0"]["bias"]))
    depth = sum(1 for k in tree if k.startswith("TransformerBlock_"))
    for i in range(depth):
        blk = tree[f"TransformerBlock_{i}"]
        pre = f"blocks.{i}"
        if "qkv" in blk:
            put(f"{pre}.qkv", _linear_from(blk["qkv"]["kernel"], blk["qkv"]["bias"]))
            put(f"{pre}.attn_out",
                _linear_from(blk["attn_out"]["kernel"], blk["attn_out"]["bias"]))
        else:
            mha = blk[_MHA]
            for name in ("query", "key", "value"):
                put(f"{pre}.{name}", _linear_from(mha[name]["kernel"], mha[name]["bias"]))
            put(f"{pre}.out", _linear_from(mha["out"]["kernel"], mha["out"]["bias"], 2))
        for flax_name, port_name in _BLOCK_DENSE.items():
            p = blk[flax_name]
            if flax_name.startswith("LayerNorm"):
                put(f"{pre}.{port_name}", _norm_from(p))
            else:
                put(f"{pre}.{port_name}", _linear_from(p["kernel"], p["bias"]))
    return out


def _linear_to(params, prefix, in_shape, out_shape):
    w = _n(params[f"{prefix}.weight"])
    return {"kernel": w.T.reshape(tuple(in_shape) + tuple(out_shape)),
            "bias": _n(params[f"{prefix}.bias"]).reshape(out_shape)}


def _norm_to(params, prefix):
    return {"scale": _n(params[f"{prefix}.weight"]),
            "bias": _n(params[f"{prefix}.bias"])}


def params_to_jax(params: Dict[str, torch.Tensor], heads: Optional[int] = None) -> dict:
    """Port param dict -> flax tree of numpy arrays. For a
    ``TextTransformer``, ``heads`` fixes the head split of the attention
    kernels, which the port's ``[out, in]`` weights do not record."""
    if "embed.weight" not in params:
        return _layers_to(params)
    if heads is None:
        raise ValueError("params_to_jax needs heads= for a TextTransformer")
    W = params["embed.weight"].shape[1]
    D = W // heads
    tree = {
        "Embed_0": {"embedding": _n(params["embed.weight"])},
        "pos_embedding": _n(params["pos_embedding"]),
        "LayerNorm_0": _norm_to(params, "ln_emb"),
        "Dense_0": _linear_to(params, "head", (W,),
                              tuple(params["head.weight"].shape[:1])),
    }
    depth = len({k.split(".")[1] for k in params if k.startswith("blocks.")})
    for i in range(depth):
        pre = f"blocks.{i}"
        blk = {}
        if f"{pre}.qkv.weight" in params:
            blk["qkv"] = _linear_to(params, f"{pre}.qkv", (W,), (3, heads, D))
            blk["attn_out"] = _linear_to(params, f"{pre}.attn_out", (W,), (W,))
        else:
            mha = {name: _linear_to(params, f"{pre}.{name}", (W,), (heads, D))
                   for name in ("query", "key", "value")}
            mha["out"] = _linear_to(params, f"{pre}.out", (heads, D), (W,))
            blk[_MHA] = mha
        for flax_name, port_name in _BLOCK_DENSE.items():
            if flax_name.startswith("LayerNorm"):
                blk[flax_name] = _norm_to(params, f"{pre}.{port_name}")
            else:
                w = params[f"{pre}.{port_name}.weight"]
                blk[flax_name] = _linear_to(params, f"{pre}.{port_name}",
                                            (w.shape[1],), (w.shape[0],))
        tree[f"TransformerBlock_{i}"] = blk
    return tree
