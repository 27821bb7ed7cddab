"""Carry parameters between the JAX package's flax trees and the port.

:func:`params_from_jax` takes a flax parameter tree as nested dicts of
numpy arrays (for example ``jax.tree.map(np.asarray, state.params)``) and
returns the port's parameter dict (``state_dict`` names, f32 CPU tensors);
:func:`params_to_jax` is its inverse. Both dispatch on the tree:

- a ``TextTransformer`` (either attention layout);
- every other family is a tree of numbered flax modules (``mlp2``,
  ``cnn4``, ``cnn4_pool``; ``resnet18``'s ``ResidualBlock_i``,
  ``vit_tiny``'s ``EncoderBlock_i``, ``moe_text``'s ``MoEBlock_i``), whose
  ``Conv_i`` / ``Dense_i`` / ``GroupNorm_i`` or ``LayerNorm_i`` /
  ``<Block>_i`` the port names ``conv.i`` / ``dense.i`` / ``norm.i`` /
  ``blocks.i``, at every level; a block's attention becomes its
  ``query``/``key``/``value``/``out`` Linears, a ``SwitchFFN_0`` its
  ``switch`` (``gate`` a Linear, the expert tensors as they are), and
  ``Embed_0`` ``embed``; raw leaves (``cls``, ``pos_embedding``) keep
  their names.

Every conversion is a reshape or transpose, so the round trip is exact.

:func:`stack_block_params` / :func:`unstack_block_params` convert a
block-structured model's per-block names (``blocks.i.<leaf>``) to one
``[depth, ...]`` tensor per leaf and back, exactly: the layout whose depth
axis the pipeline splits over its stages.

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
# Numbered-block families: the block's flax name -> its normalization's.
_BLOCK_NORM = {"ResidualBlock": "GroupNorm", "EncoderBlock": "LayerNorm",
               "MoEBlock": "LayerNorm"}
# flax module kind -> the port's ModuleList of them.
_PORT_LIST = {"Conv": "conv", "Dense": "dense", "GroupNorm": "norm", "LayerNorm": "norm",
              **{block: "blocks" for block in _BLOCK_NORM}}
_QKV = ("query", "key", "value")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _n(t: torch.Tensor) -> np.ndarray:
    """A host f32 copy in C order. Layout changes are made before, in torch,
    so that a tensor on the card is transposed there."""
    return t.detach().contiguous().to("cpu", torch.float32).numpy().copy()


def _linear_from(kernel, bias, n_in_axes: int = 1) -> Dict[str, torch.Tensor]:
    """flax kernel with ``n_in_axes`` leading input axes -> Linear weight."""
    k = np.asarray(kernel)
    n_in = int(np.prod(k.shape[:n_in_axes]))
    return {"weight": _t(k.reshape(n_in, -1).T),
            "bias": _t(np.asarray(bias).reshape(-1))}


def _norm_from(p) -> Dict[str, torch.Tensor]:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _numbered_from(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """A numbered family's flax tree (or a sub-tree of it) into ``out``
    under ``prefix``."""
    for name, p in tree.items():
        if not isinstance(p, dict):
            out[prefix + name] = _t(p)
        elif name == _MHA:
            for q in _QKV:
                _put(out, prefix + q, _linear_from(p[q]["kernel"], p[q]["bias"]))
            _put(out, prefix + "out", _linear_from(p["out"]["kernel"], p["out"]["bias"], 2))
        elif name == "SwitchFFN_0":
            _numbered_from(p, prefix + "switch.", out)
        elif name == "gate":
            _put(out, prefix + "gate", _linear_from(p["kernel"], p["bias"]))
        elif name == "Embed_0":
            out[prefix + "embed.weight"] = _t(p["embedding"])
        else:
            kind, i = name.rsplit("_", 1)
            pre = f"{prefix}{_PORT_LIST[kind]}.{i}"
            if kind in _BLOCK_NORM:
                _numbered_from(p, pre + ".", out)
            elif kind == "Conv":
                out[pre + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
                if "bias" in p:
                    out[pre + ".bias"] = _t(p["bias"])
            elif kind == "Dense":
                _put(out, pre, _linear_from(p["kernel"], p["bias"]))
            else:
                _put(out, pre, _norm_from(p))


def _put(out, prefix, sub) -> None:
    for k, v in sub.items():
        out[f"{prefix}.{k}"] = v


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """flax params (numpy leaves) -> port param dict."""
    out: Dict[str, torch.Tensor] = {}
    if "TransformerBlock_0" not in tree:
        _numbered_from(tree, "", out)
        return out

    def put(prefix, sub):
        _put(out, prefix, sub)

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


def _lin_to(lin, in_shape, out_shape):
    """A Linear's ``{"weight", "bias"}`` -> a flax kernel ``in_shape +
    out_shape`` and bias ``out_shape``."""
    w = _n(lin["weight"].t())
    return {"kernel": w.reshape(tuple(in_shape) + tuple(out_shape)),
            "bias": _n(lin["bias"]).reshape(out_shape)}


def _linear_to(params, prefix, in_shape, out_shape):
    return _lin_to({"weight": params[f"{prefix}.weight"], "bias": params[f"{prefix}.bias"]},
                   in_shape, out_shape)


def _norm_to(params, prefix):
    return {"scale": _n(params[f"{prefix}.weight"]),
            "bias": _n(params[f"{prefix}.bias"])}


def _nest(params) -> dict:
    """``{"a.0.b": t}`` -> ``{"a": {"0": {"b": t}}}``."""
    root: dict = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return root


def _numbered_to(node: dict, block: Optional[str], heads: Optional[int]) -> dict:
    """A numbered family's nested params (or a block of them) -> its flax
    tree; ``block`` is the family's block name (None: layers only)."""
    kinds = {"conv": "Conv", "dense": "Dense", "norm": _BLOCK_NORM.get(block), "blocks": block}
    tree: dict = {}
    if "query" in node:
        W = node["query"]["weight"].shape[1]
        mha = {q: _lin_to(node[q], (W,), (heads, W // heads)) for q in _QKV}
        mha["out"] = _lin_to(node["out"], (heads, W // heads), (W,))
        tree[_MHA] = mha
    for name, sub in node.items():
        if name in _QKV + ("out",):
            continue
        if isinstance(sub, torch.Tensor):
            tree[name] = _n(sub)
        elif name == "embed":
            tree["Embed_0"] = {"embedding": _n(sub["weight"])}
        elif name == "switch":
            tree["SwitchFFN_0"] = _numbered_to(sub, block, heads)
        elif name == "gate":
            tree["gate"] = _lin_to(sub, sub["weight"].shape[1:], sub["weight"].shape[:1])
        else:
            for i, layer in sub.items():
                key = f"{kinds[name]}_{i}"
                if name == "blocks":
                    tree[key] = _numbered_to(layer, block, heads)
                elif name == "conv":
                    tree[key] = {"kernel": _n(layer["weight"].permute(2, 3, 1, 0))}
                    if "bias" in layer:
                        tree[key]["bias"] = _n(layer["bias"])
                elif name == "dense":
                    w = layer["weight"]
                    tree[key] = _lin_to(layer, w.shape[1:], w.shape[:1])
                else:
                    tree[key] = {"scale": _n(layer["weight"]), "bias": _n(layer["bias"])}
    return tree


# A parameter that only one numbered family with blocks has -> its block.
_FAMILY_MARK = {"blocks.0.switch.gate.weight": "MoEBlock", "cls": "EncoderBlock",
                "blocks.0.conv.0.weight": "ResidualBlock"}


def params_to_jax(params: Dict[str, torch.Tensor], heads: Optional[int] = None) -> dict:
    """Port param dict -> flax tree of numpy arrays. For a family with
    attention (``TextTransformer``, ``vit_tiny``, ``moe_text``), ``heads``
    fixes the head split of the attention kernels, which the port's ``[out,
    in]`` weights do not record."""
    if "ln_emb.weight" not in params:
        block = next((b for mark, b in _FAMILY_MARK.items() if mark in params), None)
        if heads is None and block in ("EncoderBlock", "MoEBlock"):
            raise ValueError(f"params_to_jax needs heads= for a tree of {block}s")
        return _numbered_to(_nest(params), block, heads)
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


def stack_block_params(params: Dict[str, torch.Tensor]):
    """Split a block-structured model's params into ``(rest, stacked)``:
    ``stacked[leaf]`` is ``[depth, ...]``, block ``i``'s
    ``blocks.i.<leaf>`` at index ``i``; ``rest`` holds every other name."""
    blocks: Dict[int, Dict[str, torch.Tensor]] = {}
    rest = {}
    for name, t in params.items():
        parts = name.split(".", 2)
        if parts[0] == "blocks" and len(parts) == 3 and parts[1].isdigit():
            blocks.setdefault(int(parts[1]), {})[parts[2]] = t
        else:
            rest[name] = t
    if not blocks:
        raise ValueError("no blocks.i entries in params")
    depth = len(blocks)
    if sorted(blocks) != list(range(depth)):
        raise ValueError(f"block indices {sorted(blocks)} are not 0..{depth - 1}")
    leaves = list(blocks[0])
    stacked = {leaf: torch.stack([blocks[i][leaf] for i in range(depth)]) for leaf in leaves}
    return rest, stacked


def unstack_block_params(rest: Dict[str, torch.Tensor],
                         stacked: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`stack_block_params`."""
    out = dict(rest)
    depth = next(iter(stacked.values())).shape[0]
    for i in range(depth):
        for leaf, t in stacked.items():
            out[f"blocks.{i}.{leaf}"] = t[i]
    return out
