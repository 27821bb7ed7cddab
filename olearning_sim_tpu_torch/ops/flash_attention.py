"""Flash-style masked self-attention: the port of the Pallas kernel
``_attn_kernel`` in the JAX package's ``ops/flash_attention.py``.

:func:`flash_attention` takes the JAX entry point's signature and layout
(``[B, H, L, D]``). On CUDA tensors it launches the hand-written Hopper
kernel in ``csrc/flash_attention.cu``; on CPU tensors it runs
:func:`flash_attention_reference`, the plain PyTorch version of the same
arithmetic. There is no fall-back from one to the other.

Forward only, like the TPU kernel (``jax.grad`` through it fails): the
wrapper refuses inputs that would need a gradient, since a launch through
``ctypes`` would silently cut the autograd graph.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, written from ``_attn_kernel``'s
    body: f32 scores and softmax, the additive ``(1 - mask) * NEG_INF``
    bias, the max pinned to 0 on rows with no real key, probabilities
    rounded to v's dtype before the P.V product, and ``l`` floored at 1e-20
    (so such rows come out 0). Returns ``[B, H, Lq, D]`` in q's dtype."""
    B, _, _, D = q.shape
    Lk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if kv_mask is None:
        kv_mask = torch.ones((B, Lk), dtype=torch.float32, device=q.device)
    bias = (1.0 - kv_mask.to(torch.float32)) * NEG_INF
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    o = o / torch.clamp(l, min=1e-20)
    return o.to(q.dtype)


def _check(q, k, v, kv_mask):
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v) if t is not None
    ):
        raise RuntimeError(
            "flash_attention is forward-only (as is the TPU kernel it ports): "
            "call it under torch.no_grad() or on tensors that do not require grad"
        )
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, L, D]")
    B, H, Lq, D = q.shape
    Bk, Hk, Lk, Dk = k.shape
    if (Bk, Hk, Dk) != (B, H, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if min(B, H, Lq, Lk, D) < 1:
        raise ValueError("flash_attention needs non-empty q, k, v")
    if kv_mask is not None and tuple(kv_mask.shape) != (B, Lk):
        raise ValueError(
            f"kv_mask must be [B, Lk] = {(B, Lk)}, got {tuple(kv_mask.shape)}"
        )
    for name, t in (("k", k), ("v", v), ("kv_mask", kv_mask)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _launch(q, k, v, kv_mask, scale):
    from olearning_sim_tpu_torch.ops import _build

    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if D > 128:
        raise ValueError(f"the CUDA kernel takes head dims up to 128, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kv_mask is None:
        mask = torch.ones((B, Lk), dtype=torch.float32, device=q.device)
    else:
        mask = kv_mask.to(torch.float32).contiguous()
    lib = _build.load("flash_attention.cu")
    fn = lib.flash_attention_fwd
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ctypes.c_float, ci, vp]
    fn.restype = ci
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
             o.data_ptr(), B, H, Lq, Lk, D, float(scale),
             int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention CUDA launch failed: cudaError {err}")
    flash_attention.launches += 1
    return o


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Self-attention ``softmax(q k^T * scale) v`` without a score tensor in
    device memory.

    Args:
      q: [B, H, Lq, D]; k, v: [B, H, Lk, D]; float32 or bfloat16, one dtype.
      kv_mask: [B, Lk] bool or 0/1, True = real key; None = all real.
      scale: default 1/sqrt(D).

    Returns [B, H, Lq, D] in q's dtype. ``flash_attention.launches`` counts
    the CUDA kernel's launches (CPU calls do not count)."""
    _check(q, k, v, kv_mask)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    return _launch(q, k, v, kv_mask, scale)


flash_attention.launches = 0
