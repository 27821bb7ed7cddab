"""Flash-style masked self-attention: the port of the Pallas kernels
``_attn_kernel`` and ``_attn_stats_kernel`` in the JAX package's
``ops/flash_attention.py``.

:func:`flash_attention` and :func:`flash_attention_stats` take the JAX
entry points' signatures and layout (``[B, H, L, D]``). On CUDA tensors
they launch the hand-written Hopper kernel in ``csrc/flash_attention.cu``
(two entries, one wgmma + TMA kernel template over the input type), as
:func:`plan_launch` records; on CPU tensors they run the plain PyTorch
versions of the same arithmetic, :func:`flash_attention_reference` and
:func:`flash_attention_stats_reference`. There is no fall-back from one to
the other.

bf16 runs on the tensor cores in bf16 (128-key tiles, D zero-padded to a
multiple of 8 by :func:`pad_inputs`). f32 runs on them in split-precision
TF32 ("3xTF32", 64-key tiles, D padded to a multiple of 4): each operand x
is split into ``big = tf32(x)`` and ``small = tf32(x - big)``, and each
product is ``small*big + big*small + big*big`` in an f32 accumulator,
which keeps about 2^-22 of each product where one TF32 product keeps
2^-11 (the f32 tolerance of the checks is 1e-4). TF32 products take both
operands with the contracted dimension contiguous, so the kernel splits and
transposes each V tile in shared memory, with the keys of each 8-key group
permuted so that a thread's score registers are already its P operand
(the source's note has the layouts). The kernel's time is bound by bytes
for K1 at its path's shape and by operations for K2 at the long-context
shape, in both types.

:func:`flash_attention` is forward only, like its TPU kernel (``jax.grad``
through it fails): the wrapper refuses inputs that would need a gradient,
since a launch through ``ctypes`` would silently cut the autograd graph.
:func:`flash_attention_stats` is differentiable, as the JAX custom VJP is:
its ``torch.autograd.Function`` runs the kernel forward and recomputes the
backward through the plain version, pulling back the cotangents of all
three outputs.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = -1e30


def flash_attention_stats_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernels, written from
    ``_attn_stats_kernel``'s body and ``_reference_stats``: f32 scores and
    softmax, the additive ``(1 - mask) * NEG_INF`` bias, the max pinned to 0
    on rows with no real key, ``l`` summed from the unrounded f32
    probabilities, the probabilities rounded to v's dtype before the P.V
    product, and ``l`` floored at 1e-20 in the division (so rows with no
    real key come out ``(o, m, l) = (0, 0, 0)``). Differentiable.

    Returns ``o`` [B, H, Lq, D] in q's dtype and ``m``, ``l`` [B, H, Lq] f32."""
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
    return o.to(q.dtype), m[..., 0], l[..., 0]


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of ``_attn_kernel``: the ``o`` of
    :func:`flash_attention_stats_reference` (the two TPU kernels share
    their arithmetic). Returns ``[B, H, Lq, D]`` in q's dtype."""
    return flash_attention_stats_reference(q, k, v, kv_mask, scale)[0]


def _check(q, k, v, kv_mask, name):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
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
        raise ValueError(f"{name} needs non-empty q, k, v")
    if kv_mask is not None and tuple(kv_mask.shape) != (B, Lk):
        raise ValueError(
            f"kv_mask must be [B, Lk] = {(B, Lk)}, got {tuple(kv_mask.shape)}"
        )
    for name, t in (("k", k), ("v", v), ("kv_mask", kv_mask)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


# Keys per K/V tile of the kernel in bf16 and in f32 (at head dim 64; 32 at
# 128): its mask rows are padded to a multiple.
KV_TILE = 128
KV_TILE_F32 = 64


class LaunchPlan(NamedTuple):
    """How :func:`_launch` hands a call to ``csrc/flash_attention.cu``."""

    design: str     # the kernel instance: "wgmma+tma" (bf16) or "wgmma+tma+3xtf32" (f32)
    d_pad: int      # head dim the kernel sees: D zero-padded to 16-byte TMA rows
    mask_cols: int  # row length of the f32 mask the kernel reads (zeros past Lk)


def plan_launch(dtype: torch.dtype, D: int, Lk: int) -> LaunchPlan:
    """The kernel instance and padding for a call, as the C entries choose
    them. Both types take the wgmma + TMA kernel, whose TMA rows must be a
    multiple of 16 bytes (bf16 D padded to a multiple of 8, f32 D to a
    multiple of 4) and whose mask is read in whole key tiles (128 keys in
    bf16, 64 in f32); f32 multiplies in split-precision TF32."""
    if D > 128:
        raise ValueError(f"the CUDA kernel takes head dims up to 128, got {D}")
    if dtype == torch.bfloat16:
        return LaunchPlan("wgmma+tma", -(-D // 8) * 8, -(-Lk // KV_TILE) * KV_TILE)
    return LaunchPlan("wgmma+tma+3xtf32", -(-D // 4) * 4, -(-Lk // KV_TILE_F32) * KV_TILE_F32)


def pad_inputs(q, k, v, kv_mask, plan: LaunchPlan):
    """``(q, k, v, mask)`` as the kernel takes them: q, k, v with D
    zero-padded to ``plan.d_pad`` (zero columns add nothing to q k^T) on
    16-byte aligned storage, and the f32 mask ``[B, plan.mask_cols]``, 0
    past Lk. The caller keeps the scale of the unpadded D and slices o."""
    B, _, _, D = q.shape
    Lk = k.shape[2]

    def prep(t):
        if plan.d_pad != D:
            t = torch.nn.functional.pad(t, (0, plan.d_pad - D))
        return t if t.data_ptr() % 16 == 0 else t.clone()

    mask = torch.zeros((B, plan.mask_cols), dtype=torch.float32, device=q.device)
    mask[:, :Lk] = 1.0 if kv_mask is None else kv_mask.to(torch.float32)
    return prep(q), prep(k), prep(v), mask


def _launch(q, k, v, kv_mask, scale, stats):
    """Launch the CUDA kernel on contiguous CUDA tensors; returns ``o``, or
    ``(o, m, l)`` when ``stats``. Counts nothing: the callers do."""
    from olearning_sim_tpu_torch.ops import _build

    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    plan = plan_launch(q.dtype, D, Lk)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    qp, kp, vp, mask = pad_inputs(q, k, v, kv_mask, plan)
    lib = _build.load("flash_attention.cu")
    c_ptr, c_int = ctypes.c_void_p, ctypes.c_int
    o = torch.empty_like(qp)
    ptrs = [qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), mask.data_ptr(), o.data_ptr()]
    if stats:
        m = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        ptrs += [m.data_ptr(), l.data_ptr()]
        fn = lib.flash_attention_stats_fwd
    else:
        fn = lib.flash_attention_fwd
    fn.argtypes = [c_ptr] * len(ptrs) + [c_int] * 6 + [ctypes.c_float, c_int, c_ptr]
    fn.restype = c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(*ptrs, B, H, Lq, Lk, plan.d_pad, plan.mask_cols, float(scale),
             int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} CUDA launch failed: cudaError {err}")
    if plan.d_pad != D:
        o = o[..., :D].contiguous()
    return (o, m, l) if stats else o


def _device_of(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    return q.device.type


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
    the CUDA kernel's launches (CPU calls do not count);
    ``flash_attention.calls`` counts every call, on either device."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward-only (as is the TPU kernel it ports): "
            "call it under torch.no_grad() or on tensors that do not require grad"
        )
    _check(q, k, v, kv_mask, "flash_attention")
    flash_attention.calls += 1
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _device_of(q) == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, scale)
    o = _launch(q, k, v, kv_mask, scale, stats=False)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
flash_attention.calls = 0


class _FlashStats(torch.autograd.Function):
    """``_stats_vjp`` of the JAX package: the forward is the kernel (the
    plain version on CPU tensors); the backward recomputes ``(o, m, l)``
    through :func:`flash_attention_stats_reference` and pulls all three
    cotangents back through it (``_stats_bwd``), since the ring merge
    consumes ``m`` and ``l`` arithmetically. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.scale = scale
        if _device_of(q) == "cpu":
            o, m, l = flash_attention_stats_reference(q, k, v, kv_mask, scale)
        else:
            o, m, l = _launch(q, k, v, kv_mask, scale, stats=True)
            flash_attention_stats.launches += 1
        return o, m, l

    @staticmethod
    def backward(ctx, do, dm, dl):
        q, k, v, kv_mask = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            outs = flash_attention_stats_reference(*inputs, kv_mask, ctx.scale)
        dq, dk, dv = torch.autograd.grad(outs, inputs, (do, dm, dl))
        return dq, dk, dv, None, None


def flash_attention_stats(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` plus per-row softmax stats.

    Args as :func:`flash_attention`. Returns ``(o, m, l)``: o [B, H, Lq, D]
    in q's dtype, m and l [B, H, Lq] f32, the row max and normaliser of
    this block's softmax, so that a caller merging several K/V blocks (ring
    attention's per-step combine) can fold this block in exactly:
    ``acc_blk = o * l``. Rows with no real key give ``(0, 0, 0)``.

    Differentiable in q, k and v (see :class:`_FlashStats`).
    ``flash_attention_stats.launches`` counts the CUDA kernel's launches
    (CPU calls do not count)."""
    _check(q, k, v, kv_mask, "flash_attention_stats")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if kv_mask is None:
        kv_mask = torch.ones((q.shape[0], k.shape[2]), dtype=torch.float32,
                             device=q.device)
    return _FlashStats.apply(q, k, v, kv_mask.to(torch.float32), float(scale))


flash_attention_stats.launches = 0
