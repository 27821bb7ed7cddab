"""Ring attention: sequence-parallel self-attention over a process group.

The port of the JAX package's ``parallel/ring_attention.py``. The sequence
axis is split over the ranks of an ``sp`` group: each rank holds a
``[B, H, L/P, D]`` chunk of q/k/v. P ring steps fold every K/V chunk into
each rank's running online softmax ``(m, l, acc)``; between steps the K/V
chunks (and their padding masks) move one rank on around the ring with
``dist.batch_isend_irecv``, so the full ``[L, L]`` score matrix exists
nowhere and per-rank memory is O(L/P).

Each step's local attention is either plain torch ops (:func:`combine_dense`,
the default) or the stats kernel (:func:`combine_flash`,
``use_flash=True``; trainable through its ``torch.autograd.Function``).
Both are ported term for term from the JAX package, including the
``NEG_INF / 2`` pins that keep rows with no real key so far at 0.

``group=None`` is a ring of one: one step, no communication. That is how
the path runs on a single GPU.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from olearning_sim_tpu_torch.ops import flash_attention_stats
from olearning_sim_tpu_torch.parallel import collectives

NEG_INF = -1e30


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _shift(tensors: Sequence[torch.Tensor], group, step: int):
    """Send each tensor to the rank ``step`` places on in ``group`` and
    receive the same shapes from the rank ``step`` places back, in one
    batch of point-to-point ops."""
    p, r = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % p)
    src = dist.get_global_rank(group, (r - step) % p)
    # On the backend's device: gloo moves the chunks through the host.
    dev = collectives.comm_device(group, tensors[0])
    sent = [t.contiguous().to(dev) for t in tensors]
    outs = [torch.empty_like(t) for t in sent]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in sent]
    ops += [dist.P2POp(dist.irecv, o, src, group) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [o.to(t.device) for o, t in zip(outs, tensors)]


class _RingRotate(torch.autograd.Function):
    """``ppermute`` of K, V and the mask one hop on around the ring (rank i
    to rank i+1). Its transpose sends the gradients of K and V one hop back
    (rank i to rank i-1), so each chunk's gradient reaches its owner; the
    mask has none. ``torch.distributed``'s send and receive are not
    differentiable, hence this Function."""

    @staticmethod
    def forward(ctx, group, k, v, mask):
        ctx.group = group
        k_nxt, v_nxt, mask_nxt = _shift((k, v, mask), group, 1)
        ctx.mark_non_differentiable(mask_nxt)
        return k_nxt, v_nxt, mask_nxt

    @staticmethod
    def backward(ctx, dk, dv, _):
        dk_prev, dv_prev = _shift((dk, dv), ctx.group, -1)
        return None, dk_prev, dv_prev, None


class _AllReduceSum(torch.autograd.Function):
    """``psum`` over ``group``: every rank gets the sum. Every rank then
    uses the sum on its own, so the transpose is again a sum over the group
    of the incoming gradients (``psum``'s transpose in JAX)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, dy):
        return None, _summed(dy, ctx.group)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, a new tensor on ``x``'s device (the sum
    on the backend's device)."""
    y = x.to(collectives.comm_device(group, x), copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.device)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (``None``: ``x`` itself)."""
    return x if group is None else _AllReduceSum.apply(group, x)


def combine_dense(qf, k_cur, v_cur, mask_cur, m, l, acc, scale):
    """Fold one K/V block into the running ``(m, l, acc)`` with plain torch
    ops. ``qf`` is q in f32; ``mask_cur`` [B, Lk] bool."""
    s = torch.matmul(qf, k_cur.float().transpose(-1, -2)) * scale   # [B,H,Lc,Lck]
    s = s + torch.where(mask_cur, 0.0, NEG_INF)[:, None, None, :]
    m_blk = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_blk)
    # Fully-masked-so-far rows keep m at NEG_INF; pin the shift to 0 so
    # exp() underflows instead of producing exp(0) = 1 garbage.
    shift = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    alpha = torch.exp(torch.where(m <= NEG_INF / 2, NEG_INF, m) - shift)
    pij = torch.exp(s - shift)
    l_new = alpha * l + pij.sum(dim=-1, keepdim=True)
    acc_new = alpha * acc + torch.matmul(pij, v_cur.float())
    return m_new, l_new, acc_new


def combine_flash(q, k_cur, v_cur, mask_cur, m, l, acc, scale):
    """Fold one K/V block into the running ``(m, l, acc)`` through the
    stats kernel, which returns the block's normalised output and softmax
    stats. Fully-masked rows come back as ``(o, m, l) = (0, 0, 0)``:
    ``beta * l_blk = 0``, and the overestimated m rescales l and acc
    alike, so acc / l is intact."""
    o_blk, m_blk, l_blk = flash_attention_stats(q, k_cur, v_cur, kv_mask=mask_cur,
                                                scale=scale)
    m_blk = m_blk[..., None]                     # [B,H,Lc,1] f32
    l_blk = l_blk[..., None]
    m_new = torch.maximum(m, m_blk)
    shift = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    alpha = torch.exp(torch.where(m <= NEG_INF / 2, NEG_INF, m) - shift)
    beta = torch.exp(torch.where(l_blk > 0, m_blk, NEG_INF) - shift)
    l_new = alpha * l + beta * l_blk
    acc_new = alpha * acc + beta * (o_blk.float() * l_blk)
    return m_new, l_new, acc_new


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    group,
    scale: Optional[float] = None,
    use_flash: bool = False,
) -> torch.Tensor:
    """Attention over a sequence split over the ranks of ``group``.

    Args (all this rank's chunks):
      q, k, v: [B, H, Lc, D] (global L = Lc * group size), contiguous.
      kv_mask: [B, Lc] bool, True = real key; None = no padding.
      group: the sp process group; None = a ring of one.
      use_flash: each step's local attention through the stats kernel
        (``combine_flash``) instead of plain torch ops.

    Returns [B, H, Lc, D]: the local queries' attention over the global
    sequence, in q's dtype. Differentiable; the gradient of each K/V chunk
    is returned to the rank that owns it."""
    B, H, Lc, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    p = group_size(group)
    if kv_mask is None:
        kv_mask = torch.ones((B, Lc), dtype=torch.bool, device=q.device)
    kv_mask = kv_mask.to(torch.bool)

    qf = q.float()
    m = torch.full_like(qf[..., :1], NEG_INF)
    l = torch.zeros_like(qf[..., :1])
    acc = torch.zeros_like(qf)
    k_cur, v_cur, mask_cur = k, v, kv_mask
    for step in range(p):
        if use_flash:
            m, l, acc = combine_flash(q, k_cur, v_cur, mask_cur, m, l, acc, scale)
        else:
            m, l, acc = combine_dense(qf, k_cur, v_cur, mask_cur, m, l, acc, scale)
        if step < p - 1:  # the JAX scan's last rotation is never read
            k_cur, v_cur, mask_cur = _RingRotate.apply(group, k_cur, v_cur, mask_cur)
    out = acc / torch.clamp(l, min=1e-20)
    return out.to(q.dtype)


def ring_self_attention(attn: nn.Module, x: torch.Tensor, pad_mask: torch.Tensor,
                        group, heads: int, dtype: torch.dtype,
                        use_flash: bool = False) -> torch.Tensor:
    """Multi-head self-attention of the local chunk ``x`` [B, Lc, W] through
    :func:`ring_attention`, with ``attn``'s ``query``/``key``/``value``/``out``
    projections (``nn.Linear``, computed in ``dtype``)."""
    # The model's projection helper; imported here, as the model module
    # imports this one.
    from olearning_sim_tpu_torch.models.transformer import _dense

    B, Lc, W = x.shape
    D = W // heads
    q, k, v = (_dense(x, getattr(attn, n), dtype).view(B, Lc, heads, D)
               .transpose(1, 2).contiguous() for n in ("query", "key", "value"))
    o = ring_attention(q, k, v, pad_mask, group, use_flash=use_flash)
    o = o.transpose(1, 2).reshape(B, Lc, W)
    return _dense(o, attn.out, dtype)


class RingSelfAttention(nn.Module):
    """Multi-head self-attention whose sequence axis is split over an sp
    group. Parameter-compatible with the dense attention: ``query``,
    ``key``, ``value`` and ``out`` projections, as the JAX module's
    ``DenseGeneral`` kernels, so the same weights apply under either."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.bfloat16,
                 use_flash: bool = False):
        super().__init__()
        self.heads, self.dtype, self.use_flash = heads, dtype, use_flash
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(width, width)
        self.value = nn.Linear(width, width)
        self.out = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, group=None) -> torch.Tensor:
        # x: [B, Lc, W] local chunk; pad_mask: [B, Lc] bool.
        return ring_self_attention(self, x, pad_mask, group, self.heads, self.dtype,
                                   self.use_flash)
