"""The round's collectives over a ``torch.distributed`` group: the port's
counterparts of the JAX engine's ``psum``, ``psum_scatter``,
``all_gather(tiled=True)``, ``all_to_all(tiled=True)`` and ``pmax`` over
the ``dp`` axis.

Each call takes a list of tensors and moves them in one flat buffer per
dtype, so a round's sums cost one collective and not one per parameter
leaf (XLA's all-reduce combiner merges the JAX engine's ``psum``\\ s the
same way; the sum is elementwise, so the values do not change).

Each backend communicates on its own device: NCCL on the tensors' CUDA
device, gloo on the CPU. The backend alone decides this: a tensor on
another device is copied to the backend's device and the result copied
back, and nothing catches a collective's error.

A ``None`` group is a group of one (``torch.distributed`` not
initialised): every call returns its inputs and launches nothing. A group
of one initialised rank launches every collective, with the same results.

The model-parallel paths need collectives inside the client's local step,
which the round trains under ``vmap(grad_and_value(loss))``: a plain
``dist.all_reduce`` neither differentiates nor accepts a functorch
``BatchedTensor``. :func:`copy_to` and :func:`reduce_from` are Megatron's
*f* and *g* (identity forward and all-reduce backward; all-reduce forward
and identity backward), and :func:`hop` is JAX's ``ppermute`` one stage on
along a pipeline; each is a ``torch.autograd.Function`` whose backward
calls another of them and whose ``vmap`` rule runs the collective once on
the physical batched tensor, so the backward is vmappable too. Every rank
of the group must reach each of them in the same order, forward and
backward.

:data:`BYTES` counts, per collective, the bytes each call hands to the
backend on this rank (the flat buffer's size): the per-round traffic that
``chip_smoke.py`` prints. The model-parallel ops count under their axis
(``mp_psum``, ``ep_psum``, ``pp_psum``, ``pp_hop``).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

BYTES: Dict[str, int] = {"psum": 0, "psum_scatter": 0, "all_gather": 0, "all_to_all": 0,
                         "pmax": 0, "mp_psum": 0, "ep_psum": 0, "pp_psum": 0, "pp_hop": 0}


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def comm_device(group, like: torch.Tensor) -> torch.device:
    """NCCL communicates on the tensors' CUDA device, every other backend
    (gloo) on the CPU."""
    if "nccl" in str(dist.get_backend(group)).lower():
        return like.device
    return torch.device("cpu")


@contextlib.contextmanager
def _quiet():
    """The tensor-collective names are deprecated on newer torch in favour
    of ``*_single`` names that older torch lacks; the call is kept and its
    warning silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield


def _pack(tensors: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(dev) for t in tensors])


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _all_reduce(tensors: Sequence[torch.Tensor], group, name: str,
                op) -> List[torch.Tensor]:
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for _, idx in _by_dtype(tensors).items():
        dev = comm_device(group, tensors[idx[0]])
        buf = _pack([tensors[i] for i in idx], dev)
        BYTES[name] += buf.numel() * buf.element_size()
        dist.all_reduce(buf, op=op, group=group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = buf[off:off + n].reshape(tensors[i].shape).to(tensors[i].device)
            off += n
    return out


def psum(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The elementwise sum of each tensor over the group's ranks, every
    rank receiving it (one ``all_reduce`` per dtype)."""
    return _all_reduce(tensors, group, "psum", dist.ReduceOp.SUM)


def pmax(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The elementwise maximum of each tensor over the group's ranks."""
    return _all_reduce(tensors, group, "pmax", dist.ReduceOp.MAX)


def agree(flag: bool, group) -> bool:
    """Whether ``flag`` holds on any rank of the group: one host decision
    that every rank then takes alike (a barrier, too)."""
    if group is None:
        return bool(flag)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if "nccl" in str(dist.get_backend(group)).lower() else torch.device("cpu"))
    return bool(pmax([torch.tensor([int(flag)], device=dev)], group)[0].item())


def psum_scatter(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The sum over the group's ranks of each tensor ``[..., D]`` (``D`` a
    multiple of the group size ``n``), of which this rank keeps its
    contiguous ``1/n`` of the last axis, ``[..., D/n]`` at offset ``rank *
    D/n`` (one ``reduce_scatter_tensor`` per dtype)."""
    tensors = list(tensors)
    n = size(group)
    if group is None or not tensors:
        return tensors
    for t in tensors:
        if t.shape[-1] % n:
            raise ValueError(f"last axis {t.shape[-1]} is not a multiple of {n} ranks")
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for _, idx in _by_dtype(tensors).items():
        dev = comm_device(group, tensors[idx[0]])
        # Rank j's slice of every tensor, concatenated: row j of [n, per_rank].
        parts = [tensors[i].to(dev).reshape(-1, n, tensors[i].shape[-1] // n)
                 .transpose(0, 1).reshape(n, -1) for i in idx]
        buf = torch.cat(parts, dim=1).contiguous()
        res = torch.empty(buf.shape[1], dtype=buf.dtype, device=dev)
        BYTES["psum_scatter"] += buf.numel() * buf.element_size()
        with _quiet():
            dist.reduce_scatter_tensor(res, buf.reshape(-1), group=group)
        off = 0
        for i, part in zip(idx, parts):
            m = part.shape[1]
            t = tensors[i]
            out[i] = res[off:off + m].reshape(t.shape[:-1] + (t.shape[-1] // n,)).to(t.device)
            off += m
    return out


def all_gather(tensors: Sequence[torch.Tensor], group, dim: int = 0) -> List[torch.Tensor]:
    """Each tensor's pieces from every rank, concatenated in rank order
    along ``dim`` (``all_gather(tiled=True)``; one
    ``all_gather_into_tensor`` per dtype)."""
    tensors = list(tensors)
    n = size(group)
    if group is None or not tensors:
        return tensors
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for _, idx in _by_dtype(tensors).items():
        dev = comm_device(group, tensors[idx[0]])
        buf = _pack([tensors[i] for i in idx], dev)
        res = torch.empty(n * buf.numel(), dtype=buf.dtype, device=dev)
        BYTES["all_gather"] += buf.numel() * buf.element_size()
        with _quiet():
            dist.all_gather_into_tensor(res, buf, group=group)
        res = res.reshape(n, buf.numel())
        off = 0
        for i in idx:
            t = tensors[i]
            d = dim % t.dim()
            piece = res[:, off:off + t.numel()].reshape((n,) + t.shape)
            # [n, ..., s, ...] -> [..., n, s, ...] -> [..., n * s, ...]
            full = piece.movedim(0, d).reshape(t.shape[:d] + (n * t.shape[d],) + t.shape[d + 1:])
            out[i] = full.to(t.device)
            off += t.numel()
    return out


def all_to_all(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Re-lay each ``[c, D]`` tensor (``D`` a multiple of the group size
    ``n``) so this rank holds every rank's rows for its ``1/n`` of the
    columns: ``[n * c, D/n]``, rows in rank order
    (``all_to_all(split_axis=1, concat_axis=0, tiled=True)``; one
    ``all_to_all_single`` per dtype)."""
    tensors = list(tensors)
    n = size(group)
    if group is None or not tensors:
        return tensors
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for _, idx in _by_dtype(tensors).items():
        dev = comm_device(group, tensors[idx[0]])
        # Row j of [n, per_rank]: every tensor's columns for rank j.
        parts = []
        for i in idx:
            t = tensors[i].to(dev)
            c, d = t.shape
            if d % n:
                raise ValueError(f"columns {d} are not a multiple of {n} ranks")
            parts.append(t.reshape(c, n, d // n).transpose(0, 1).reshape(n, -1))
        buf = torch.cat(parts, dim=1).contiguous()
        res = torch.empty_like(buf)
        BYTES["all_to_all"] += buf.numel() * buf.element_size()
        dist.all_to_all_single(res, buf, group=group)
        off = 0
        for i, part in zip(idx, parts):
            m = part.shape[1]
            c, d = tensors[i].shape
            out[i] = res[:, off:off + m].reshape(n * c, d // n).to(tensors[i].device)
            off += m
    return out


# ------------------------------------------------- differentiable, vmappable
def active(group) -> bool:
    """Whether ``group`` has more than one rank: an axis of size 1 launches
    no collective of its own."""
    return group is not None and dist.get_world_size(group) > 1


def _physical(info, in_dim, x: torch.Tensor) -> torch.Tensor:
    """The batched tensor of a ``vmap`` rule with its batch axis first (an
    unbatched input expanded to the batch), so every rank hands the
    collective the same shape."""
    if in_dim is None:
        return x.unsqueeze(0).expand((info.batch_size,) + x.shape)
    return x.movedim(in_dim, 0)


def _sum_raw(x: torch.Tensor, group, name: str) -> torch.Tensor:
    return _all_reduce([x.contiguous()], group, name, dist.ReduceOp.SUM)[0]


class _ReduceFrom(torch.autograd.Function):
    """Megatron's *g*: the sum over the group forward, identity backward."""

    @staticmethod
    def forward(x, group, name):
        return _sum_raw(x, group, name)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None

    @staticmethod
    def vmap(info, in_dims, x, group, name):
        return _ReduceFrom.apply(_physical(info, in_dims[0], x), group, name), 0


class _CopyTo(torch.autograd.Function):
    """Megatron's *f*: identity forward, the sum over the group backward."""

    @staticmethod
    def forward(x, group, name):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.name = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFrom.apply(grad, ctx.group, ctx.name), None, None

    @staticmethod
    def vmap(info, in_dims, x, group, name):
        return _CopyTo.apply(x, group, name), in_dims[0]


def reduce_from(x: torch.Tensor, group, name: str = "mp_psum") -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable as identity: the
    close of a row-parallel product, whose every rank then holds the whole
    (replicated) value and differentiates its own copy of the loss. ``x``
    itself over a group of one."""
    return _ReduceFrom.apply(x, group, name) if active(group) else x


def copy_to(x: torch.Tensor, group, name: str = "mp_psum") -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``group``: a replicated
    value entering a computation split over the group's ranks (a
    column-parallel product), so each rank's partial gradient of it
    becomes the whole."""
    return _CopyTo.apply(x, group, name) if active(group) else x


def _shift_raw(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places on in ``group`` (none past
    either end) and receive from the rank ``step`` places back (zeros at
    the first end): the pipeline's ``ppermute`` with ``perm = [(i, i +
    step)]``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    dev = comm_device(group, x)
    src = x.contiguous().to(dev)
    out = torch.zeros_like(src)
    ops = []
    if 0 <= r + step < n:
        ops.append(dist.P2POp(dist.isend, src, dist.get_global_rank(group, r + step), group))
        BYTES["pp_hop"] += src.numel() * src.element_size()
    if 0 <= r - step < n:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, r - step), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device)


class _Hop(torch.autograd.Function):
    """One pipeline hop (stage p to p + 1); its backward is the hop back
    (stage p + 1 to p), so each activation's gradient reaches its sender."""

    @staticmethod
    def forward(x, group, step):
        return _shift_raw(x, group, step)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.step = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return _Hop.apply(grad, ctx.group, -ctx.step), None, None

    @staticmethod
    def vmap(info, in_dims, x, group, step):
        return _Hop.apply(_physical(info, in_dims[0], x), group, step), 0


def hop(x: torch.Tensor, group) -> torch.Tensor:
    """``ppermute`` of ``x`` one stage on along ``group`` (the pipeline):
    stage p receives stage p - 1's ``x``, stage 0 zeros, and the last
    stage's ``x`` goes nowhere. Differentiable (the backward hops back) and
    vmappable. Every stage must call it, and its result must reach every
    stage's loss, or the backward hops of the stages do not pair up."""
    return _Hop.apply(x, group, 1) if active(group) else torch.zeros_like(x)
