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

:data:`BYTES` counts, per collective, the bytes each call hands to the
backend on this rank (the flat buffer's size): the per-round traffic that
``chip_smoke.py`` prints.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

BYTES: Dict[str, int] = {"psum": 0, "psum_scatter": 0, "all_gather": 0, "all_to_all": 0,
                         "pmax": 0}


def reset_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _comm_device(group, like: torch.Tensor) -> torch.device:
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
        dev = _comm_device(group, tensors[idx[0]])
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
        dev = _comm_device(group, tensors[idx[0]])
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
        dev = _comm_device(group, tensors[idx[0]])
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
        dev = _comm_device(group, tensors[idx[0]])
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
