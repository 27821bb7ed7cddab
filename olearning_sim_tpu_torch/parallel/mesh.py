"""Process meshes over ``torch.distributed``: the port of the JAX package's
``parallel/mesh.py`` (``make_mesh_plan``, ``ParallelConfig``,
``pad_to_multiple``, ``shard_clients``) for the round, the model-parallel
paths and the long-context path.

A JAX mesh lays devices out on named axes; here each process (rank) is one
device, and a :class:`MeshPlan` says where this rank sits on the ``dp``
(clients), ``mp`` (tensor), ``sp`` (sequence), ``ep`` (experts) and
``pp`` (stages) axes and holds the process groups that reduce along each
axis. Ranks are laid out as the JAX mesh lays devices out, in the axis
order ``(dp, mp, sp, ep, pp)`` with the minor axes last::

    rank = ((((dp_rank * mp + mp_rank) * sp + sp_rank) * ep + ep_rank) * pp + pp_rank)

so the ranks of one sp ring, one expert group or one pipeline are
neighbours.

JAX runs one process over every device; the port runs one process per
rank, each holding the same host control (as the JAX package runs across
hosts, ``global_put``): every rank builds the same full host arrays from
the seed and places only its own contiguous shard of clients on its card.

A plan over an uninitialised ``torch.distributed`` has no groups: ``None``
is a group of one everywhere in the port (a collective over it is the
identity), and ring attention over it is a ring of one. Once a default
group is initialised, a plan holds its ``dp`` and world groups even at a
world of one, so the round's collectives really launch. An ``mp``, ``sp``,
``ep`` or ``pp`` axis of size 1 has no group and launches no collective.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional, Tuple

import torch.distributed as dist


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest m >= n with m % multiple == 0 (and m >= multiple)."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return max(multiple, -(-int(n) // multiple) * multiple)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The engine params' ``parallel`` block, as the JAX package parses it:
    the model axes ``mp`` (tensor parallel) and ``pp`` (stage pipelined,
    with ``microbatches``). There is no ``dp`` key: dp is the number of
    ranks the plan spans (every rank of the default group) over
    ``mp * pp``. ``mp`` runs the tensor-parallel round
    (:mod:`~olearning_sim_tpu_torch.parallel.tp`), ``pp`` the pipelined one
    (:mod:`~olearning_sim_tpu_torch.engine.pp_rounds`)."""

    mp: int = 1
    pp: int = 1
    microbatches: Optional[int] = None

    def __post_init__(self):
        for fld in ("mp", "pp"):
            v = getattr(self, fld)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"parallel.{fld} must be an int >= 1, got {v!r}")
        if self.mp > 1 and self.pp > 1:
            raise ValueError(
                "parallel.mp and parallel.pp are mutually exclusive: one "
                "model axis per client family (tensor-parallel OR "
                "stage-pipelined; see docs/performance.md)"
            )
        if self.microbatches is not None:
            if not isinstance(self.microbatches, int) or self.microbatches < 1:
                raise ValueError(
                    f"parallel.microbatches must be an int >= 1, got "
                    f"{self.microbatches!r}"
                )
            if self.pp <= 1:
                raise ValueError(
                    "parallel.microbatches only applies to pipeline "
                    "parallelism (set parallel.pp > 1)"
                )

    @property
    def enabled(self) -> bool:
        return self.mp > 1 or self.pp > 1

    @classmethod
    def from_dict(cls, obj: dict) -> "ParallelConfig":
        """``{"mp": 2}`` or ``{"pp": 2, "microbatches": 4}``; unknown keys
        (``dp`` among them) are rejected, as the JAX package rejects them."""
        if not isinstance(obj, dict):
            raise TypeError(
                f"parallel config must be a JSON object, got {type(obj).__name__}"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(obj) - known)
        if unknown:
            raise ValueError(
                f"unknown parallel config keys: {unknown} (known: {sorted(known)})"
            )
        kw = {}
        for k in ("mp", "pp", "microbatches"):
            if obj.get(k) is not None:
                kw[k] = int(obj[k])
        return cls(**kw)

    def make_plan(self) -> "MeshPlan":
        """The plan this block asks for, over every rank of the default
        group (dp is the rest)."""
        return make_mesh_plan(mp=self.mp, pp=self.pp)

    def matches(self, plan: "MeshPlan") -> bool:
        """Whether an externally supplied plan realizes this block."""
        return plan.mp == self.mp and plan.pp == self.pp


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """This rank's place on a ``dp x mp x sp x ep x pp`` mesh and the groups
    along it.

    ``<axis>_group`` holds the ranks that differ from this one on that axis
    alone (``None`` when the axis has size 1); ``dp_group`` exists at every
    dp (the world itself when every other axis is 1); ``world_group`` holds
    every rank of the mesh. The dp and world groups are ``None`` only when
    ``torch.distributed`` is not initialised."""

    dp: int
    sp: int
    rank: int
    sp_group: Optional[Any] = None
    dp_group: Optional[Any] = None
    world_group: Optional[Any] = None
    mp: int = 1
    ep: int = 1
    pp: int = 1
    mp_group: Optional[Any] = None
    ep_group: Optional[Any] = None
    pp_group: Optional[Any] = None

    @property
    def n_devices(self) -> int:
        return self.dp * self.mp * self.sp * self.ep * self.pp

    def _coord(self, minor: int, size: int) -> int:
        return (self.rank // minor) % size

    @property
    def pp_rank(self) -> int:
        return self._coord(1, self.pp)

    @property
    def ep_rank(self) -> int:
        return self._coord(self.pp, self.ep)

    @property
    def sp_rank(self) -> int:
        return self._coord(self.ep * self.pp, self.sp)

    @property
    def mp_rank(self) -> int:
        return self._coord(self.sp * self.ep * self.pp, self.mp)

    @property
    def dp_rank(self) -> int:
        return self.rank // (self.mp * self.sp * self.ep * self.pp)


def shard_clients(num_clients: int, plan: MeshPlan, block: int = 1) -> Tuple[int, int]:
    """The client split over dp: ``(padded_clients, clients_per_rank)``,
    padded so the client axis divides ``dp * block`` (every rank holds a
    whole number of blocks); padded clients carry zero weight. Rank ``d``
    holds clients ``[d * per_rank, (d + 1) * per_rank)``."""
    padded = pad_to_multiple(num_clients, plan.dp * block)
    return padded, padded // plan.dp


_AXES = ("dp", "mp", "sp", "ep", "pp")


def _axis_lists(sizes) -> dict:
    """For each axis, the rank lists of its groups: the ranks that differ on
    that axis alone, over every coordinate of the others in order."""
    strides, acc = {}, 1
    for name in reversed(_AXES):
        strides[name] = acc
        acc *= sizes[name]
    coords = list(itertools.product(*(range(sizes[a]) for a in _AXES)))
    lists = {}
    for axis in _AXES:
        seen = {}
        for c in coords:
            base = sum(strides[a] * (0 if a == axis else c[i]) for i, a in enumerate(_AXES))
            seen.setdefault(base, [base + strides[axis] * j for j in range(sizes[axis])])
        lists[axis] = list(seen.values())
    return lists


def make_mesh_plan(dp: Optional[int] = None, mp: int = 1, sp: int = 1, ep: int = 1,
                   pp: int = 1) -> MeshPlan:
    """Build the ``dp x mp x sp x ep x pp`` plan over the ranks of
    ``torch.distributed``'s default group (one rank when it is not
    initialised).

    ``dp`` defaults to ``world_size // (mp * sp * ep * pp)``. Every rank
    must belong to the mesh, and every rank must call this with the same
    arguments: the groups are made with ``dist.new_group``, which all ranks
    call in one order (sp, dp, then mp, ep and pp)."""
    if mp <= 0 or sp <= 0 or ep <= 0 or pp <= 0:
        raise ValueError(
            f"mp, sp, ep and pp must be positive, got mp={mp} sp={sp} "
            f"ep={ep} pp={pp}"
        )
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if dp is None:
        dp = world // (mp * sp * ep * pp)
    if dp <= 0:
        raise ValueError(
            f"dp={dp} (mp={mp} sp={sp} ep={ep} pp={pp} over {world} "
            f"devices) — the mesh needs at least mp*sp*ep*pp devices"
        )
    sizes = {"dp": dp, "mp": mp, "sp": sp, "ep": ep, "pp": pp}
    total = dp * mp * sp * ep * pp
    if total != world:
        shape = "x".join(str(sizes[a]) for a in _AXES if a in ("dp", "mp") or sizes[a] > 1)
        raise ValueError(
            f"mesh {shape} needs {total} devices, have {world}; every rank "
            f"must belong to the mesh"
        )
    if not initialized:
        return MeshPlan(dp=dp, sp=sp, rank=0, mp=mp, ep=ep, pp=pp)

    def groups(rank_lists):
        # Every rank creates every group, in one order; keeps its own.
        mine = None
        for ranks in rank_lists:
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    lists = _axis_lists(sizes)
    sp_group = groups(lists["sp"]) if sp > 1 else None
    # The dp group exists at every size, so a world of one launches the
    # round's collectives too.
    dp_group = dist.group.WORLD if total == dp else groups(lists["dp"])
    mp_group = groups(lists["mp"]) if mp > 1 else None
    ep_group = groups(lists["ep"]) if ep > 1 else None
    pp_group = groups(lists["pp"]) if pp > 1 else None
    return MeshPlan(dp=dp, sp=sp, rank=rank, sp_group=sp_group, dp_group=dp_group,
                    world_group=dist.group.WORLD, mp=mp, ep=ep, pp=pp,
                    mp_group=mp_group, ep_group=ep_group, pp_group=pp_group)
