"""Process meshes over ``torch.distributed``: the port of the JAX package's
``parallel/mesh.py`` (``make_mesh_plan``, ``ParallelConfig``,
``pad_to_multiple``, ``shard_clients``) for the data-parallel round and the
long-context path.

A JAX mesh lays devices out on named axes; here each process (rank) is one
device, and a :class:`MeshPlan` says where this rank sits on the ``dp``
(batch) and ``sp`` (sequence) axes and holds the process groups that
reduce along each axis. Ranks are laid out as the JAX mesh lays devices
out, dp-major and sp-minor: ``rank = dp_rank * sp + sp_rank``, so the
ranks of one sp ring are neighbours.

JAX runs one process over every device; the port runs one process per
rank, each holding the same host control (as the JAX package runs across
hosts, ``global_put``): every rank builds the same full host arrays from
the seed and places only its own contiguous shard of clients on its card.

A plan over an uninitialised ``torch.distributed`` has no groups: ``None``
is a group of one everywhere in the port (a collective over it is the
identity), and ring attention over it is a ring of one. Once a default
group is initialised, a plan holds its ``dp`` and world groups even at a
world of one, so the round's collectives really launch.
"""

from __future__ import annotations

import dataclasses
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
    ranks the plan spans (every rank of the default group). ``mp`` and
    ``pp`` above 1 are not ported (``ROADMAP.md`` A10)."""

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


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """This rank's place on a ``dp x sp`` mesh and the groups along it.

    ``sp_group`` holds the ``sp`` ranks that share this rank's dp index
    (one ring; ``None`` at sp 1); ``dp_group`` the ``dp`` ranks that share
    its sp index; ``world_group`` every rank of the mesh. The dp and world
    groups are ``None`` only when ``torch.distributed`` is not initialised."""

    dp: int
    sp: int
    rank: int
    sp_group: Optional[Any] = None
    dp_group: Optional[Any] = None
    world_group: Optional[Any] = None

    @property
    def dp_rank(self) -> int:
        return self.rank // self.sp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.sp


def shard_clients(num_clients: int, plan: MeshPlan, block: int = 1) -> Tuple[int, int]:
    """The client split over dp: ``(padded_clients, clients_per_rank)``,
    padded so the client axis divides ``dp * block`` (every rank holds a
    whole number of blocks); padded clients carry zero weight. Rank ``d``
    holds clients ``[d * per_rank, (d + 1) * per_rank)``."""
    padded = pad_to_multiple(num_clients, plan.dp * block)
    return padded, padded // plan.dp


def make_mesh_plan(dp: Optional[int] = None, mp: int = 1, sp: int = 1) -> MeshPlan:
    """Build the ``dp x sp`` plan over the ranks of ``torch.distributed``'s
    default group (one rank when it is not initialised).

    ``dp`` defaults to ``world_size // (mp * sp)``. Every rank must belong
    to the mesh, and every rank must call this with the same arguments:
    the groups are made with ``dist.new_group``, which all ranks call in
    the same order."""
    if mp > 1:
        raise NotImplementedError(
            "mp > 1 (tensor parallelism) is not ported yet: ROADMAP.md A10"
        )
    if mp <= 0 or sp <= 0:
        raise ValueError(f"mp and sp must be positive, got mp={mp} sp={sp}")
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if dp is None:
        dp = world // (mp * sp)
    if dp <= 0:
        raise ValueError(
            f"dp={dp} (mp={mp} sp={sp} over {world} ranks) — the mesh needs "
            f"at least mp*sp ranks"
        )
    total = dp * mp * sp
    if total != world:
        raise ValueError(
            f"mesh {dp}x{sp} needs {total} ranks, have {world}; every rank "
            f"must belong to the mesh"
        )
    if not initialized:
        return MeshPlan(dp=dp, sp=sp, rank=0)

    def groups(rank_lists):
        # Every rank creates every group, in one order; keeps its own.
        mine = None
        for ranks in rank_lists:
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    sp_group = None
    if sp > 1:
        sp_group = groups([[d * sp + s for s in range(sp)] for d in range(dp)])
    # The dp group exists at every size, so a world of one launches the
    # round's collectives too.
    dp_group = (dist.group.WORLD if sp == 1 else
                groups([[d * sp + s for d in range(dp)] for s in range(sp)]))
    return MeshPlan(dp=dp, sp=sp, rank=rank, sp_group=sp_group,
                    dp_group=dp_group, world_group=dist.group.WORLD)
