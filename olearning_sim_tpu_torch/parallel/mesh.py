"""Process meshes over ``torch.distributed``: the port of the JAX package's
``parallel/mesh.py`` ``make_mesh_plan`` for the long-context path.

A JAX mesh lays devices out on named axes; here each process (rank) is one
device, and a :class:`MeshPlan` says where this rank sits on the ``dp``
(batch) and ``sp`` (sequence) axes and holds the process groups that
reduce along each axis. Ranks are laid out as the JAX mesh lays devices
out, dp-major and sp-minor: ``rank = dp_rank * sp + sp_rank``, so the
ranks of one sp ring are neighbours.

A plan over one process (``torch.distributed`` not initialised, or a world
of one) has no groups: ``None`` is a group of one everywhere in the port,
and ring attention over it is a ring of one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """This rank's place on a ``dp x sp`` mesh and the groups along it.

    ``sp_group`` holds the ``sp`` ranks that share this rank's dp index
    (one ring); ``dp_group`` the ``dp`` ranks that share its sp index;
    ``world_group`` every rank of the mesh. Each is ``None`` where it would
    hold one rank."""

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


def make_mesh_plan(dp: Optional[int] = None, mp: int = 1, sp: int = 1) -> MeshPlan:
    """Build the ``dp x sp`` plan over the ranks of ``torch.distributed``'s
    default group (one rank when it is not initialised).

    ``dp`` defaults to ``world_size // (mp * sp)``. Every rank must belong
    to the mesh, and every rank must call this with the same arguments:
    the groups are made with ``dist.new_group``, which all ranks call in
    the same order."""
    if mp > 1:
        raise NotImplementedError(
            "mp > 1 (tensor parallelism) is not ported yet; see ROADMAP.md"
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
    if world == 1:
        return MeshPlan(dp=dp, sp=sp, rank=0)

    def groups(rank_lists):
        # Every rank creates every group, in one order; keeps its own.
        mine = None
        for ranks in rank_lists:
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    sp_group = dp_group = None
    if sp > 1:
        sp_group = groups([[d * sp + s for s in range(sp)] for d in range(dp)])
    if dp > 1:
        dp_group = groups([[d * sp + s for d in range(dp)] for s in range(sp)])
    return MeshPlan(dp=dp, sp=sp, rank=rank, sp_group=sp_group,
                    dp_group=dp_group, world_group=dist.group.WORLD)
