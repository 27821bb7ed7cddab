"""Adversarial-client defense: config and robust-aggregation helpers.

The port of the JAX package's ``engine/defense.py``. The engine's
finiteness gate (``fedcore``) stops only non-finite updates; a finite
adversarial update (a sign-flipped or scaled delta, label-flip training)
would be averaged into the global model untouched. Three composable layers
close that gap, all inside the round (device tensors, no host round trip):

- **Per-client L2 norm clipping** (``clip_norm``): a client delta whose L2
  norm exceeds the threshold is rescaled onto the clip sphere before
  aggregation (``fedcore._clip_client_deltas``).
- **Robust aggregators** (``aggregator``): ``trimmed_mean`` and ``median``
  replace the weighted mean with coordinate-wise robust statistics over the
  participating clients (Yin et al. 2018), unweighted over participants.
- **Krum-style distance anomaly scores** (``anomaly_threshold``): each
  participant is scored by its L2 distance to the coordinate-wise median of
  all participant deltas (the single-center variant of Krum's score,
  Blanchard et al. 2017). The runner flags clients whose score exceeds
  ``anomaly_threshold x median(score)`` and feeds its
  :class:`~olearning_sim_tpu_torch.resilience.QuarantineManager`.

Clip norm and trim fraction are device tensors, so a change between rounds
costs nothing; the aggregator and the scoring switch choose the round's
code path.

Memory: coordinate-wise statistics need every client's value for each
coordinate, so a gathering defense (:attr:`DefenseConfig.gathers_deltas`)
keeps the gated, clipped f32 deltas of its clients for the round. Over dp
ranks, one ``all_to_all`` (:func:`shard_client_deltas`) re-lays them so
each rank holds every client for 1/dp of the coordinates, ``[C, P/dp]``
per rank (P the model's parameter count, padded as ``pad_to_axis`` pads
it): each coordinate's client column is whole, so the statistics are
those of one gathered ``[C, P]`` matrix, bit for bit. The aggregate goes
back to every rank through :func:`place_coordinate_shard` (or feeds the
sharded server update as it is), and the anomaly scores are a ``psum`` of
per-shard squared distances (:func:`distance_scores`). The sort over the
client axis runs in chunks of the coordinate axis (:func:`sort_chunk`),
so its transient (the sorted values and torch's int64 indices) is ``C x
chunk`` and not ``C x P``; every coordinate's column is independent, so
the values are those of one whole sort.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from olearning_sim_tpu_torch.parallel import collectives
from olearning_sim_tpu_torch.parallel.mesh import pad_to_multiple

AGGREGATORS = ("mean", "trimmed_mean", "median")

# Bytes of f32 values one chunk of the client-axis sort may hold; the sort
# adds as much again for its values and twice that for its int64 indices.
SORT_CHUNK_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class DefenseConfig:
    """Knobs for adversarial-client defense (engine params ``defense``).

    ``clip_norm`` — per-client delta L2 clipping threshold (None disables
    clipping). ``aggregator`` — ``mean`` (weighted, the default),
    ``trimmed_mean`` (drop the ``trim_fraction`` tails per coordinate), or
    ``median`` (coordinate-wise). ``anomaly_threshold`` — flag a
    participant whose distance-to-median score exceeds this multiple of the
    round's median score (None disables scoring); flagged clients accrue
    quarantine strikes exactly like non-finite clients
    (``quarantine_after`` / ``readmit_after`` apply when no
    resilience-configured :class:`QuarantineManager` exists already).
    """

    clip_norm: Optional[float] = None
    aggregator: str = "mean"
    trim_fraction: float = 0.1
    anomaly_threshold: Optional[float] = None
    quarantine_after: int = 1
    readmit_after: int = 3

    def __post_init__(self):
        if self.aggregator not in AGGREGATORS:
            raise ValueError(
                f"defense.aggregator must be one of {AGGREGATORS}, got "
                f"{self.aggregator!r}"
            )
        if self.clip_norm is not None and not self.clip_norm > 0.0:
            raise ValueError(
                f"defense.clip_norm must be > 0, got {self.clip_norm}"
            )
        if not 0.0 <= self.trim_fraction < 0.5:
            raise ValueError(
                f"defense.trim_fraction must be in [0, 0.5), got "
                f"{self.trim_fraction}"
            )
        if self.anomaly_threshold is not None \
                and not self.anomaly_threshold > 0.0:
            raise ValueError(
                f"defense.anomaly_threshold must be > 0, got "
                f"{self.anomaly_threshold}"
            )
        for fld in ("quarantine_after", "readmit_after"):
            v = getattr(self, fld)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"defense.{fld} must be an int >= 1, got {v!r}")

    @property
    def enabled(self) -> bool:
        return (self.clip_norm is not None or self.aggregator != "mean"
                or self.anomaly_threshold is not None)

    @property
    def score_enabled(self) -> bool:
        return self.anomaly_threshold is not None

    @property
    def gathers_deltas(self) -> bool:
        """Whether the round keeps the per-client delta matrix (robust
        aggregator and/or anomaly scoring)."""
        return self.aggregator != "mean" or self.score_enabled

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "DefenseConfig":
        """Engine-params JSON shape::

            {"clip_norm": 5.0, "aggregator": "trimmed_mean",
             "trim_fraction": 0.1, "anomaly_threshold": 4.0,
             "quarantine_after": 1, "readmit_after": 3}
        """
        if not isinstance(obj, dict):
            raise TypeError(
                f"defense config must be a JSON object, got "
                f"{type(obj).__name__}"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(obj) - known)
        if unknown:
            # A typo (clip_nrom) must fail at submit time, not silently run
            # undefended.
            raise ValueError(
                f"unknown defense config keys: {unknown} "
                f"(known: {sorted(known)})"
            )
        kw: Dict[str, Any] = {}
        for k in ("clip_norm", "trim_fraction", "anomaly_threshold"):
            if k in obj and obj[k] is not None:
                kw[k] = float(obj[k])
        if "aggregator" in obj:
            kw["aggregator"] = str(obj["aggregator"])
        for k in ("quarantine_after", "readmit_after"):
            if k in obj:
                kw[k] = int(obj[k])
        return cls(**kw)


# ------------------------------------------------------------------ helpers
# Over a stacked per-client tensor [C, ...] and a bool participant mask [C]
# on the same device. The participant count ``n`` and ``trim_fraction``
# stay device tensors: no host sync, and the masked-sort + index-window
# formulation keeps every shape independent of them.

def sort_chunk(num_clients: int) -> int:
    """Columns of the coordinate axis sorted at once for ``num_clients``
    clients: ``SORT_CHUNK_BYTES`` of f32 values."""
    return max(1, SORT_CHUNK_BYTES // (4 * max(1, num_clients)))


def _masked_sorted(flat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sort each coordinate over the client axis with non-participants
    forced to +inf (they sort past every real value and index windows
    bounded by ``n`` never reach them)."""
    return torch.sort(torch.where(mask[:, None], flat, float("inf")), dim=0).values


def robust_leaf_aggregate(leaf: torch.Tensor, mask: torch.Tensor, aggregator: str,
                          trim_fraction: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise robust aggregate of one stacked leaf [C, ...] over
    the participants in ``mask`` [C]; returns [...] (f32).

    ``trimmed_mean``: mean of each coordinate's sorted values with
    ``floor(trim_fraction * n)`` trimmed from each tail (capped so at least
    one value survives). ``median``: the exact coordinate-wise median
    (mean of the two middle order statistics for even ``n``). Zero
    participants aggregate to zero (the weighted mean's convention).
    The sort runs :func:`sort_chunk` coordinates at a time.
    """
    c = leaf.shape[0]
    flat = leaf.reshape(c, -1)
    n = mask.sum()
    i = torch.arange(c, device=leaf.device)[:, None]
    if aggregator == "trimmed_mean":
        k = torch.floor(trim_fraction.to(leaf.device, torch.float32)
                        * n.float()).long()
        k = torch.minimum(k, torch.clamp(n - 1, min=0) // 2)
        lo, hi = k, n - k
        window = (i >= lo) & (i < hi)
        denom = torch.clamp(hi - lo, min=1).float()
    elif aggregator == "median":
        j1 = torch.clamp(n - 1, min=0) // 2
        j2 = n // 2
        window = (i == j1) | (i == j2)
        denom = torch.clamp(window.sum(dim=0), min=1).float()
    else:
        raise ValueError(f"not a robust aggregator: {aggregator!r}")
    step = sort_chunk(c)
    out = torch.empty(flat.shape[1], dtype=torch.float32, device=leaf.device)
    for s in range(0, flat.shape[1], step):
        srt = _masked_sorted(flat[:, s:s + step].float(), mask)
        # The window's sum as the last row of a running sum down the client
        # axis: each column adds its values in client order, however many
        # columns the chunk or the rank's coordinate shard holds, so the
        # aggregate's bits do not depend on either.
        out[s:s + step] = torch.cumsum(torch.where(window, srt, 0.0), dim=0)[-1] / denom
    out = torch.where(n > 0, out, 0.0)
    return out.reshape(leaf.shape[1:])


def robust_aggregate(stacked: Dict[str, torch.Tensor], mask: torch.Tensor,
                     aggregator: str, trim_fraction: torch.Tensor) -> Dict[str, torch.Tensor]:
    """:func:`robust_leaf_aggregate` over each leaf of a stacked delta dict."""
    return {k: robust_leaf_aggregate(v, mask, aggregator, trim_fraction)
            for k, v in stacked.items()}


def partial_distance_sq(stacked: Dict[str, torch.Tensor],
                        center: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Every client's squared distance from ``center`` over the
    coordinates held here ``[C]``: the whole distance at dp 1, this rank's
    share of it on coordinate shards. The differences are taken
    :func:`sort_chunk` coordinates at a time."""
    total = None
    for k, leaf in stacked.items():
        c = leaf.shape[0]
        flat = leaf.reshape(c, -1)
        cen = center[k].reshape(1, -1).float()
        step = sort_chunk(c)
        if total is None:
            total = torch.zeros(c, dtype=torch.float32, device=leaf.device)
        for s in range(0, flat.shape[1], step):
            diff = flat[:, s:s + step].float() - cen[:, s:s + step]
            total = total + diff.square().sum(dim=1)
    return total


def distance_scores(stacked: Dict[str, torch.Tensor], center: Dict[str, torch.Tensor],
                    mask: torch.Tensor, group=None) -> torch.Tensor:
    """Krum-style anomaly scores [C]: each participant's L2 distance from
    ``center`` (the coordinate-wise median of participant deltas); 0 for
    non-participants. On coordinate shards the partial squared distances
    are summed over ``group`` before the square root, which recovers the
    gathered formulation's scores."""
    total = partial_distance_sq(stacked, center)
    if total is None:
        total = torch.zeros(mask.shape[0], dtype=torch.float32, device=mask.device)
    total = collectives.psum([total], group)[0]
    return torch.where(mask, torch.sqrt(total), 0.0)


# ------------------------------------------------- sharded (all_to_all) path
# The layout shared with the sharded server update: a leaf's flattened
# coordinates are zero-padded to a multiple of dp and split into dp
# contiguous blocks, rank i owning block i.

def pad_to_axis(flat: torch.Tensor, axis_size: int) -> torch.Tensor:
    """Zero-pad the last axis to ``pad_to_multiple`` of ``axis_size``: the
    rule the sharded update's flat layout uses, which lets a robust
    aggregate's coordinate shard feed that update directly."""
    pad = pad_to_multiple(flat.shape[-1], axis_size) - flat.shape[-1]
    return F.pad(flat, (0, pad)) if pad else flat


def shard_client_deltas(stacked: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """This rank's per-client delta leaves ``[c_local, ...]`` -> coordinate
    shards ``[C, P_pad/dp]`` holding every rank's clients (in rank order,
    as a tiled all_gather orders them) for this rank's 1/dp of the
    flattened, padded coordinates: one ``all_to_all`` for every leaf, no
    replication. Over no group, the flat ``[C, P]`` views."""
    n = collectives.size(group)
    keys = list(stacked)
    flat = [pad_to_axis(stacked[k].reshape(stacked[k].shape[0], -1).float(), n)
            for k in keys]
    return dict(zip(keys, collectives.all_to_all(flat, group)))


def place_coordinate_shard(shards: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Invert the coordinate sharding: every rank's ``[..., P_pad/dp]``
    shard of each leaf gathered in rank order into the flat padded
    ``[..., P_pad]`` vector, on every rank. The supports are disjoint, so
    the result is exact (the JAX engine's psum of zero-filled shards)."""
    keys = list(shards)
    return dict(zip(keys, collectives.all_gather([shards[k] for k in keys], group, dim=-1)))
