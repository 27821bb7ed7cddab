"""Buffered asynchronous rounds: FedBuff-style staleness-weighted commits.

The port of the JAX package's ``engine/async_rounds.py``. A synchronous
round closes at a deadline and drops its stragglers; an asynchronous round
turns that tail into commits:

- clients are dispatched at round begin on the round's anchor model and
  *arrive* in simulated completion-time order (the pacing module's arrivals:
  network release + device-class compute);
- arrivals fill a buffer of ``buffer_size`` (M) updates; every M arrivals
  the server commits: the buffered deltas are averaged, discounted by their
  staleness, and the server optimizer steps. A client committing in window
  ``w`` has staleness ``w``, the number of server commits since its
  dispatch;
- the schedules (FedBuff, Nguyen et al. 2022; Apodotiko, arXiv 2404.14033):
  ``constant``, ``polynomial`` (``(1+s)^-alpha``) and ``score`` (the
  polynomial discount times a per-client contribution score from the
  client's simulated speed).

The planning half (:class:`AsyncConfig`, :class:`AsyncRoundPlan`,
:func:`plan_async_round`, :func:`staleness_weights`) is a copy of the JAX
package's numpy code, so one seed gives the same windows, scores and commit
times in both packages. Ties in completion time break by client index
(``pacing.arrival_ranks``), which is what lets a resume replay the commit
sequence.

The program half, :func:`async_round`, is the JAX engine's buffered round in
torch, data-parallel over the core's ranks as the synchronous round is,
reached through ``FedCore.round_step(..., async_plan=...)``:
local training of every selected client once, on the anchor model, through
the synchronous round's block body (``FedCore._train_block``: the attack,
the finiteness gate, the clip, then the ``score`` reweighting); the block's
weighted deltas summed into their window's slot of a ``[W, ...]`` f32
buffer by a ``[block, W]`` one-hot weight matrix contracted with the deltas
(a fixed summation order, no atomics, so two identical rounds agree bit for
bit on a card); then W server commits in window order, each kept by a
``torch.where`` on the device only where its window holds weight and its
discount is positive (an empty window is a bitwise no-op, and the host
never waits). A gathering defense takes its robust statistics per window
over the ``[C, ...]`` buffer of clipped deltas; each client's anomaly score
comes from its own window, measured from the aggregator's own result when
the aggregator is robust (the JAX async program's center, not the
synchronous round's median). Under ``shard_server_update`` the commits run
on the flat padded views the optimizer state lives on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from olearning_sim_tpu_torch.engine.pacing import DeadlineConfig, arrival_ranks
from olearning_sim_tpu_torch.telemetry import default_tracer

SCHEDULES = ("constant", "polynomial", "score")

# A disabled max_staleness as the JAX engine passes it: every finite window
# index compares below it, so staleness dropping is bitwise off.
_NO_MAX_STALENESS = 3.0e38


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Knobs for buffered asynchronous rounds (engine params ``async``).

    ``buffer_size`` — M, the number of arrivals per server commit.
    ``max_staleness`` — commits beyond which a buffered update is dropped
    instead of committed (None disables; dropped clients are reported as
    ``stale_dropped``, distinct from deadline stragglers). ``schedule`` —
    staleness-weight schedule applied to each commit window:
    ``constant``, ``polynomial`` (``(1+s)^-staleness_alpha``), or
    ``score`` (polynomial discount x per-client Apodotiko-style speed
    score). ``staleness_alpha`` is data — per-round changes never
    recompile. ``speed_profiles`` / ``default_step_s`` / ``jitter`` feed
    the pacing completion-time model that orders arrivals (same semantics
    as DeadlineConfig's fields); a task may not configure ``deadline``
    and ``async`` together — ``max_staleness`` is the async engine's
    lateness control.
    """

    buffer_size: int = 64
    max_staleness: Optional[int] = None
    schedule: str = "polynomial"
    staleness_alpha: float = 0.5
    speed_profiles: Dict[str, float] = dataclasses.field(default_factory=dict)
    default_step_s: float = 0.1
    jitter: float = 0.0

    def __post_init__(self):
        if not isinstance(self.buffer_size, int) or self.buffer_size < 1:
            raise ValueError(
                f"async.buffer_size must be an int >= 1, got "
                f"{self.buffer_size!r}"
            )
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"async.schedule must be one of {SCHEDULES}, got "
                f"{self.schedule!r}"
            )
        if self.max_staleness is not None and (
            not isinstance(self.max_staleness, int) or self.max_staleness < 0
        ):
            raise ValueError(
                f"async.max_staleness must be an int >= 0 or null, got "
                f"{self.max_staleness!r}"
            )
        if self.staleness_alpha < 0.0:
            raise ValueError(
                f"async.staleness_alpha must be >= 0, got "
                f"{self.staleness_alpha}"
            )
        for fld in ("default_step_s", "jitter"):
            if getattr(self, fld) < 0:
                raise ValueError(f"async.{fld} must be >= 0")

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "AsyncConfig":
        """Engine-params JSON shape::

            {"buffer_size": 64, "max_staleness": 8,
             "schedule": "polynomial", "staleness_alpha": 0.5,
             "speed_profiles": {"high": 0.05, "low": 0.4},
             "default_step_s": 0.1, "jitter": 0.1}
        """
        if not isinstance(obj, dict):
            raise TypeError(
                f"async config must be a JSON object, got "
                f"{type(obj).__name__}"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(obj) - known)
        if unknown:
            # A typo (bufer_size) must fail at submit time, not silently
            # run synchronous.
            raise ValueError(
                f"unknown async config keys: {unknown} "
                f"(known: {sorted(known)})"
            )
        kw: Dict[str, Any] = {}
        if obj.get("buffer_size") is not None:
            kw["buffer_size"] = int(obj["buffer_size"])
        if obj.get("max_staleness") is not None:
            kw["max_staleness"] = int(obj["max_staleness"])
        if obj.get("schedule") is not None:
            kw["schedule"] = str(obj["schedule"])
        for k in ("staleness_alpha", "default_step_s", "jitter"):
            if obj.get(k) is not None:
                kw[k] = float(obj[k])
        if "speed_profiles" in obj:
            kw["speed_profiles"] = {
                str(k): float(v) for k, v in obj["speed_profiles"].items()
            }
        return cls(**kw)

    def pacing_config(self) -> DeadlineConfig:
        """The completion-time model as a DeadlineConfig (pacing's input
        type) — deadline-free, so only the arrival simulation applies."""
        return DeadlineConfig(
            speed_profiles=dict(self.speed_profiles),
            default_step_s=self.default_step_s,
            jitter=self.jitter,
        )

    def num_windows(self, num_clients: int) -> int:
        """Buffer capacity W for a (padded) population: the number of
        commits a round can make."""
        return max(1, int(math.ceil(num_clients / self.buffer_size)))


@dataclasses.dataclass
class AsyncRoundPlan:
    """One round's host-side async plan (the analogue of RoundPacing).

    ``window`` [C] int32 — each (padded) client's commit-window index in
    arrival order (-1 = not participating this round); ``score`` [C]
    float32 or None — per-client Apodotiko-style contribution scores
    (``schedule == "score"`` only); ``commit_time`` [W] float32 — the
    simulated time each window commits (its last member's arrival; inf
    for empty windows), the idle-accounting input; ``fill`` [W] int32 —
    arrivals per window (<= M; the tail window is usually partial).
    """

    config: AsyncConfig
    window: np.ndarray
    score: Optional[np.ndarray]
    num_windows: int
    commit_time: np.ndarray
    fill: np.ndarray

    @property
    def num_selected(self) -> int:
        return int((self.window >= 0).sum())

    def stale_dropped_mask(self) -> np.ndarray:
        """[C] bool — selected clients whose window exceeds max_staleness
        (their update is buffered but never committed)."""
        ms = self.config.max_staleness
        if ms is None:
            return np.zeros_like(self.window, bool)
        return (self.window >= 0) & (self.window > ms)

    def idle_seconds(self, completion: np.ndarray) -> float:
        """Simulated seconds committed updates spent waiting in the buffer
        (arrival -> their window's commit). The synchronous analogue —
        every on-time update waiting until round close — is what this
        engine drives toward ~0 (``ols_engine_idle_seconds_total``)."""
        real = min(len(completion), len(self.window))
        win = self.window[:real]
        committed = (win >= 0) & ~self.stale_dropped_mask()[:real]
        if not committed.any():
            return 0.0
        ct = self.commit_time[win[committed]].astype(np.float64)
        comp = np.asarray(completion, np.float64)[committed]
        ok = np.isfinite(ct) & np.isfinite(comp)
        return float(np.clip(ct[ok] - comp[ok], 0.0, None).sum())


def plan_async_round(
    cfg: AsyncConfig,
    completion: np.ndarray,
    selected: np.ndarray,
    num_clients_padded: int,
) -> AsyncRoundPlan:
    """Assign commit windows in simulated-arrival order.

    ``completion`` [real] float32 simulated completion times
    (:func:`pacing.completion_times`); ``selected`` [real] bool — this
    round's participating clients. Deterministic: ties in completion time
    break by client index (``pacing.arrival_ranks``), which is what lets
    rollback/resume replay the identical commit sequence.
    """
    real = len(selected)
    if num_clients_padded < real:
        raise ValueError(
            f"padded population {num_clients_padded} smaller than the "
            f"{real} real clients in the selection mask"
        )
    ranks = arrival_ranks(completion, selected)
    window = np.full(num_clients_padded, -1, np.int32)
    window[:real] = np.where(
        ranks >= 0, ranks // cfg.buffer_size, -1
    ).astype(np.int32)
    num_windows = cfg.num_windows(num_clients_padded)

    # Per-window fill and commit time (latest finite member arrival)
    # without a Python loop over windows: O(C) numpy passes total, not
    # O(W·C) — the planning step is on the every-round hot path.
    win_r = window[:real]
    member = win_r >= 0
    fill = np.bincount(win_r[member], minlength=num_windows).astype(np.int32)
    commit_time = np.full(num_windows, np.inf, np.float32)
    ct = np.asarray(completion, np.float32)
    finite = member & np.isfinite(ct)
    if finite.any():
        latest = np.full(num_windows, -np.inf, np.float32)
        np.maximum.at(latest, win_r[finite], ct[finite])
        has = latest > -np.inf
        commit_time[has] = latest[has]

    score = None
    if cfg.schedule == "score":
        # Apodotiko-style contribution scores: faster clients (smaller
        # simulated completion) score higher. Normalized to mean 1 over
        # the selected cohort so the schedule reweights *within* the
        # buffer without changing the aggregate update magnitude.
        score = np.zeros(num_clients_padded, np.float32)
        sel = np.asarray(selected, bool)
        ct = np.asarray(completion, np.float32)
        pos = sel & np.isfinite(ct) & (ct > 0)
        if pos.any():
            inv = np.zeros(real, np.float32)
            inv[pos] = 1.0 / ct[pos]
            # A zero (or negative) finite completion is an instant
            # arrival: at least as fast as the fastest measured client —
            # it must land at the TOP of the score range, not fall
            # through to the floor. Non-finite completions (never
            # arrives) stay at inv=0 and clip to the floor, the slowest
            # score.
            inst = sel & np.isfinite(ct) & (ct <= 0)
            inv[inst] = inv[pos].max()
            scored = sel & np.isfinite(ct)
            mean = float(inv[scored].mean())
            if mean > 0:
                inv = inv / mean
            score[:real] = np.where(sel, np.clip(inv, 0.1, 10.0), 0.0)
        else:
            score[:real] = np.where(sel, 1.0, 0.0)

    return AsyncRoundPlan(
        config=cfg, window=window, score=score, num_windows=num_windows,
        commit_time=commit_time, fill=fill,
    )


def staleness_weights(schedule: str, alpha: float, num_windows: int,
                      max_staleness: Optional[int] = None) -> np.ndarray:
    """Numpy reference for the per-window staleness discount [W] — the
    oracle half of the on-device computation (tests/test_torch_async.py)."""
    w = np.arange(num_windows, dtype=np.float64)
    if schedule == "constant":
        sw = np.ones(num_windows)
    else:  # polynomial and score share the (1+s)^-alpha discount
        sw = (1.0 + w) ** (-float(alpha))
    if max_staleness is not None:
        sw = np.where(w > max_staleness, 0.0, sw)
    return sw.astype(np.float32)


# --------------------------------------------------------------- the round
@dataclasses.dataclass
class AsyncStats:
    """Per-round async accounting, as device tensors.

    ``commits`` — windows that actually committed (non-empty, not
    staleness-dropped); ``committed_weight`` — total aggregation weight
    across committed windows; ``dropped_stale`` — participants whose
    window exceeded ``max_staleness`` (compute spent, update discarded —
    the async analogue of stragglers); ``buffer_fill`` — [W] per-window
    aggregation weight (the buffer-depth signal)."""

    commits: torch.Tensor
    committed_weight: torch.Tensor
    dropped_stale: torch.Tensor
    buffer_fill: torch.Tensor


def check_round(core, ds, plan: AsyncRoundPlan, *, personal=None, control=None,
                personal_indices=None, completion_time=None, deadline=None) -> None:
    """What an async round refuses, with the JAX engine's messages: a
    model-parallel plan (mp > 1) first, as the JAX engine checks it."""
    if core.plan.mp > 1:
        raise ValueError(
            "buffered asynchronous rounds do not compose with a "
            "model-parallel mesh (mp > 1): the async commit scan is a "
            "manual-dp shard_map program, which XLA 0.4.x cannot "
            "partition with a >1 auto mp axis — run the async family "
            "at mp=1 (docs/performance.md has the composition matrix)"
        )
    if deadline is not None or completion_time is not None:
        raise ValueError(
            "async rounds and deadline masking are mutually exclusive "
            "(async.max_staleness is the buffered engine's lateness "
            "control; the completion-time model drives arrival order)"
        )
    if personal is not None or control is not None or personal_indices is not None:
        raise ValueError(
            "async rounds do not take personal/control state "
            "(personalized and control-variate algorithms are not "
            "supported by the buffered engine)"
        )
    acfg = plan.config
    W = int(plan.num_windows)
    if W != acfg.num_windows(ds.padded_clients):
        raise ValueError(
            f"async plan was built for a different population: "
            f"plan windows {W} != "
            f"{acfg.num_windows(ds.padded_clients)} for "
            f"{ds.padded_clients} padded clients at "
            f"M={acfg.buffer_size}"
        )
    alg = core.algorithm
    if alg.personalized or alg.control_variates:
        raise ValueError(
            f"asynchronous buffered rounds do not support the "
            f"personalized/control-variate algorithm {alg.name!r} (per-"
            f"client state would need a version per commit window)"
        )


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without waiting for the card: a copy from
    pageable memory synchronizes the host, so on a card it is made from
    pinned memory, asynchronously on the current stream."""
    t = torch.from_numpy(arr)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def window_weights(window: torch.Tensor, weight: torch.Tensor, num_windows: int):
    """``[n, W]``: each client's weight in its window's column, 0 elsewhere.
    Contracted with ``[n, ...]`` deltas it sums each window's weighted
    deltas in a fixed order."""
    cols = torch.arange(num_windows, device=window.device)
    return (window[:, None] == cols).float() * weight[:, None]


def _tree_where(pred: torch.Tensor, a, b):
    if isinstance(a, dict):
        return {k: _tree_where(pred, a[k], b[k]) for k in a}
    return torch.where(pred, a, b)


def async_round(core, state, ds, plan: AsyncRoundPlan, weight: torch.Tensor,
                steps_eff: torch.Tensor, indices: torch.Tensor, attack_scale=None,
                defense=None, clip_norm=None, trim_fraction=None, released=None):
    """The buffered round over a resident population (``ds`` this rank's
    shard), after ``FedCore.round_step`` resolved its inputs to this rank's
    rows (``weight`` after participation). The window sums and scalars
    meet over dp at the round's close as the JAX engine's do: a psum, or a
    psum_scatter onto the coordinate shards under the sharded update; a
    gathering defense re-lays the deltas with one all_to_all. ``released``
    — the clients each block releases, counted on the host (the blocks'
    ``round.block`` spans carry it); the close and the commits are one
    ``round.server_update`` span. Returns ``(state, RoundMetrics,
    AsyncStats)``, the same on every rank."""
    cfg = core.config
    acfg = plan.config
    dev = weight.device
    W = int(plan.num_windows)
    C = ds.num_clients
    rows = core.client_rows(ds)
    f32 = dict(dtype=torch.float32, device=dev)

    # Per-window staleness discount [W]: uniform within a window (staleness
    # == window index == commits since dispatch), entirely data.
    window = _to_device(np.asarray(plan.window[rows], np.int32), dev)
    max_stale = torch.full((), float(acfg.max_staleness) if acfg.max_staleness is not None
                           else _NO_MAX_STALENESS, **f32)
    widx = torch.arange(W, **f32)
    if acfg.schedule == "constant":
        sw_w = torch.ones(W, **f32)
    else:
        sw_w = torch.pow(1.0 + widx, -torch.full((), acfg.staleness_alpha, **f32))
    sw_w = torch.where(widx <= max_stale, sw_w, 0.0)

    member = window >= 0
    stale_ok = member & (window.float() <= max_stale)
    # Dropped-for-staleness participants (compute spent, update never
    # committed), counted before their weights are zeroed.
    dropped_stale = ((weight > 0) & member & ~stale_ok).sum().float()
    weight = torch.where(stale_ok, weight, 0.0)
    # Non-members sit in window 0 with weight 0.
    wclamp = torch.clamp(window, 0, W - 1).long()
    score = (_to_device(np.asarray(plan.score[rows], np.float32), dev)
             if acfg.schedule == "score" else None)

    sums = core._round_sums(state.params, C, clipping=defense is not None,
                            gathering=defense is not None and defense.gathers_deltas,
                            windows=W)
    for s in range(0, C, cfg.block_clients):
        blk = slice(s, s + cfg.block_clients)
        core._train_block(
            sums, state.params, blk, ds.x[blk], ds.y[blk], steps_eff[blk], indices[blk],
            weight[blk], None if attack_scale is None else attack_scale[blk],
            clip_norm=clip_norm, window=wclamp[blk],
            score=None if score is None else score[blk],
            released=None if released is None else released[s // cfg.block_clients],
        )
    with default_tracer().span("round.server_update"):
        return _close_round(core, state, sums, defense, trim_fraction, wclamp, sw_w,
                            dropped_stale)


def _close_round(core, state, sums, defense, trim_fraction, wclamp: torch.Tensor,
                 sw_w: torch.Tensor, dropped_stale: torch.Tensor):
    """:func:`async_round`'s close, once its blocks are summed: the window
    aggregates meet over dp, and the commits run in window order."""
    from olearning_sim_tpu_torch.engine.defense import (
        distance_scores,
        place_coordinate_shard,
        robust_aggregate,
        shard_client_deltas,
    )
    from olearning_sim_tpu_torch.engine.fedcore import RoundMetrics, ServerState
    from olearning_sim_tpu_torch.parallel import collectives

    W = int(sw_w.shape[0])
    dev = sw_w.device
    group = core.group
    shard_update = core.config.shard_server_update
    f32 = dict(dtype=torch.float32, device=dev)
    keys = list(state.params)
    # Per-window aggregates feeding the commits: robust statistics on
    # coordinate shards, or the weighted window sums normalized by their
    # (global) weight.
    anomaly_score = None
    stack = None
    buf = sums.buf
    if sums.gathered is not None:
        gathered, w_loc = sums.gathered, sums.gathered_w
        w_all, win_all = collectives.all_gather([w_loc, wclamp], group)
        shards = shard_client_deltas(gathered, group)
        robust = defense.aggregator in ("trimmed_mean", "median")
        scores = torch.zeros(w_all.shape[0], **f32)
        centers = []
        for w in range(W):
            mask_w = (win_all == w) & (w_all > 0)
            center = robust_aggregate(shards, mask_w,
                                      defense.aggregator if robust else "median",
                                      trim_fraction)
            if defense.score_enabled:
                scores = torch.where(mask_w, distance_scores(shards, center, mask_w, group),
                                     scores)
            centers.append(center)
        if defense.score_enabled:
            anomaly_score = scores
        if robust:
            # [W, P_pad/dp] coordinate shards per leaf.
            stack = {k: torch.stack([c[k] for c in centers]) for k in keys}
            if not shard_update:
                full = place_coordinate_shard(stack, group)
                stack = {k: full[k][:, :p.numel()].reshape((W,) + p.shape)
                         for k, p in state.params.items()}
        else:
            # The score-only defense keeps the weighted mean: the window
            # buffer is rebuilt from this rank's gathered clipped deltas.
            onehot = window_weights(wclamp, w_loc, W)
            buf = {k: torch.tensordot(onehot, g, dims=([0], [0])) for k, g in gathered.items()}
        del gathered, shards, centers
        sums.gathered = None
    scalars = [sums.buf_w, sums.sum_loss, sums.sum_w, sums.count, dropped_stale]
    if sums.n_clip is not None:
        scalars.append(sums.n_clip)
    dense = [buf[k] for k in keys] if stack is None and not shard_update else []
    reduced = collectives.psum(scalars + dense, group)
    buf_w, sum_loss, sum_w, count, dropped_stale = reduced[:5]
    n_clip = reduced[5] if sums.n_clip is not None else None
    if stack is None:
        denom = torch.clamp(buf_w, min=1e-8)
        if shard_update:
            flat = collectives.psum_scatter(
                [core._flat_rows(buf[k]) for k in keys],
                group)
            stack = {k: f / denom[:, None] for k, f in zip(keys, flat)}
        else:
            stack = {k: b / denom.reshape((W,) + (1,) * (b.dim() - 1))
                     for k, b in zip(keys, reduced[len(scalars):])}
    del buf

    # The commits: W server-optimizer steps in window order on the
    # staleness-discounted pseudo-gradient, each kept only where its window
    # holds weight and its discount is positive. Under the sharded update
    # they run on this rank's coordinate shard.
    opt = core.algorithm.server_optimizer
    params = state.params
    p = core._my_shard(core._flat(params)) if shard_update else params
    # Adam's step count becomes a device integer (int32, as optax keeps it):
    # whether a commit counts is decided on the device.
    op = {k: torch.full((), v, dtype=torch.int32, device=dev) if isinstance(v, int) else v
          for k, v in state.opt_state.items()}
    gates = []
    for w in range(W):
        gate = (buf_w[w] > 0) & (sw_w[w] > 0)
        pseudo = {k: (-(sw_w[w] * stack[k][w])).to(p[k].dtype) for k in p}
        updates, new_op = opt.update(pseudo, op)
        p = {k: torch.where(gate, p[k] + updates[k], p[k]) for k in p}
        op = _tree_where(gate, new_op, op)
        gates.append(gate)
    new_params = core._stitch(p, params) if shard_update else p

    zero = torch.zeros((), **f32)
    metrics = RoundMetrics(
        mean_loss=sum_loss / torch.clamp(sum_w, min=1e-8),
        weight_sum=sum_w,
        clients_trained=count,
        client_loss=collectives.all_gather([torch.cat(sums.client_loss)], group)[0],
        personal_loss=zero,
        stragglers=zero,
        anomaly_score=anomaly_score if anomaly_score is not None else zero,
        clipped=n_clip if n_clip is not None else zero,
    )
    stats = AsyncStats(
        commits=torch.stack(gates).float().sum(),
        committed_weight=(buf_w * (sw_w > 0)).sum(),
        dropped_stale=dropped_stale,
        buffer_fill=buf_w,
    )
    new_state = ServerState(params=new_params, opt_state=op,
                            round_idx=state.round_idx + 1, seed=state.seed)
    return new_state, metrics, stats
