"""FedCore — the federated round engine, data-parallel over ranks.

The port of the round program of the JAX package's ``engine/fedcore.py``::

    round_step = for each block of ``block_clients`` of this rank's clients:
                     vmap over clients: masked local SGD, max_local_steps steps
                     finiteness gate, weighted delta sum
                     (SCAFFOLD: control refresh; Ditto: the personal branch)
                 -> psum of the sums over dp (psum_scatter under the
                    sharded server update)
                 -> server optimizer on the negative mean delta

Data parallelism is the JAX engine's ``shard_map`` over ``dp`` with one
process per rank (:class:`~olearning_sim_tpu_torch.parallel.mesh.MeshPlan`,
one rank per card). Every rank builds the same full host arrays from the
seed and places only its contiguous shard of clients
(:meth:`ClientDataset.shard`, JAX's ``P("dp")`` layout); the round's sums
meet once, at its close, in the collectives of
:mod:`~olearning_sim_tpu_torch.parallel.collectives`. Every per-client
argument of :meth:`FedCore.round_step` (participation, step counts,
completion times, attack scales, minibatch indices) is over the whole
padded population and is sliced here; per-client state (SCAFFOLD's c_i,
Ditto's personal params) is held by rank, over the rank's clients only;
the per-client metrics come back gathered, over the whole population, on
every rank. A plan over an uninitialised ``torch.distributed`` is a world
of one whose collectives are the identity.

Model parallelism (the plan's ``mp`` or ``pp`` axis; the JAX engine's
GSPMD-auto round at mp > 1 and its pipelined round at pp > 1): each client's
model is split over the model group's ranks, every rank of which trains
the same clients. Under mp the per-client carry (and SCAFFOLD's c_i,
Ditto's personal params) is this rank's tensor-parallel shards
(:mod:`~olearning_sim_tpu_torch.parallel.tp`), the blocks run on them
with Megatron's collectives, the finiteness verdict, the clip's norm and
FedProx's pull are taken over the whole model, and the round's sums meet
over dp in the shard layout and are gathered over mp; under pp the carry
is this stage's layout (:mod:`~olearning_sim_tpu_torch.engine.pp_rounds`).
The server state keeps the model's layout on every rank (the update runs
on the whole mean delta, or on 1/(dp * mp) of its flat coordinates under
the sharded update), so checkpoints, export and warm starts do not see
the model axes. mp refuses what the JAX engine's refuses (gathering
defenses, async and streamed rounds), pp everything but the plain FedOpt
round.

Heterogeneity is masking, as in the JAX engine: step ``i`` of a client is
active iff ``i < num_steps[c]``; minibatch indices are drawn in
``[0, num_samples[c])``; aggregation weights are 0 for padded or
non-participating clients. Clients of a block are batched with
``torch.func.vmap(grad(functional_call))``.

The algorithm's options live in the same round, as in the JAX engine:

- FedProx (``prox_mu``): ``0.5 * mu * ||p - w||^2`` joins the local loss;
- SCAFFOLD (``control_variates``): local gradients become ``g + c - c_i``;
  c_i refreshes by option II for participants, and the server control
  moves by ``|S|/N`` times the weighted mean refresh, N = ``ds.population``
  (:class:`ControlState`, :meth:`FedCore.init_control`);
- Ditto (``personalized``): per-client personal params train beside the
  global ones with an L2 pull toward them, gated by participation
  (:class:`PersonalState`, :meth:`FedCore.init_personal`,
  :meth:`FedCore.evaluate_personal`);
- ``FedCoreConfig.carry_dtype``: the local-SGD carry is cast to it (bf16
  halves the bytes a step moves), stepped in it, and the delta is taken in
  f32 after casting back;
- a model with an auxiliary loss (``sows_aux_loss``: moe_text's Switch
  load balancing) adds ``aux_loss_weight * aux`` to every local step's
  loss, in both branches, as the JAX engine's ``apply_aux_fn`` does;
  ``evaluate`` scores the logits alone.

The round's robustness options, as in the JAX engine (all device tensors,
no host sync; each off path is the plain round, bitwise):

- deadline rounds (``completion_time``, ``deadline``): a client whose
  simulated completion time is past the deadline gets zero weight and is
  counted in ``RoundMetrics.stragglers``;
- client attacks (``attack_scale``): each client's delta is multiplied by
  its scale before the finiteness gate (:func:`_attack_deltas`);
- the defense (``defense``, :mod:`~olearning_sim_tpu_torch.engine.defense`):
  per-client L2 clipping (:func:`_clip_client_deltas`), a trimmed-mean or
  median aggregate in place of the weighted mean, and Krum-style anomaly
  scores. A gathering defense keeps every client's gated, clipped f32 delta
  in a ``[C, ...]`` buffer per parameter for the round.

``round_step(..., async_plan=...)`` runs the buffered asynchronous round
instead (``engine/async_rounds.py``): the same block body, with each
client's weighted delta summed into its commit window, then one server
commit per window. ``FedCoreConfig.shard_server_update`` keeps the server
optimizer's state over flat padded coordinates, 1/(dp * mp) of them per rank, and
runs the update on this rank's coordinate shard, as the JAX engine's
sharded update does.

A population too large for the device streams: :meth:`FedCore.stream_round`
walks a host-resident ``HostClientStore`` in stream blocks (each rank its
own rows of each block), staged double buffered (``engine/staging.py``),
through the same block body
(:meth:`FedCore._train_block`) and round close (:meth:`FedCore._finish_round`)
as :meth:`FedCore.round_step`, so the two agree bit for bit at the same
padded size.

Randomness is explicit: the minibatch indices ``[C, max_local_steps,
batch_size]`` come from :meth:`FedCore.round_generator`, a generator
seeded from the state's ``seed`` and ``round_idx`` alone, as JAX folds the
round counter into its key; or from the caller (``round_step(...,
indices=...)``). Ditto's personal branch draws from a second stream of the
same round (JAX salts that stream away from the global one), or takes
``personal_indices=``. So the state is tensors and integers only, and a
round resumed from a checkpoint or a model file draws what it drew before.
The draw is over the whole padded population on every rank, then sliced,
so a client's stream does not depend on dp. The port does not reproduce
JAX's threefry stream; the parity tests hand both engines the same
indices instead.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call, grad_and_value, vmap

from olearning_sim_tpu_torch.device import resolve_device
from olearning_sim_tpu_torch.engine import async_rounds, pp_rounds
from olearning_sim_tpu_torch.engine.algorithms import Algorithm
from olearning_sim_tpu_torch.engine import defense as defense_mod
from olearning_sim_tpu_torch.engine.client_data import ClientDataset
from olearning_sim_tpu_torch.engine.defense import DefenseConfig, distance_scores, robust_aggregate
from olearning_sim_tpu_torch.engine.staging import BlockStager
from olearning_sim_tpu_torch.parallel import collectives, pipeline
from olearning_sim_tpu_torch.parallel.mesh import MeshPlan, make_mesh_plan, pad_to_multiple
from olearning_sim_tpu_torch.parallel.tp import (
    shard_params,
    tp_param_specs,
    unshard_params,
    warn_if_unsharded,
)
from olearning_sim_tpu_torch.telemetry import default_tracer, instrument

Params = Dict[str, torch.Tensor]

_DTYPE_ALIASES = {"bf16": torch.bfloat16, "f32": torch.float32,
                  "fp32": torch.float32, "f16": torch.float16}


def parse_float_dtype(knob: str, value) -> torch.dtype:
    """A validated dtype knob (``carry_dtype`` / ``personal_dtype``): a
    floating ``torch.dtype``, or its name (``"bfloat16"``, ``"float32"``)
    or the shorthands ``bf16``/``f32``/``fp32``/``f16``. Non-floating dtypes
    are refused: these knobs select a precision, and an integer carry would
    silently corrupt SGD."""
    dt = _DTYPE_ALIASES.get(value, getattr(torch, value, None)) \
        if isinstance(value, str) else value
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"fedcore.{knob}: not a dtype: {value!r}")
    if not dt.is_floating_point:
        raise ValueError(f"fedcore.{knob} must be a floating dtype, got {dt}")
    return dt


@dataclasses.dataclass(frozen=True)
class FedCoreConfig:
    batch_size: int = 32
    max_local_steps: int = 10
    # Clients vmapped at once; the loop over blocks bounds peak memory
    # (activations scale with block_clients * batch_size, not population).
    block_clients: int = 64
    eval_batch_size: int = 1024
    # Storage dtype of Ditto's per-client personal params; None = the
    # global params' (f32). bf16 halves their resident bytes.
    personal_dtype: Optional[torch.dtype] = None
    # Minibatch realization. "gather": gather the drawn rows.
    # "multiplicity": weight the client's full local set by how often each
    # row was drawn — the same gradient and loss for the same indices (up
    # to float summation order), without a gather. "auto" picks
    # multiplicity when n_local <= 2 * batch_size.
    sample_mode: str = "auto"
    # Dtype of the local-SGD carry (per-client params while stepping); None
    # = the global params' (f32). bf16 changes numerics: the per-round
    # delta is quantized to bf16 steps.
    carry_dtype: Optional[torch.dtype] = None
    # Weight on a model's auxiliary loss (Switch-MoE load balancing); read
    # only for a model that returns one (``sows_aux_loss``).
    aux_loss_weight: float = 0.01
    # The cross-replica sharded server update (arXiv 2004.13336), as the
    # JAX engine lays it out: the server optimizer's state is one flat
    # vector per parameter, padded to a multiple of dp * mp and split into
    # dp contiguous shards, one per rank; the round's sums are
    # reduce-scattered onto them and each rank updates its shard. Every
    # server optimizer is elementwise, so the params are the replicated
    # update's, bit for bit; they keep their tree layout on every rank
    # (eval, export and model files see it).
    shard_server_update: bool = False

    def __post_init__(self):
        for fld in ("batch_size", "max_local_steps", "block_clients",
                    "eval_batch_size"):
            v = getattr(self, fld)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"FedCoreConfig.{fld} must be an int >= 1, got {v!r}")
        if self.sample_mode not in ("auto", "gather", "multiplicity"):
            raise ValueError(f"unknown sample_mode {self.sample_mode!r}")
        for fld in ("carry_dtype", "personal_dtype"):
            if getattr(self, fld) is not None:
                object.__setattr__(self, fld, parse_float_dtype(fld, getattr(self, fld)))

    def use_multiplicity(self, n_local: int) -> bool:
        if self.sample_mode == "auto":
            return n_local <= 2 * self.batch_size
        return self.sample_mode == "multiplicity"

    @classmethod
    def from_dict(cls, obj: dict) -> "FedCoreConfig":
        """Engine-params JSON shape (``{"fedcore": {...}}``); unknown keys
        are rejected so that a typo fails at submit time, not mid-round.
        Dtype knobs go through :func:`parse_float_dtype`; ``null`` keeps
        the f32 default.

        The JAX engine's ``step_unroll``/``block_unroll`` are accepted,
        checked as there, and dropped: they are ``lax.scan`` unroll hints
        (ints >= 1) with no counterpart in loops that eager PyTorch runs in
        Python. ``shard_server_update`` is kept, as JAX keeps it."""
        if not isinstance(obj, dict):
            raise TypeError(
                f"fedcore config must be a JSON object, got {type(obj).__name__}"
            )
        obj = dict(obj)
        for k in ("step_unroll", "block_unroll"):
            v = obj.pop(k, None)
            if v is not None and int(v) < 1:
                raise ValueError(f"FedCoreConfig.{k} must be an int >= 1, got {v!r}")
        # The refusal names JAX's keys, the unroll hints among them, so that
        # both packages' submit validation answers a typo alike.
        known = {f.name for f in dataclasses.fields(cls)} | {"step_unroll", "block_unroll"}
        unknown = sorted(set(obj) - known)
        if unknown:
            raise ValueError(
                f"unknown fedcore config keys: {unknown} (known: {sorted(known)})"
            )
        kw: dict = {}
        for k in ("batch_size", "max_local_steps", "block_clients", "eval_batch_size"):
            if obj.get(k) is not None:
                kw[k] = int(obj[k])
        if obj.get("sample_mode") is not None:
            kw["sample_mode"] = str(obj["sample_mode"])
        if obj.get("aux_loss_weight") is not None:
            kw["aux_loss_weight"] = float(obj["aux_loss_weight"])
        if obj.get("shard_server_update") is not None:
            kw["shard_server_update"] = bool(obj["shard_server_update"])
        for k in ("carry_dtype", "personal_dtype"):
            if obj.get(k) is not None:
                kw[k] = parse_float_dtype(k, obj[k])
        return cls(**kw)


@dataclasses.dataclass
class ServerState:
    """Global FL state carried across rounds."""

    params: Params
    opt_state: dict
    round_idx: int
    seed: int  # of the minibatch-index streams (FedCore.round_generator)


@dataclasses.dataclass
class PersonalState:
    """Ditto per-client personal params: every tensor ``[C, ...]`` in
    ``FedCoreConfig.personal_dtype``."""

    params: Params


@dataclasses.dataclass
class ControlState:
    """SCAFFOLD control variates: per-client ``client_controls`` c_i
    ``[C, ...]`` and the server control c, both f32."""

    client_controls: Params
    server_control: Params


@dataclasses.dataclass
class RoundMetrics:
    mean_loss: torch.Tensor        # weight-averaged local training loss
    weight_sum: torch.Tensor       # total aggregation weight (participants)
    clients_trained: torch.Tensor  # number of clients with weight > 0
    # Per-client mean local loss [C]; NaN for a client that ran no step.
    client_loss: torch.Tensor
    # Ditto: weight-averaged personal-branch loss over participants whose
    # branch stayed finite (divided by the global weight sum); 0 otherwise.
    personal_loss: torch.Tensor
    # Participants whose simulated completion time missed the deadline (0
    # without one): their update existed but arrived too late.
    stragglers: torch.Tensor = dataclasses.field(default_factory=lambda: torch.zeros(()))
    # Defense: per-client [C] distance-to-median scores when scoring is on,
    # a scalar 0 otherwise; participants whose delta was clipped.
    anomaly_score: torch.Tensor = dataclasses.field(default_factory=lambda: torch.zeros(()))
    clipped: torch.Tensor = dataclasses.field(default_factory=lambda: torch.zeros(()))


@dataclasses.dataclass
class StreamStats:
    """Host-side accounting of one block-streamed round
    (:meth:`FedCore.stream_round`)."""

    blocks: int                  # stream blocks executed
    block_rows: int              # clients per stream block
    rows: int                    # padded population walked
    # Host->device bytes staged: every staged tensor in the port's dtypes
    # (int64 labels and steps, the minibatch indices too).
    transfer_bytes: int
    # Wall seconds the round's host thread waited for staged blocks.
    host_transfer_s: float
    # Estimated fraction of the steady-state staging hidden behind the
    # previous block's launches: 1 - (waits after the first block / the
    # same bytes at the first (unoverlapped) block's rate). None for a
    # single-block round.
    overlap_fraction: Optional[float]
    # Params + server optimizer state + the partial aggregates + two
    # staged blocks: the O(block) device-memory claim as a number.
    peak_hbm_bytes_est: int
    state_bytes: int             # host-resident per-client state bytes
    # Wall seconds gathering, casting and issuing copies, on whichever thread.
    staging_s: float = 0.0


def _seed_of(seed: int, *stream: int) -> int:
    return int(np.random.SeedSequence([seed, *stream]).generate_state(1, np.uint64)[0])


def _tree_nbytes(tree) -> int:
    """Bytes of every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(v) for v in tree)
    return 0


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


# A disabled clip as the JAX engine passes it: a finite f32 whose square
# overflows to inf, so ``norm2 > clip * clip`` is never true.
CLIP_DISABLED = 3.0e38


def _attack_deltas(deltas: Params, batk: torch.Tensor) -> Params:
    """Byzantine update attack: the client trains honestly but ships a
    transformed delta (sign_flip = -1, scale = factor). A benign scale of
    exactly 1.0 is a bitwise no-op, so an all-ones attack vector gives the
    attack-free round."""
    return {k: d * _bcast(batk.to(d.dtype), d) for k, d in deltas.items()}


def _clip_client_deltas(d32: Params, clip_norm: torch.Tensor, split=(), group=None):
    """Per-client L2 norm clip over a block of f32 deltas: a delta beyond
    the clip sphere is rescaled onto it. A where-select (not a multiply by
    1), so an unclipped delta, and the whole round under
    :data:`CLIP_DISABLED`, stays bitwise untouched. The leaves named in
    ``split`` are this rank's shards over ``group`` (tensor parallelism):
    their squares are summed over it, so the norm is the whole delta's.
    Returns ``(clipped_d32, too_big)``."""
    norm2 = part = None
    for k, v in d32.items():
        sq = v.reshape(v.shape[0], -1).square().sum(dim=1)
        if k in split:
            part = sq if part is None else part + sq
        else:
            norm2 = sq if norm2 is None else norm2 + sq
    if part is not None:
        part = collectives.psum([part], group)[0]
        norm2 = part if norm2 is None else norm2 + part
    too_big = norm2 > clip_norm * clip_norm
    scale = torch.where(too_big, clip_norm / torch.sqrt(norm2), 1.0)
    clipped = {k: torch.where(_bcast(too_big, d), d * _bcast(scale, d), d)
               for k, d in d32.items()}
    return clipped, too_big


def _flat_pad_leaf(p: torch.Tensor, multiple: int) -> torch.Tensor:
    """A leaf flattened and zero-padded to a multiple of ``multiple``: the
    coordinate layout of the sharded server update (the JAX engine's robust
    aggregation over dp pads identically)."""
    flat = p.reshape(-1)
    target = pad_to_multiple(flat.shape[0], multiple)
    if target != flat.shape[0]:
        flat = F.pad(flat, (0, target - flat.shape[0]))
    return flat


def _dp_shardable(leaf, dp: int) -> bool:
    """Whether an optimizer-state leaf carries per-coordinate state (flat,
    dp-divisible: sharded over dp) or is a scalar kept whole on every
    device, like Adam's step count."""
    shape = getattr(leaf, "shape", ())
    return len(shape) >= 1 and shape[0] > 0 and shape[0] % dp == 0


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map_paths(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _map_client_state(tree, fn):
    """``fn`` over the per-client leaves of a state dataclass or dict:
    :class:`PersonalState`'s params, :class:`ControlState`'s client
    controls (its server control is replicated and stays)."""
    if isinstance(tree, PersonalState):
        return PersonalState(_map_client_state(tree.params, fn))
    if isinstance(tree, ControlState):
        return ControlState(_map_client_state(tree.client_controls, fn),
                            tree.server_control)
    keys = list(tree)
    return dict(zip(keys, fn(keys, [tree[k] for k in keys])))


def _finite_client_mask(losses: torch.Tensor, deltas: Params) -> torch.Tensor:
    """[block] bool — clients whose local training stayed finite (finite
    loss AND every delta finite). A diverged client contributes nothing to
    the aggregate: without the gate one NaN client poisons the global
    params even at weight 0 (0 * NaN is NaN)."""
    ok = torch.isfinite(losses)
    for d in deltas.values():
        ok = ok & torch.isfinite(d.reshape(d.shape[0], -1)).all(dim=1)
    return ok


def _defense_scalars(defense: DefenseConfig, dev):
    """The defense's clip norm and trim fraction as f32 device scalars (a
    disabled clip as :data:`CLIP_DISABLED`). Host scalars become device
    tensors through a fill launch, not a copy from host memory: the stream
    is never synchronized."""
    clip = defense.clip_norm
    if clip is None or not np.isfinite(clip):
        clip = CLIP_DISABLED
    return (torch.full((), clip, dtype=torch.float32, device=dev),
            torch.full((), defense.trim_fraction, dtype=torch.float32, device=dev))


@dataclasses.dataclass
class _RoundSums:
    """A round's running aggregates, carried from block to block."""

    sum_delta: Params
    sum_w: torch.Tensor
    sum_loss: torch.Tensor
    count: torch.Tensor
    sum_ploss: torch.Tensor
    sum_dc: Optional[Params]          # SCAFFOLD's weighted control refresh
    n_clip: Optional[torch.Tensor]    # with a defense: clipped participants
    new_client_state: Dict[str, list]  # per block: new c_i or Ditto's v_k
    client_loss: list = dataclasses.field(default_factory=list)
    gathered: Optional[Params] = None  # a gathering defense's [C, ...] deltas
    gathered_w: Optional[torch.Tensor] = None
    buf: Optional[Params] = None              # an async round's [W, ...] window sums
    buf_w: Optional[torch.Tensor] = None      # and their [W] weights


class FedCore:
    """Owns one (model, algorithm, config) triple's round and eval steps,
    on this rank of ``plan`` (default: every rank of the default group, or
    a world of one). ``microbatches`` — the GPipe microbatch count of a
    pipelined plan (``plan.pp > 1``; default pp)."""

    def __init__(self, model: torch.nn.Module, algorithm: Algorithm,
                 config: FedCoreConfig = FedCoreConfig(),
                 plan: Optional[MeshPlan] = None,
                 microbatches: Optional[int] = None):
        # The module only supplies structure: every call passes its
        # parameters through functional_call, so it may live on "meta".
        if algorithm.personalized and algorithm.control_variates:
            raise ValueError(
                "personalized and control_variates are mutually exclusive "
                "(both claim the per-client state slot)"
            )
        if algorithm.control_variates and algorithm.local_lr <= 0.0:
            raise ValueError(
                "control_variates needs algorithm.local_lr > 0 (the "
                "option-II refresh divides by K * local_lr)"
            )
        self.model = model
        self.algorithm = algorithm
        self.config = config
        self.plan = plan if plan is not None else make_mesh_plan()
        if self.plan.sp != 1 or self.plan.ep != 1:
            raise ValueError(
                f"the round runs over a dp x mp or dp x pp plan; got "
                f"sp={self.plan.sp} ep={self.plan.ep} (sequence and expert "
                f"parallelism are the long-context and ep_train_step paths')"
            )
        if microbatches is not None and self.plan.pp <= 1:
            raise ValueError(
                "microbatches only applies to pipeline parallelism — build "
                "the plan with make_mesh_plan(pp=...) (or the engine-params "
                "{'parallel': {'pp': N}} block)"
            )
        # The dp axis: its group (None: a world of one with no collective),
        # its size and this rank's place on it.
        self.group = self.plan.dp_group
        self.dp = self.plan.dp
        self.dp_rank = self.plan.dp_rank
        # The model axes. Under mp the per-client carry is this rank's
        # tensor-parallel shards (tp_specs: the split dimension per leaf,
        # None when no leaf splits and every rank computes whole); under pp
        # it is this stage's layout (engine/pp_rounds.py).
        self.mp, self.mp_group, self.mp_rank = self.plan.mp, self.plan.mp_group, self.plan.mp_rank
        self.tp_specs = None
        self.tp_sharded_ratio = 0.0
        if self.mp > 1:
            shapes = {k: v.shape for k, v in model.named_parameters()}
            specs = tp_param_specs(shapes, self.mp, getattr(model, "heads", None))
            self.tp_sharded_ratio = warn_if_unsharded(shapes, specs, self.mp)
            if any(d is not None for d in specs.values()):
                self.tp_specs = specs
        self._split = frozenset(k for k, d in (self.tp_specs or {}).items() if d is not None)
        self._pp = None
        if self.plan.pp > 1:
            M = pp_rounds.validate_pp_build(model, self.plan, config, algorithm, microbatches)
            self._pp = pipeline.PipelinedBody(model, self.plan, M)
        # The group whose ranks hold one client's model between them.
        self.model_group = (self.mp_group if self.tp_specs is not None
                            else self.plan.pp_group if self._pp is not None else None)
        # A model with an auxiliary loss (moe_text) says so; its forward
        # then takes return_aux=True and returns (logits, aux).
        self.has_aux = bool(getattr(model, "sows_aux_loss", False))
        # Module skeletons per thread (_module): functional_call swaps
        # parameters into the module it is given, so two threads that share
        # this core must not share one.
        self._local = threading.local()
        # The sharded server update pads each flat parameter to a multiple
        # of dp * mp and keeps 1/(dp * mp) of the coordinates per rank, the
        # JAX engine's P(("dp", "mp")): shard dp_rank * mp + mp_rank, over
        # the world (ranks are dp-major). Which leaves of its flat optimizer
        # state are per coordinate (sharded) and which stay whole on every
        # rank (Adam's count) is decided once, on the global template, as
        # the JAX engine decides it.
        self._shard_pad = self.dp * self.mp
        self._coord_index = self.dp_rank * self.mp + self.mp_rank
        self._coord_group = self.group if self.mp == 1 else self.plan.world_group
        self.opt_sharded = None
        if config.shard_server_update:
            template = algorithm.server_optimizer.init(
                self._flat(dict(model.named_parameters())))
            self.opt_sharded = _tree_map(lambda leaf: _dp_shardable(leaf, self._shard_pad),
                                         template)

    def _module(self) -> torch.nn.Module:
        """This thread's skeleton of the model: ``functional_call`` swaps
        the parameters it is given into the module for the call, so each
        thread gets its own copy (made on first use) and a round on one
        thread never sees another's parameters."""
        m = getattr(self._local, "model", None)
        if m is None:
            m = self._local.model = copy.deepcopy(self.model)
        return m

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int = 0, device="cuda",
                   params: Optional[Params] = None) -> ServerState:
        """Fresh server state on ``device``: parameters drawn from ``seed``
        (or the given ``params``, copied), a zero server-optimizer state,
        and ``seed`` for the minibatch-index streams."""
        dev = resolve_device(device)
        if params is None:
            gen = torch.Generator().manual_seed(_seed_of(seed, 0))
            params = self.model.init_params(gen)
        params = {k: v.detach().to(dev, torch.float32).clone() for k, v in params.items()}
        # Under shard_server_update the optimizer state is initialised over
        # this rank's shard of the flat padded coordinates (zeros, as the
        # replicated init's).
        return ServerState(
            params=params,
            opt_state=self.algorithm.server_optimizer.init(
                self._my_shard(self._flat(params)) if self.config.shard_server_update
                else params),
            round_idx=0,
            seed=int(seed),
        )

    def init_personal(self, state: ServerState, num_clients: int) -> PersonalState:
        """Ditto personal params for ``num_clients`` (padded) clients, each
        starting at the current global model, in ``config.personal_dtype``
        (under mp, this rank's shards of the split leaves, as the JAX
        engine shards them over mp)."""
        dt = self.config.personal_dtype
        return PersonalState({
            k: p.to(dt or p.dtype).unsqueeze(0).expand((num_clients,) + p.shape).contiguous()
            for k, p in self._to_carry(state.params).items()})

    def init_control(self, state: ServerState, num_clients: int) -> ControlState:
        """Zero SCAFFOLD controls: c_i ``[num_clients, ...]`` (under mp,
        this rank's shards) and c (whole), f32."""
        return ControlState(
            client_controls={k: torch.zeros((num_clients,) + p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in self._to_carry(state.params).items()},
            server_control={k: torch.zeros_like(p, dtype=torch.float32)
                            for k, p in state.params.items()},
        )

    def _to_carry(self, params: Params) -> Params:
        """The model's params in this rank's carry layout: its tensor-parallel
        shards (views) under mp, its stage layout under pp, else themselves."""
        if self._pp is not None:
            return self._pp.to_local(params)
        if self.tp_specs is not None:
            return shard_params(params, self.tp_specs, self.mp, self.mp_rank)
        return params

    def _from_carry(self, local: Params) -> Params:
        """The inverse of :meth:`_to_carry` (a collective over the model group):
        carry-layout tensors back in the model's layout on every rank."""
        if self._pp is not None:
            return self._pp.to_full(local)
        if self.tp_specs is not None:
            return unshard_params(local, self.tp_specs, self.mp_group)
        return local

    def _agree_ok(self, ok: torch.Tensor) -> torch.Tensor:
        """A finiteness verdict ``[block]`` taken over every rank holding a
        piece of each client's model: a non-finite value in one rank's shard
        or stage fails the client on all of them."""
        if self.model_group is None:
            return ok
        return collectives.pmax([(~ok).to(torch.int32)], self.model_group)[0] == 0

    def _forward_kwargs(self) -> dict:
        return {"mp_group": self.mp_group} if self.tp_specs is not None else {}

    def _flat(self, tree: Params) -> Params:
        """Each tensor flattened and padded to the sharded update's layout."""
        return {k: _flat_pad_leaf(v, self._shard_pad) for k, v in tree.items()}

    def _flat_rows(self, stacked: torch.Tensor) -> torch.Tensor:
        """A stack ``[n, ...]`` as ``[n, flat padded]`` rows."""
        return torch.stack([_flat_pad_leaf(row, self._shard_pad) for row in stacked])

    def _unflat(self, flat: Params, like: Params) -> Params:
        """Flat padded tensors back in ``like``'s shapes."""
        return {k: flat[k][:v.numel()].reshape(v.shape) for k, v in like.items()}

    def _my_shard(self, flat: Params) -> Params:
        """This rank's contiguous 1/(dp * mp) of each flat padded tensor's last
        axis: the coordinate shard the sharded update owns."""
        def one(f):
            n = f.shape[-1] // self._shard_pad
            return f[..., self._coord_index * n:(self._coord_index + 1) * n]
        return {k: one(f) for k, f in flat.items()}

    def _stitch(self, shards: Params, like: Params) -> Params:
        """Every rank's coordinate shards stitched into ``like``'s shapes
        (the JAX engine's ``place_coordinate_shard``)."""
        return self._unflat(defense_mod.place_coordinate_shard(shards, self._coord_group),
                            like)

    def _server_update(self, params: Params, pseudo_grad: Params, opt_state):
        """The server optimizer's step on a pseudo-gradient: ``(new_params,
        opt_state)``, ``params + updates`` as ``optax.apply_updates``. Under
        ``shard_server_update`` the pseudo-gradient is this rank's
        coordinate shard (:meth:`_my_shard` of the flat padded layout): the
        step runs on the shard, with the optimizer state sharded alike, and
        the new params are stitched from every rank's shard."""
        opt = self.algorithm.server_optimizer
        if not self.config.shard_server_update:
            updates, opt_state = opt.update(pseudo_grad, opt_state)
            return {k: p + updates[k] for k, p in params.items()}, opt_state
        mine = self._my_shard(self._flat(params))
        updates, opt_state = opt.update(pseudo_grad, opt_state)
        new = {k: f + updates[k] for k, f in mine.items()}
        return self._stitch(new, params), opt_state

    def _is_sharded(self, path) -> bool:
        node = self.opt_sharded
        for k in path:
            node = node[k]
        return bool(node)

    def full_opt_state(self, opt_state):
        """The server optimizer state in its full layout: under the sharded
        update every per-coordinate leaf gathered from its rank shards into
        the flat padded vector (a collective: every rank calls it); the
        state itself otherwise. What a checkpoint holds."""
        if not self.config.shard_server_update or self._coord_group is None:
            return opt_state
        shards = {}

        def visit(path, leaf):
            if self._is_sharded(path):
                shards[path] = leaf
            return leaf

        _map_paths(opt_state, visit)
        full = dict(zip(shards, collectives.all_gather(list(shards.values()),
                                                       self._coord_group, dim=-1)))
        return _map_paths(opt_state, lambda path, leaf: full.get(path, leaf))

    def local_opt_state(self, opt_state):
        """The inverse of :meth:`full_opt_state`: this rank's shard of each
        per-coordinate leaf of a full-layout state."""
        if not self.config.shard_server_update or self._coord_group is None:
            return opt_state
        return _map_paths(opt_state, lambda path, leaf: self._my_shard({"": leaf})[""].clone()
                          if self._is_sharded(path) else leaf)

    def client_rows(self, ds: ClientDataset) -> slice:
        """The rows of the whole padded population that ``ds`` (this rank's
        shard) holds."""
        return slice(ds.offset, ds.offset + ds.num_clients)

    def gather_clients(self, tree):
        """Per-client state held by rank (``[clients of this rank, ...]``
        tensors in a dict or a state dataclass; under mp, this rank's
        shards) gathered over the whole padded population, whole, on every
        rank (a collective)."""
        def whole(keys, leaves):
            leaves = collectives.all_gather(leaves, self.group)
            if self.tp_specs is None:
                return leaves
            full = unshard_params(dict(zip(keys, leaves)), self.tp_specs, self.mp_group, lead=1)
            return [full[k] for k in keys]
        return _map_client_state(tree, whole)

    def local_clients(self, tree, ds: ClientDataset):
        """The inverse of :meth:`gather_clients`: this rank's rows (and
        shards) of whole-population per-client state."""
        rows = self.client_rows(ds)

        def mine(keys, leaves):
            local = {k: v[rows] for k, v in zip(keys, leaves)}
            if self.tp_specs is not None:
                local = shard_params(local, self.tp_specs, self.mp, self.mp_rank, lead=1)
            return [local[k].clone() for k in keys]
        return _map_client_state(tree, mine)

    def round_generator(self, state: ServerState, stream: int = 0) -> torch.Generator:
        """The CPU generator of a round's minibatch indices: a function of
        (``state.seed``, ``state.round_idx``, ``stream``) only. Stream 0 is
        the global branch, 1 Ditto's personal branch."""
        return torch.Generator().manual_seed(
            _seed_of(state.seed, 1, int(state.round_idx), stream))

    def draw_indices(self, generator: torch.Generator, num_samples: torch.Tensor,
                     total: Optional[int] = None, offset: int = 0) -> torch.Tensor:
        """Minibatch indices ``[C, max_local_steps, batch_size]``, uniform
        in ``[0, max(num_samples[c], 1))``, drawn on the CPU from
        ``generator``. ``num_samples`` are the counts of rows ``[offset,
        offset + C)`` of a population of ``total`` (default ``C``) clients:
        the draw is the whole population's, sliced, so a client's indices
        do not depend on which rank holds it."""
        cfg = self.config
        # lint: allow-host-sync — the draw is the CPU generator's (the RNG
        # contract); round_step(indices=...) keeps it out of the round.
        n = torch.clamp(num_samples.cpu(), min=1)
        total = n.shape[0] if total is None else int(total)
        u = torch.rand((total, cfg.max_local_steps, cfg.batch_size),
                       generator=generator, dtype=torch.float64)
        u = u[offset:offset + n.shape[0]]
        idx = torch.floor(u * n[:, None, None]).long()
        return torch.minimum(idx, n[:, None, None] - 1)

    # ------------------------------------------------------- local training
    def _persample(self, p: Params, x: torch.Tensor, y: torch.Tensor):
        """Per-sample cross-entropy ``[n]`` and, for a model with an
        auxiliary loss, ``aux_loss_weight * aux`` (else None). In
        multiplicity mode the aux term sees the client's whole local set,
        as in the JAX engine."""
        if self._pp is not None:
            logits = self._pp.logits(p, x)
            return F.cross_entropy(logits.float(), y, reduction="none"), None
        kw = self._forward_kwargs()
        if not self.has_aux:
            logits = functional_call(self._module(), p, (x,), kw)
            return F.cross_entropy(logits.float(), y, reduction="none"), None
        logits, aux = functional_call(self._module(), p, (x,), {"return_aux": True, **kw})
        return (F.cross_entropy(logits.float(), y, reduction="none"),
                self.config.aux_loss_weight * aux.float())

    def _loss_gather(self, p, xb, yb):
        losses, aux = self._persample(p, xb, yb)
        return losses.mean() if aux is None else losses.mean() + aux

    def _loss_multiplicity(self, p, x, y, sw):
        losses, aux = self._persample(p, x, y)
        loss = (sw * losses).sum()
        return loss if aux is None else loss + aux

    def _masked_sgd(self, p: Params, x, y, steps_eff, idx,
                    prox_anchor: Optional[Params] = None,
                    grad_transform: Optional[Callable] = None,
                    ) -> Tuple[Params, torch.Tensor]:
        """Masked local SGD for one block of clients, shared by the global
        and Ditto branches: ``p [Cb, ...]`` the per-client start, ``x [Cb,
        n_local, ...]``, ``steps_eff [Cb]``, ``idx [Cb, S, B]``. Step ``i``
        of a client is frozen (by ``where``) when ``i >= steps_eff``.
        ``prox_anchor`` adds FedProx's penalty toward it;
        ``grad_transform(name, g, p) -> g'`` corrects each gradient (its
        result is cast back to the carry dtype). Returns the final params
        in ``p``'s dtypes and the mean losses ``[Cb]`` (NaN for a client
        that ran no step: "no work" must not read as success)."""
        cfg = self.config
        alg = self.algorithm
        cb, n_local = x.shape[0], x.shape[1]
        rows = torch.arange(cb, device=x.device)[:, None]
        orig = {k: v.dtype for k, v in p.items()}
        if cfg.carry_dtype is not None:
            p = {k: v.to(cfg.carry_dtype) for k, v in p.items()}
        # optax scales by -lr as a scalar of the update's own dtype.
        neg_lr = {dt: torch.tensor(-alg.local_lr, dtype=dt)
                  for dt in {v.dtype for v in p.values()}}
        mult = cfg.use_multiplicity(n_local)
        loss_fn = self._loss_multiplicity if mult else self._loss_gather
        if prox_anchor is not None and alg.prox_mu:
            base = loss_fn

            def loss_fn(q, *args):
                return base(q, *args) + 0.5 * alg.prox_mu * self._prox_sq(q, prox_anchor)

        step_fn = vmap(grad_and_value(loss_fn))
        total = torch.zeros(cb, dtype=torch.float32, device=x.device)
        for i in range(cfg.max_local_steps):
            bi = idx[:, i]
            if mult:
                sw = torch.zeros((cb, n_local), dtype=torch.float32, device=x.device)
                sw.scatter_add_(1, bi, torch.ones_like(bi, dtype=torch.float32))
                grads, loss = step_fn(p, x, y, sw / cfg.batch_size)
            else:
                grads, loss = step_fn(p, x[rows, bi], y[rows, bi])
            if self._pp is not None:
                grads = self._pp.fix_grads(grads)
            if grad_transform is not None:
                grads = {k: grad_transform(k, g, p[k]).to(p[k].dtype) for k, g in grads.items()}
            active = i < steps_eff
            # where, not multiply-by-gate: 0 * non-finite = NaN would let an
            # inactive step corrupt params that must stay frozen.
            p = {k: p[k] + torch.where(_bcast(active, g), g * neg_lr[g.dtype], 0.0)
                 for k, g in grads.items()}
            total = total + torch.where(active, loss, 0.0)
        mean_loss = torch.where(
            steps_eff > 0,
            total / torch.clamp(steps_eff, min=1).float(),
            torch.full_like(total, float("nan")),
        )
        return {k: v.to(orig[k]) for k, v in p.items()}, mean_loss

    def _prox_sq(self, q: Params, anchor: Params) -> torch.Tensor:
        """FedProx's ``||q - anchor||^2`` over the whole model: the split
        leaves' part summed over the model group (an identity gradient),
        so every rank holds the same value and each leaf's pull once."""
        if self._pp is not None:
            return self._pp.prox_sq(q, anchor)
        if not self._split:
            return sum((q[k] - anchor[k]).square().sum() for k in q)
        whole = sum((q[k] - anchor[k]).square().sum() for k in q if k not in self._split)
        part = sum((q[k] - anchor[k]).square().sum() for k in q if k in self._split)
        return whole + collectives.reduce_from(part, self.mp_group)

    def _check_client_state(self, what: str, tree: Params, C: int, dev) -> None:
        for k, v in tree.items():
            if v.shape[0] != C or v.device != dev:
                raise ValueError(
                    f"{what}[{k!r}] is {tuple(v.shape)} on {v.device}; expected a "
                    f"leading client axis of {C} on {dev} (init it for ds.num_clients)"
                )

    def _indices(self, indices, state: ServerState, stream: int, ds: ClientDataset,
                 dev) -> torch.Tensor:
        """This rank's rows of the round's minibatch indices: drawn, or
        sliced from the caller's whole-population ``indices``."""
        if indices is None:
            return self.draw_indices(self.round_generator(state, stream), ds.num_samples,
                                     total=ds.padded_clients,
                                     offset=ds.offset).to(dev, torch.int64)
        want = (ds.padded_clients, self.config.max_local_steps, self.config.batch_size)
        if tuple(indices.shape) != want:
            raise ValueError(f"indices must be {want}, got {tuple(indices.shape)}")
        return indices[self.client_rows(ds)].to(dev, torch.int64)

    def _check_shard(self, ds: ClientDataset) -> None:
        """``ds`` must be this rank's shard of a population padded for the
        plan (:meth:`ClientDataset.shard`)."""
        C = ds.num_clients
        if ds.padded_clients != C * self.dp or ds.offset != self.dp_rank * C:
            raise ValueError(
                f"dataset rows [{ds.offset}, {ds.offset + C}) of "
                f"{ds.padded_clients} are not rank {self.dp_rank}'s shard over "
                f"dp={self.dp}; pad with ClientDataset.pad_for(dp * block) and "
                f"place ds.shard(plan)"
            )

    def _released(self, participate, ds: ClientDataset):
        """Per block of this rank's rows, the real clients that the
        participation mask releases (all real clients without one), counted
        on the host before the mask moves to the device; None for a mask
        already on the device, which would need a sync to count, and with
        the default tracer off, whose ``round.block`` spans alone read it."""
        if not default_tracer().enabled:
            return None
        if isinstance(participate, torch.Tensor) and participate.device.type != "cpu":
            return None
        rows = self.client_rows(ds)
        # NumPy, not torch: the round's recorded operations stay its own.
        on = np.arange(rows.start, rows.stop) < ds.num_real_clients
        if participate is not None:
            mask = np.asarray(participate)
            if mask.shape[0] != ds.padded_clients:
                return None  # _local_arg refuses it
            on &= mask[rows] > 0
        B = self.config.block_clients
        return [int(on[s:s + B].sum()) for s in range(0, on.shape[0], B)]

    def _local_arg(self, name: str, arr, ds: ClientDataset, dev):
        """This rank's rows of a whole-population per-client argument."""
        if arr is None:
            return None
        if arr.shape[0] != ds.padded_clients:
            raise ValueError(f"{name} must cover the {ds.padded_clients} padded "
                             f"clients, got {tuple(arr.shape)}")
        return torch.as_tensor(arr)[self.client_rows(ds)].to(dev)

    # ----------------------------------------------------------- round step
    def round_step(self, state: ServerState, ds: ClientDataset,
                   participate: Optional[torch.Tensor] = None,
                   num_steps: Optional[torch.Tensor] = None,
                   personal: Optional[PersonalState] = None,
                   control: Optional[ControlState] = None,
                   indices: Optional[torch.Tensor] = None,
                   personal_indices: Optional[torch.Tensor] = None,
                   completion_time: Optional[torch.Tensor] = None,
                   deadline: Optional[float] = None,
                   attack_scale: Optional[torch.Tensor] = None,
                   defense: Optional[DefenseConfig] = None,
                   async_plan=None,
                   ):
        """Advance one FL round over the placed, padded population: ``ds``
        is this rank's shard (the whole population at dp 1). Every
        per-client argument below is over the whole padded population
        (``ds.padded_clients``, written C) and is sliced to this rank's
        rows; the per-client state (``personal``, ``control``) is this
        rank's rows only. The metrics' per-client tensors come back over
        the whole population on every rank.

        ``participate`` — optional [C] 0/1 mask multiplying the base
        weights. ``num_steps`` — optional per-client local-step counts
        (default ``max_local_steps``). ``personal`` — Ditto state, required
        iff the algorithm is personalized; the return is then ``(state,
        metrics, personal)``. ``control`` — SCAFFOLD state, required iff the
        algorithm uses control variates; the return is then ``(state,
        metrics, control)``; otherwise ``(state, metrics)``. ``indices`` /
        ``personal_indices`` — optional minibatch indices ``[C,
        max_local_steps, batch_size]`` of the global / Ditto branch; by
        default they are drawn from :meth:`round_generator`'s streams.

        ``deadline`` + ``completion_time`` [C] — deadline-masked
        aggregation: a client whose simulated completion time exceeds the
        deadline gets zero weight and is counted in ``metrics.stragglers``
        (an inf deadline leaves the round bitwise unchanged).
        ``attack_scale`` [C] — per-client delta multiplier (sign_flip = -1,
        scale = factor, benign = 1). ``defense`` — a
        :class:`~olearning_sim_tpu_torch.engine.defense.DefenseConfig`:
        L2 delta clipping, trimmed-mean / median aggregation and anomaly
        scores (``metrics.anomaly_score``, ``metrics.clipped``); one that
        is not ``enabled`` is the plain round.

        ``async_plan`` — an
        :class:`~olearning_sim_tpu_torch.engine.async_rounds.AsyncRoundPlan`:
        the buffered asynchronous round instead of the synchronous one
        (staleness-weighted commits every ``buffer_size`` arrivals,
        :func:`~olearning_sim_tpu_torch.engine.async_rounds.async_round`);
        the return is then ``(state, metrics, async_stats)``. It refuses a
        deadline and per-client state, as the JAX engine does."""
        cfg = self.config
        alg = self.algorithm
        dev = next(iter(state.params.values())).device
        if ds.x.device != dev:
            raise ValueError(
                f"dataset is on {ds.x.device} but the state on {dev}; "
                f"place it with ds.to(device)"
            )
        C = ds.num_clients
        if C % cfg.block_clients:
            raise ValueError(
                f"client count {C} must be a multiple of block_clients="
                f"{cfg.block_clients}; pad with ClientDataset.pad_for(block)"
            )
        self._check_shard(ds)
        if defense is not None and not defense.enabled:
            defense = None
        if self._pp is not None:
            pp_rounds.check_launch(deadline, completion_time, attack_scale, defense, async_plan)
        if async_plan is not None:
            async_rounds.check_round(self, ds, async_plan, personal=personal, control=control,
                                     personal_indices=personal_indices,
                                     completion_time=completion_time, deadline=deadline)
        else:
            self._check_sync_state(C, dev, personal, control, personal_indices)
        if defense is not None and defense.gathers_deltas and alg.control_variates:
            raise ValueError(
                "robust aggregators / anomaly scoring are not supported "
                "with control-variate algorithms (the SCAFFOLD server "
                "control consumes the weighted mean); use clip_norm only"
            )
        if defense is not None and defense.gathers_deltas and self.mp > 1:
            raise ValueError(
                "robust aggregators / anomaly scoring do not compose with "
                "a model-parallel mesh (mp > 1): their coordinate-sharded "
                "layout is built on manual dp collectives the mp>1 "
                "GSPMD-auto round program cannot host — run mp=1 or use "
                "clip_norm only (docs/performance.md has the composition "
                "matrix)"
            )
        released = self._released(participate, ds)
        participate = self._local_arg("participate", participate, ds, dev)
        weight = ds.weight if participate is None else ds.weight * participate
        stragglers = None
        if deadline is not None:
            if completion_time is None:
                raise ValueError(
                    "deadline given without completion_time; compute one "
                    "with olearning_sim_tpu_torch.engine.pacing.completion_times"
                )
            # where(late, 0, w) selects the untouched weight for on-time
            # clients, so a non-binding deadline (inf) changes no bit.
            completion_time = self._local_arg("completion_time", completion_time, ds, dev)
            late = completion_time.to(torch.float32) > torch.full(
                (), deadline, dtype=torch.float32, device=dev)
            stragglers = ((weight > 0) & late).sum().float()
            weight = torch.where(late, 0.0, weight)
        elif completion_time is not None:
            raise ValueError("completion_time given without a deadline")
        attack_scale = self._local_arg("attack_scale", attack_scale, ds, dev)
        clip_norm = trim_fraction = None
        if defense is not None:
            clip_norm, trim_fraction = _defense_scalars(defense, dev)
        num_steps = self._local_arg("num_steps", num_steps, ds, dev)
        if num_steps is None:
            num_steps = torch.full((C,), cfg.max_local_steps, dtype=torch.int64, device=dev)
        steps_eff = torch.clamp(num_steps, max=cfg.max_local_steps)
        indices = self._indices(indices, state, 0, ds, dev)
        if alg.personalized:
            personal_indices = self._indices(personal_indices, state, 1, ds, dev)

        if async_plan is not None:
            return async_rounds.async_round(self, state, ds, async_plan, weight, steps_eff,
                                            indices, attack_scale, defense, clip_norm,
                                            trim_fraction, released=released)
        # The carry's layout: this rank's shards or stage (the whole model
        # at mp 1 and pp 1); SCAFFOLD's server control alike.
        local = self._to_carry(state.params)
        local_control = control
        if control is not None and self.tp_specs is not None:
            local_control = ControlState(control.client_controls,
                                         self._to_carry(control.server_control))
        sums = self._round_sums(local, C, clipping=defense is not None,
                                gathering=defense is not None and defense.gathers_deltas)
        for s in range(0, C, cfg.block_clients):
            blk = slice(s, s + cfg.block_clients)
            self._train_block(
                sums, local, blk, ds.x[blk], ds.y[blk], steps_eff[blk],
                indices[blk], weight[blk],
                None if attack_scale is None else attack_scale[blk],
                clip_norm=clip_norm, control=local_control, personal=personal,
                personal_idx=personal_indices[blk] if alg.personalized else None,
                released=None if released is None else released[s // cfg.block_clients],
            )
        with default_tracer().span("round.server_update"):
            return self._finish_round(state, sums, defense, trim_fraction, stragglers,
                                      control, ds.population)

    def _check_sync_state(self, C: int, dev, personal, control, personal_indices) -> None:
        """The synchronous round's per-client state: present iff the
        algorithm keeps it, with a leading axis of ``C`` clients on ``dev``."""
        alg = self.algorithm
        if alg.control_variates:
            if control is None:
                raise ValueError(
                    f"algorithm {alg.name!r} uses control variates; pass "
                    f"control=core.init_control(state, ds.num_clients)"
                )
            self._check_client_state("control.client_controls", control.client_controls,
                                     C, dev)
        elif control is not None:
            raise ValueError(
                f"algorithm {alg.name!r} does not use control variates but "
                f"control state was supplied"
            )
        if alg.personalized:
            if personal is None:
                raise ValueError(
                    f"algorithm {alg.name!r} is personalized; pass "
                    f"personal=core.init_personal(state, ds.num_clients)"
                )
            self._check_client_state("personal.params", personal.params, C, dev)
        elif personal is not None or personal_indices is not None:
            raise ValueError(
                f"algorithm {alg.name!r} is not personalized but personal "
                f"state was supplied"
            )

    def _round_sums(self, params: Params, C: int, clipping: bool,
                    gathering: bool, windows: Optional[int] = None) -> "_RoundSums":
        """Zero running aggregates of a round over ``C`` (padded) clients;
        with ``gathering``, the ``[C, ...]`` f32 delta buffer of a
        gathering defense. An async round (``windows`` W) sums into a
        ``[W, ...]`` f32 window buffer (none when gathering: the windows are
        built from the gathered deltas) and its ``[W]`` weights instead of
        the round's delta sum."""
        alg = self.algorithm
        dev = next(iter(params.values())).device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        sums = _RoundSums(
            sum_delta=({} if windows else
                       {k: torch.zeros_like(p) for k, p in params.items()}),
            sum_w=zero, sum_loss=zero.clone(), count=zero.clone(),
            sum_ploss=zero.clone(),
            sum_dc=({k: torch.zeros_like(p) for k, p in params.items()}
                    if alg.control_variates else None),
            n_clip=zero.clone() if clipping else None,
            new_client_state={k: [] for k in params},
        )
        if gathering:
            # Every client's gated, clipped f32 delta, for the robust
            # statistics after the loop, and its effective weight.
            sums.gathered = {k: torch.empty((C,) + p.shape, dtype=torch.float32, device=dev)
                             for k, p in params.items()}
            sums.gathered_w = torch.empty(C, dtype=torch.float32, device=dev)
        if windows:
            sums.buf_w = torch.zeros(windows, dtype=torch.float32, device=dev)
            if not gathering:
                sums.buf = {k: torch.zeros((windows,) + p.shape, dtype=torch.float32,
                                           device=dev) for k, p in params.items()}
        return sums

    def _train_block(self, sums: "_RoundSums", params: Params, blk: slice, bx, by,
                     bsteps, bidx, bw, batk=None, clip_norm=None, control=None,
                     personal=None, personal_idx=None, window=None, score=None,
                     released: Optional[int] = None) -> None:
        """One block of ``block_clients`` clients, shared by the resident,
        the streamed and the async round: local training, the attack, the
        finiteness gate, the clip, and the block's terms added to ``sums``
        in the round's fixed order. ``blk`` is the block's rows in the
        padded population (the per-client state and the gathered buffer
        are indexed by it); ``bw`` is the block's aggregation weights after
        participation and the deadline. An async round passes each client's
        commit ``window`` and, under the ``score`` schedule, its ``score``,
        which reweights its delta after the clip; the weighted deltas then
        land in their window's slot of ``sums.buf``.

        The block is a ``round.block`` span of the default tracer
        (attributes ``block``, ``clients`` and, where the caller counted
        them on the host, ``released``), holding a ``round.local_steps``
        span around each local training and a ``round.aggregate`` span
        around the rest."""
        cfg = self.config
        alg = self.algorithm
        tracer = default_tracer()
        attrs = {}
        if tracer.enabled:
            attrs = {"block": blk.start // cfg.block_clients, "clients": cfg.block_clients}
            if released is not None:
                attrs["released"] = released
        with tracer.span("round.block", **attrs):
            start = {k: v.unsqueeze(0).expand((cfg.block_clients,) + v.shape)
                     for k, v in params.items()}
            transform = None
            if alg.control_variates:
                sc = control.server_control
                ci = {k: v[blk] for k, v in control.client_controls.items()}

                def transform(k, g, _p):
                    return g + sc[k] - ci[k]

            with tracer.span("round.local_steps"):
                final, losses = self._masked_sgd(start, bx, by, bsteps, bidx,
                                                 prox_anchor=params, grad_transform=transform)
            with tracer.span("round.aggregate"):
                deltas = trained = {k: final[k] - params[k] for k in params}
                if batk is not None:
                    # The shipped delta; SCAFFOLD's refresh below reads the
                    # trained one, as the JAX engine's local training returns it.
                    deltas = _attack_deltas(trained, batk)
                ok = self._agree_ok(_finite_client_mask(losses, deltas))
                bw_eff = torch.where(ok, bw, 0.0)
                if clip_norm is None and window is None:
                    for k, d in deltas.items():
                        gated = torch.where(_bcast(ok, d), d.float(), 0.0)
                        sums.sum_delta[k] += torch.tensordot(bw_eff, gated, dims=([0], [0]))
                else:
                    d32 = {k: torch.where(_bcast(ok, d), d.float(), 0.0)
                           for k, d in deltas.items()}
                    if clip_norm is not None:
                        split = ({"split": self._split, "group": self.mp_group}
                                 if self._split else {})
                        d32, too_big = _clip_client_deltas(d32, clip_norm, **split)
                        sums.n_clip = sums.n_clip + ((bw_eff > 0) & too_big).sum().float()
                    if window is None:
                        for k, d in d32.items():
                            sums.sum_delta[k] += torch.tensordot(bw_eff, d, dims=([0], [0]))
                    else:
                        if score is not None:
                            # Apodotiko contribution scores reweight clients inside
                            # their buffer (the staleness discount applies per window
                            # at commit time).
                            d32 = {k: d * _bcast(score, d) for k, d in d32.items()}
                        onehot = async_rounds.window_weights(window, bw_eff, sums.buf_w.shape[0])
                        sums.buf_w = sums.buf_w + onehot.sum(dim=0)
                        if sums.buf is not None:
                            for k, d in d32.items():
                                sums.buf[k] += torch.tensordot(onehot, d, dims=([0], [0]))
                    if sums.gathered is not None:
                        for k, d in d32.items():
                            sums.gathered[k][blk] = d
                        sums.gathered_w[blk] = bw_eff
                    del d32
                sums.sum_w = sums.sum_w + bw_eff.sum()
                sums.sum_loss = sums.sum_loss + torch.where(ok, bw * losses, 0.0).sum()
                sums.count = sums.count + (bw_eff > 0).sum().float()
                sums.client_loss.append(losses)
                if alg.control_variates:
                    # Option II: c_i' - c_i = -c - delta / (K * lr), zero for a
                    # client that ran no step; c_i advances only for participants
                    # that survived the finiteness gate.
                    k_lr = torch.clamp(bsteps, min=1).float() * alg.local_lr
                    ran, active = bsteps > 0, bw_eff > 0
                    for k, d in trained.items():
                        dci = torch.where(_bcast(ran, d), -sc[k] - d / _bcast(k_lr, d), 0.0)
                        sums.new_client_state[k].append(
                            ci[k] + torch.where(_bcast(active, d), dci, 0.0))
                        sums.sum_dc[k] += torch.tensordot(
                            bw_eff, torch.where(_bcast(ok, d), dci, 0.0), dims=([0], [0]))
            if alg.personalized and not alg.control_variates:
                v_old = {k: v[blk] for k, v in personal.params.items()}
                with tracer.span("round.local_steps"):
                    new_v, ploss_sum = self._personal_train(
                        v_old, params, bx, by, bsteps, bw, personal_idx)
                sums.sum_ploss = sums.sum_ploss + ploss_sum
                for k, v in new_v.items():
                    sums.new_client_state[k].append(v)

    def _finish_round(self, state: ServerState, sums: "_RoundSums", defense,
                      trim_fraction, stragglers, control, population: int):
        """The round's close, shared by the resident and the streamed round,
        as the JAX engine's after its block scan: the sums meet over dp (a
        psum, or a psum_scatter onto the coordinate shards under the
        sharded update), the robust statistics of a gathering defense run
        on coordinate shards re-laid by one all_to_all, the server update
        runs on the negative mean delta, and the metrics and the new
        per-client state are formed."""
        alg = self.algorithm
        params = state.params
        shard_update = self.config.shard_server_update
        gather = sums.gathered is not None
        robust = gather and defense.aggregator in ("trimmed_mean", "median")
        # Under mp or pp the sums are in the carry's layout (this rank's
        # shards or stage): they meet over dp in that layout, then the
        # model group puts them back together (and under mp the sharded
        # update takes its 1/(dp * mp) of the coordinates from the whole).
        model_axes = self.model_group is not None or self.mp > 1
        # One psum for the round's scalars and the replicated sums; the
        # mean's collective is skipped when a robust aggregate replaces it.
        scalars = [sums.sum_w, sums.sum_loss, sums.count, sums.sum_ploss]
        if sums.n_clip is not None:
            scalars.append(sums.n_clip)
        if stragglers is not None:
            scalars.append(stragglers)
        keys = list(sums.sum_delta)
        dense = ([] if robust or (shard_update and not model_axes)
                 else [sums.sum_delta[k] for k in keys])
        dcs = [sums.sum_dc[k] for k in keys] if alg.control_variates else []
        reduced = collectives.psum(scalars + dense + dcs, self.group)
        sum_w, sum_loss, count, sum_ploss = reduced[:4]
        rest = reduced[4:len(scalars)]
        n_clip = rest.pop(0) if sums.n_clip is not None else None
        if stragglers is not None:
            stragglers = rest.pop(0)
        sum_dc = dict(zip(keys, reduced[len(scalars) + len(dense):]))
        denom = torch.clamp(sum_w, min=1e-8)
        mean_delta = delta_shards = None
        if model_axes:
            mean_delta = self._from_carry({k: s / denom for k, s in
                                     zip(keys, reduced[len(scalars):len(scalars) + len(dense)])})
            if alg.control_variates:
                sum_dc = self._from_carry(sum_dc)
            if shard_update:
                # This rank's 1/(dp * mp) of the flat coordinates.
                delta_shards = self._my_shard(self._flat(mean_delta))
        elif not robust:
            if shard_update:
                delta_shards = dict(zip(keys, collectives.psum_scatter(
                    [_flat_pad_leaf(sums.sum_delta[k], self.dp) for k in keys], self.group)))
                delta_shards = {k: d / denom for k, d in delta_shards.items()}
            else:
                mean_delta = {k: s / denom
                              for k, s in zip(keys, reduced[len(scalars):len(scalars) + len(dense)])}
        anomaly_score = None
        if gather:
            # Each rank holds every client for 1/dp of the coordinates; each
            # coordinate's client column is whole, so the statistics are
            # those of the gathered formulation, bit for bit.
            w_all = collectives.all_gather([sums.gathered_w], self.group)[0]
            participants = w_all > 0
            shards = defense_mod.shard_client_deltas(sums.gathered, self.group)
            sums.gathered = None
            center = None
            if robust:
                agg = robust_aggregate(shards, participants, defense.aggregator, trim_fraction)
                if defense.aggregator == "median":
                    center = agg
                if shard_update:
                    # The same coordinate partition as the sharded update:
                    # the robust aggregate feeds it with no reconstruction.
                    delta_shards = agg
                else:
                    mean_delta = self._stitch(agg, params)
            if defense.score_enabled:
                if center is None:
                    center = robust_aggregate(shards, participants, "median", trim_fraction)
                anomaly_score = distance_scores(shards, center, participants, self.group)
            del shards
        # The server optimizer consumes the negative mean delta (or the
        # robust aggregate) as a pseudo-gradient (FedOpt formulation).
        grad = delta_shards if shard_update else mean_delta
        pseudo_grad = {k: -d for k, d in grad.items()}
        new_params, opt_state = self._server_update(params, pseudo_grad, state.opt_state)
        metrics = RoundMetrics(
            mean_loss=sum_loss / denom,
            weight_sum=sum_w,
            clients_trained=count,
            client_loss=collectives.all_gather([torch.cat(sums.client_loss)], self.group)[0],
            personal_loss=sum_ploss / denom,
        )
        if stragglers is not None:
            metrics.stragglers = stragglers
        if n_clip is not None:
            metrics.clipped = n_clip
        if anomaly_score is not None:
            metrics.anomaly_score = anomaly_score
        new_state = ServerState(params=new_params, opt_state=opt_state,
                                round_idx=state.round_idx + 1, seed=state.seed)
        if alg.control_variates or alg.personalized:
            per_client = {k: torch.cat(v) for k, v in sums.new_client_state.items()}
        if alg.control_variates:
            # c <- c + (|S| / N) * weighted-mean refresh, N the true
            # population (survives padding and take()).
            frac = count / max(float(population), 1.0)
            server_c = {k: c + frac * (sum_dc[k] / denom)
                        for k, c in control.server_control.items()}
            return new_state, metrics, ControlState(per_client, server_c)
        if alg.personalized:
            return new_state, metrics, PersonalState(per_client)
        return new_state, metrics

    # --------------------------------------------------------- streamed round
    def _stream_reject(self, defense) -> None:
        """What a streamed round refuses, with the JAX engine's messages."""
        if self.plan.pp > 1 or self.mp > 1:
            raise ValueError(
                "streamed rounds run on dp-only meshes: the partial-"
                "aggregate carry is a manual-dp program (mp>1 runs "
                "GSPMD-auto end-to-end, pp>1 pipelines the train body; "
                "docs/performance.md has the composition matrix)"
            )
        if self.algorithm.personalized or self.algorithm.control_variates:
            raise ValueError(
                f"streamed rounds do not support the personalized/"
                f"control-variate algorithm {self.algorithm.name!r} "
                f"(per-client state does not yet stream; keep the "
                f"population resident)"
            )
        if self.config.shard_server_update:
            raise ValueError(
                "streamed rounds use the replicated server update; "
                "fedcore.shard_server_update=true does not compose with "
                "scenario.stream_block_rows (the round-close stitch "
                "would need the manual psum_scatter tail per stream "
                "variant — docs/performance.md composition matrix)"
            )
        if defense is not None and defense.gathers_deltas:
            raise ValueError(
                "robust aggregators / anomaly scoring do not compose "
                "with streamed rounds: they need every client's delta "
                "simultaneously (O(cohort x params)), which is exactly "
                "the residency streaming removes — use clip_norm only"
            )

    def _prepare_stream(self, store, stream_rows: int, participate=None,
                        num_steps=None, completion_time=None, deadline=None,
                        attack_scale=None, defense=None, label_shift=None,
                        label_classes=None) -> dict:
        """Resolve one streamed round's plan: pad the store to whole stream
        blocks and the per-client host arrays to the padded population."""
        cfg = self.config
        if defense is not None and not defense.enabled:
            defense = None
        self._stream_reject(defense)
        R = int(stream_rows)
        if R % (self.dp * cfg.block_clients) != 0:
            raise ValueError(
                f"stream_block_rows={R} must be a multiple of "
                f"dp*block_clients={self.dp * cfg.block_clients}"
            )
        if deadline is None and completion_time is not None:
            raise ValueError("completion_time given without a deadline")
        if deadline is not None and completion_time is None:
            raise ValueError(
                "deadline given without completion_time; compute one "
                "with olearning_sim_tpu_torch.engine.pacing.completion_times"
            )
        if label_shift is not None and label_classes is None:
            raise ValueError(
                "label_shift needs label_classes (the drift modulus); "
                "the scenario layer passes the population's class count"
            )
        c_pad = pad_to_multiple(max(store.num_real_clients, store.padded_clients), R)
        store.pad_to(c_pad)

        def full(arr, fill, dtype):
            if arr is None:
                return None
            out = np.full(c_pad, fill, dtype)
            a = np.asarray(arr)
            out[: a.shape[0]] = a.astype(dtype, copy=False)
            return out

        # The JAX engine's dp layout: rank d holds clients [d * cpd, (d + 1)
        # * cpd), the resident shard's, and stream block i carries rows [d *
        # cpd + i * rpd, d * cpd + (i + 1) * rpd) of them, so each rank's
        # accumulation chain is the resident round's.
        cpd, rpd = c_pad // self.dp, R // self.dp
        return {
            "R": R, "c_pad": c_pad, "nb": c_pad // R, "defense": defense,
            "cpd": cpd, "rpd": rpd, "lo": self.dp_rank * cpd,
            "participate": full(participate, 0.0, np.float32),
            "num_steps": full(num_steps, cfg.max_local_steps, np.int64),
            "completion_time": full(completion_time, np.inf, np.float32),
            "deadline": deadline,
            "attack_scale": full(attack_scale, 1.0, np.float32),
            "label_shift": full(label_shift, 0, np.int64),
            "label_classes": label_classes,
        }

    def _gather_stream_block(self, store, prep: dict, i: int, feature_dtype,
                             generator, indices) -> Tuple[dict, int, Optional[list]]:
        """Stream block ``i`` as host tensors in the dtypes the round reads
        (the same values :meth:`round_step` computes on the device from the
        resident population), its count of late participants, and the
        clients each sub-block of ``block_clients`` releases (weight after
        participation, before the deadline; None with the default tracer
        off). The
        minibatch indices of the block's rows are drawn from ``generator``,
        so blocks drawn in order draw what one whole-population draw does."""
        cfg = self.config
        lo = prep["lo"] + i * prep["rpd"]
        hi = lo + prep["rpd"]
        rows = store.rows(lo, hi)
        x = torch.from_numpy(np.ascontiguousarray(rows["x"]))
        x_dtype = feature_dtype if feature_dtype is not None and x.is_floating_point() \
            else x.dtype
        y = rows["y"]
        if prep["label_shift"] is not None:
            # Label drift: the client's labels rotate by its shift this
            # round; a zero shift leaves them as they are.
            shift = prep["label_shift"][lo:hi]
            if shift.any():
                y = (y.astype(np.int64) + shift[:, None]) % int(prep["label_classes"])
        weight = np.asarray(rows["weight"], np.float32)
        if prep["participate"] is not None:
            weight = weight * prep["participate"][lo:hi]
        B = cfg.block_clients
        released = ([int((weight[s:s + B] > 0).sum()) for s in range(0, hi - lo, B)]
                    if default_tracer().enabled else None)
        n_late = 0
        if prep["deadline"] is not None:
            late = prep["completion_time"][lo:hi] > np.float32(prep["deadline"])
            n_late = int(((weight > 0) & late).sum())
            weight = np.where(late, np.float32(0.0), weight)
        steps = (np.minimum(prep["num_steps"][lo:hi], cfg.max_local_steps)
                 if prep["num_steps"] is not None
                 else np.full(hi - lo, cfg.max_local_steps, np.int64))
        if indices is None:
            idx = self.draw_indices(generator, torch.from_numpy(
                np.asarray(rows["num_samples"], np.int64)))
        else:
            idx = indices[lo:hi]
        block = {
            "x": (x, x_dtype),
            "y": (torch.from_numpy(np.asarray(y)), torch.int64),
            "steps": (torch.from_numpy(steps), torch.int64),
            "weight": (torch.from_numpy(weight), torch.float32),
            "indices": (idx, torch.int64),
        }
        if prep["attack_scale"] is not None:
            block["attack_scale"] = (torch.from_numpy(prep["attack_scale"][lo:hi]),
                                     torch.float32)
        return block, n_late, released

    def stream_round(self, state: ServerState, store, stream_rows: Optional[int] = None,
                     participate=None, num_steps=None, completion_time=None,
                     deadline: Optional[float] = None, attack_scale=None,
                     defense: Optional[DefenseConfig] = None, label_shift=None,
                     label_classes: Optional[int] = None,
                     feature_dtype: Optional[torch.dtype] = torch.bfloat16,
                     tracer=None, indices: Optional[torch.Tensor] = None):
        """Advance one FL round over a host-resident
        :class:`~olearning_sim_tpu_torch.engine.client_data.HostClientStore`,
        streaming the population through the device in blocks of
        ``stream_rows`` clients (a multiple of ``block_clients``), double
        buffered (:class:`~olearning_sim_tpu_torch.engine.staging.BlockStager`),
        with the partial aggregates carried on the device. Returns
        ``(state, metrics, StreamStats)``.

        Per-client inputs (``participate``, ``num_steps``,
        ``completion_time``, ``attack_scale``, ``label_shift``) are host
        arrays of length ``num_real_clients`` (or the padded population);
        the scalar knobs mean what they mean in :meth:`round_step`.
        ``label_shift`` rotates each client's labels by its shift modulo
        ``label_classes`` (label drift). ``feature_dtype`` is the staged
        features' dtype, as in ``ClientDataset.to`` (cast on the host).
        ``indices`` — optional minibatch indices ``[padded, max_local_steps,
        batch_size]``; by default each block's rows are drawn in order from
        :meth:`round_generator`, which draws what :meth:`round_step` draws
        for the same rows. Over dp ranks each rank stages and trains only
        its rows of each stream block (``stream_rows / dp`` of them, from
        its own store, which every rank builds alike), and the round closes
        as the resident round does.

        Each block runs :meth:`_train_block` over its sub-blocks of
        ``block_clients`` in the resident round's order, and the round
        closes through :meth:`_finish_round`: a streamed round equals the
        resident round at the same padded size bit for bit. ``tracer`` (the
        default tracer when None) gets a ``stream_stage`` span per block
        around the wait for its staging and a ``stream_step`` span around
        its launches; the sub-blocks' ``round.block`` spans (their
        ``released`` counted from the staged host weights) and the close's
        ``round.server_update`` go to the default tracer, as in
        :meth:`round_step`."""
        tracer = tracer if tracer is not None else default_tracer()
        if stream_rows is None:
            raise ValueError(
                "stream_round needs stream_rows (scenario."
                "stream_block_rows when driven by engine params)"
            )
        prep = self._prepare_stream(
            store, stream_rows, participate=participate, num_steps=num_steps,
            completion_time=completion_time, deadline=deadline,
            attack_scale=attack_scale, defense=defense, label_shift=label_shift,
            label_classes=label_classes,
        )
        cfg = self.config
        R, nb, defense = prep["R"], prep["nb"], prep["defense"]
        want = (prep["c_pad"], cfg.max_local_steps, cfg.batch_size)
        if indices is not None and tuple(indices.shape) != want:
            raise ValueError(f"indices must be {want}, got {tuple(indices.shape)}")
        dev = next(iter(state.params.values())).device
        generator = None
        if indices is None:
            generator = self.round_generator(state, 0)
            # The rows before this rank's are drawn and dropped, in blocks,
            # so its clients draw what a whole-population draw gives them.
            for _ in range(self.dp_rank * nb):
                torch.rand((prep["rpd"], cfg.max_local_steps, cfg.batch_size),
                           generator=generator, dtype=torch.float64)
        clip_norm = _defense_scalars(defense, dev)[0] if defense is not None else None
        sums = self._round_sums(state.params, prep["c_pad"], clipping=defense is not None,
                                gathering=False)
        late = []
        released = {}

        def gather(i):
            def run():
                block, n_late, released[i] = self._gather_stream_block(
                    store, prep, i, feature_dtype, generator, indices)
                late.append(n_late)
                return block
            return run

        stager = BlockStager(dev)
        waits = []
        try:
            handle = stager.submit(0, gather(0))
            for i in range(nb):
                t0 = time.perf_counter()
                with tracer.span("stream_stage", block=i):
                    blk = stager.wait(handle)
                waits.append(time.perf_counter() - t0)
                if i + 1 < nb:
                    # On a card the next block is staged while this one
                    # launches.
                    handle = stager.submit(i + 1, gather(i + 1))
                with tracer.span("stream_step", block=i):
                    for s in range(0, prep["rpd"], cfg.block_clients):
                        sl = slice(s, s + cfg.block_clients)
                        rows = slice(i * prep["rpd"] + s,
                                     i * prep["rpd"] + s + cfg.block_clients)
                        self._train_block(
                            sums, state.params, rows, blk["x"][sl], blk["y"][sl],
                            blk["steps"][sl], blk["indices"][sl], blk["weight"][sl],
                            blk["attack_scale"][sl] if "attack_scale" in blk else None,
                            clip_norm=clip_norm,
                            released=(None if released[i] is None
                                      else released[i][s // cfg.block_clients]),
                        )
                stager.release(i)
        finally:
            stager.close()
        stragglers = (torch.full((), float(sum(late)), dtype=torch.float32, device=dev)
                      if prep["deadline"] is not None else None)
        with default_tracer().span("round.server_update"):
            new_state, metrics = self._finish_round(state, sums, defense, None, stragglers,
                                                    None, store.population)

        transfer_bytes = sum(stager.staged_bytes)
        block_bytes0 = stager.staged_bytes[0]
        transfer_s = sum(waits)
        overlap = None
        if nb > 1 and waits[0] > 0 and block_bytes0 > 0:
            est_rest = (transfer_bytes - block_bytes0) / (block_bytes0 / waits[0])
            if est_rest > 0:
                overlap = float(np.clip(1.0 - (transfer_s - waits[0]) / est_rest, 0.0, 1.0))
        acc_bytes = _tree_nbytes((sums.sum_delta, sums.sum_w, sums.sum_loss, sums.count))
        stats = StreamStats(
            blocks=nb, block_rows=R, rows=prep["c_pad"],
            transfer_bytes=int(transfer_bytes),
            host_transfer_s=round(transfer_s, 6),
            overlap_fraction=overlap,
            peak_hbm_bytes_est=int(_tree_nbytes(new_state.params)
                                   + _tree_nbytes(new_state.opt_state)
                                   + acc_bytes + 2 * block_bytes0),
            state_bytes=store.state_bytes(),
            staging_s=round(stager.staging_s, 6),
        )
        name = self.algorithm.name
        instrument("ols_engine_host_transfer_seconds_total").labels(
            algorithm=name).inc(transfer_s)
        instrument("ols_engine_stream_blocks_total").labels(algorithm=name).inc(nb)
        instrument("ols_engine_client_state_bytes").labels(
            algorithm=name).set(store.state_bytes())
        return new_state, metrics, stats

    def _personal_train(self, v_old: Params, params: Params, x, y, steps_eff,
                        bw, idx) -> Tuple[Params, torch.Tensor]:
        """One block's Ditto branch: v <- v - lr * (grad F(v) + lambda *
        (v - w)), every step gated by participation (``bw > 0``). A
        branch that diverged keeps its old params. Returns the new personal
        params (in their storage dtype) and the block's ``bw``-weighted sum
        of the finite participants' losses."""
        lam = self.algorithm.ditto_lambda
        participating = bw > 0
        steps = torch.where(participating, steps_eff, 0)
        v0 = {k: v.to(params[k].dtype) for k, v in v_old.items()}

        def pull(k, g, v):
            return g + lam * (v - params[k])

        v, plosses = self._masked_sgd(v0, x, y, steps, idx, grad_transform=pull)
        v = {k: t.to(v_old[k].dtype) for k, t in v.items()}
        okp = self._agree_ok(_finite_client_mask(plosses, v))
        keep = okp | ~participating
        v = {k: torch.where(_bcast(keep, t), t, v_old[k]) for k, t in v.items()}
        return v, torch.where(participating & okp, bw * plosses, 0.0).sum()

    # ----------------------------------------------------------------- eval
    @torch.no_grad()
    def evaluate(self, params: Params, x, y) -> Tuple[float, float]:
        """Centralized eval of the global model in batches of
        ``eval_batch_size``; host arrays are moved to the params' device
        batch by batch. Under mp each rank runs its shards; under pp every
        rank runs the dense model on the whole params, as the JAX engine
        does."""
        dev = next(iter(params.values())).device
        bs = self.config.eval_batch_size
        n = x.shape[0]
        loss_sum = acc_sum = 0.0
        local = params if self._pp is not None else self._to_carry(params)
        kw = self._forward_kwargs()
        for i in range(0, n, bs):
            xb = torch.as_tensor(x[i:i + bs]).to(dev)
            yb = torch.as_tensor(y[i:i + bs]).to(dev, torch.int64)
            logits = functional_call(self._module(), local, (xb,), kw).float()
            w = yb.shape[0]
            loss_sum += float(F.cross_entropy(logits, yb)) * w
            acc_sum += float((logits.argmax(-1) == yb).float().mean()) * w
        return loss_sum / n, acc_sum / n

    @torch.no_grad()
    def evaluate_personal(self, personal: PersonalState, ds: ClientDataset,
                          ) -> Tuple[float, float]:
        """Ditto's metric of record: each client's personal model scored in
        f32 on its own valid prefix, averaged over clients by
        ``ds.weight``. Each rank scores its own clients (``personal`` and
        ``ds`` are its shard) and the weighted sums meet in one psum, so
        every rank returns the population's numbers."""
        B = self.config.block_clients
        C = ds.num_clients
        if C % B:
            raise ValueError(
                f"client count {C} must be a multiple of block_clients={B}; "
                f"pad with ClientDataset.pad_for(block)"
            )

        kw = self._forward_kwargs()

        def one(v, xc, yc, ns):
            v = {k: t.float() if t.is_floating_point() else t for k, t in v.items()}
            logits = functional_call(self._module(), v, (xc,), kw).float()
            losses = F.cross_entropy(logits, yc, reduction="none")
            valid = torch.arange(xc.shape[0], device=xc.device) < ns
            d = torch.clamp(ns, min=1).float()
            correct = (logits.argmax(-1) == yc).float()
            return (torch.where(valid, losses, 0.0).sum() / d,
                    torch.where(valid, correct, 0.0).sum() / d)

        batched = vmap(one)
        sums = torch.zeros(3, dtype=torch.float32, device=ds.x.device)
        for s in range(0, C, B):
            blk = slice(s, s + B)
            loss_c, acc_c = batched({k: v[blk] for k, v in personal.params.items()},
                                    ds.x[blk], ds.y[blk], ds.num_samples[blk])
            bw = ds.weight[blk]
            sums += torch.stack([(bw * loss_c).sum(), (bw * acc_c).sum(), bw.sum()])
        sums = collectives.psum([sums], self.group)[0]
        w = torch.clamp(sums[2], min=1e-8)
        return float(sums[0] / w), float(sums[1] / w)


def build_fedcore(model_name: str, algorithm: Algorithm,
                  config: FedCoreConfig = FedCoreConfig(),
                  model_overrides: Optional[dict] = None,
                  input_shape: Optional[Tuple[int, ...]] = None,
                  device="cuda", plan: Optional[MeshPlan] = None,
                  microbatches: Optional[int] = None) -> FedCore:
    """Convenience constructor from the model registry. ``input_shape`` is
    one example's shape (default the registry's ``example_input_shape``),
    from which the model takes its input widths. ``device`` is checked here
    (a CUDA request without CUDA raises); parameters are placed by
    :meth:`FedCore.init_state`. ``plan`` — the mesh plan (default: dp over
    every rank of the default group, or a world of one); at mp > 1 the
    ``ols_engine_tp_sharded_ratio`` gauge is set for the model.
    ``microbatches`` — the GPipe microbatch count of a pp plan (default
    pp); refused on other plans."""
    from olearning_sim_tpu_torch.models import get_model

    resolve_device(device)
    spec = get_model(model_name)
    with torch.device("meta"):
        model = spec.build(input_shape=input_shape, **(model_overrides or {}))
    core = FedCore(model, algorithm, config, plan=plan, microbatches=microbatches)
    if core.mp > 1:
        instrument("ols_engine_tp_sharded_ratio").labels(model=model_name).set(
            core.tp_sharded_ratio)
    return core
