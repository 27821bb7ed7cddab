"""FedCore — the federated round engine, synchronous variant on one device.

The port of the round program of the JAX package's ``engine/fedcore.py``,
with dp = 1 (the JAX package's ``psum`` over dp is the local sum here)::

    round_step = for each block of ``block_clients`` clients:
                     vmap over clients: masked local SGD, max_local_steps steps
                     finiteness gate, weighted delta sum
                     (SCAFFOLD: control refresh; Ditto: the personal branch)
                 -> server optimizer on the negative mean delta

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
  f32 after casting back.

Randomness is explicit: the minibatch indices ``[C, max_local_steps,
batch_size]`` come from the ``torch.Generator`` in :class:`ServerState`,
or from the caller (``round_step(..., indices=...)``); Ditto's personal
branch draws its own indices from the same generator after the global
ones (JAX salts that stream away from the global one), or takes
``personal_indices=``. The port does not reproduce JAX's threefry stream;
the parity tests hand both engines the same indices instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call, grad_and_value, vmap

from olearning_sim_tpu_torch.device import resolve_device
from olearning_sim_tpu_torch.engine.algorithms import Algorithm
from olearning_sim_tpu_torch.engine.client_data import ClientDataset

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
        the f32 default."""
        if not isinstance(obj, dict):
            raise TypeError(
                f"fedcore config must be a JSON object, got {type(obj).__name__}"
            )
        known = {f.name for f in dataclasses.fields(cls)}
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
    generator: torch.Generator  # CPU stream of minibatch indices


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


def _seed_of(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0])


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _finite_client_mask(losses: torch.Tensor, deltas: Params) -> torch.Tensor:
    """[block] bool — clients whose local training stayed finite (finite
    loss AND every delta finite). A diverged client contributes nothing to
    the aggregate: without the gate one NaN client poisons the global
    params even at weight 0 (0 * NaN is NaN)."""
    ok = torch.isfinite(losses)
    for d in deltas.values():
        ok = ok & torch.isfinite(d.reshape(d.shape[0], -1)).all(dim=1)
    return ok


class FedCore:
    """Owns one (model, algorithm, config) triple's round and eval steps."""

    def __init__(self, model: torch.nn.Module, algorithm: Algorithm,
                 config: FedCoreConfig = FedCoreConfig()):
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

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int = 0, device="cuda",
                   params: Optional[Params] = None) -> ServerState:
        """Fresh server state on ``device``: parameters drawn from ``seed``
        (or the given ``params``, copied), a zero server-optimizer state,
        and the minibatch-index generator seeded from ``seed``."""
        dev = resolve_device(device)
        if params is None:
            gen = torch.Generator().manual_seed(_seed_of(seed, 0))
            params = self.model.init_params(gen)
        params = {k: v.detach().to(dev, torch.float32).clone() for k, v in params.items()}
        return ServerState(
            params=params,
            opt_state=self.algorithm.server_optimizer.init(params),
            round_idx=0,
            generator=torch.Generator().manual_seed(_seed_of(seed, 1)),
        )

    def init_personal(self, state: ServerState, num_clients: int) -> PersonalState:
        """Ditto personal params for ``num_clients`` (padded) clients, each
        starting at the current global model, in ``config.personal_dtype``."""
        dt = self.config.personal_dtype
        return PersonalState({
            k: p.to(dt or p.dtype).unsqueeze(0).expand((num_clients,) + p.shape).contiguous()
            for k, p in state.params.items()})

    def init_control(self, state: ServerState, num_clients: int) -> ControlState:
        """Zero SCAFFOLD controls: c_i ``[num_clients, ...]`` and c, f32."""
        return ControlState(
            client_controls={k: torch.zeros((num_clients,) + p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in state.params.items()},
            server_control={k: torch.zeros_like(p, dtype=torch.float32)
                            for k, p in state.params.items()},
        )

    def draw_indices(self, generator: torch.Generator,
                     num_samples: torch.Tensor) -> torch.Tensor:
        """Minibatch indices ``[C, max_local_steps, batch_size]``, uniform
        in ``[0, max(num_samples[c], 1))``, drawn on the CPU from
        ``generator``."""
        cfg = self.config
        n = torch.clamp(num_samples.cpu(), min=1)
        u = torch.rand((n.shape[0], cfg.max_local_steps, cfg.batch_size),
                       generator=generator, dtype=torch.float64)
        idx = torch.floor(u * n[:, None, None]).long()
        return torch.minimum(idx, n[:, None, None] - 1)

    # ------------------------------------------------------- local training
    def _persample(self, p: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        logits = functional_call(self.model, p, (x,))
        return F.cross_entropy(logits.float(), y, reduction="none")

    def _loss_gather(self, p, xb, yb):
        return self._persample(p, xb, yb).mean()

    def _loss_multiplicity(self, p, x, y, sw):
        return (sw * self._persample(p, x, y)).sum()

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
                l2 = sum((q[k] - prox_anchor[k]).square().sum() for k in q)
                return base(q, *args) + 0.5 * alg.prox_mu * l2

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

    def _check_client_state(self, what: str, tree: Params, C: int, dev) -> None:
        for k, v in tree.items():
            if v.shape[0] != C or v.device != dev:
                raise ValueError(
                    f"{what}[{k!r}] is {tuple(v.shape)} on {v.device}; expected a "
                    f"leading client axis of {C} on {dev} (init it for ds.num_clients)"
                )

    def _indices(self, indices, generator, ds: ClientDataset, dev) -> torch.Tensor:
        if indices is None:
            indices = self.draw_indices(generator, ds.num_samples)
        want = (ds.num_clients, self.config.max_local_steps, self.config.batch_size)
        if tuple(indices.shape) != want:
            raise ValueError(f"indices must be {want}, got {tuple(indices.shape)}")
        return indices.to(dev, torch.int64)

    # ----------------------------------------------------------- round step
    def round_step(self, state: ServerState, ds: ClientDataset,
                   participate: Optional[torch.Tensor] = None,
                   num_steps: Optional[torch.Tensor] = None,
                   personal: Optional[PersonalState] = None,
                   control: Optional[ControlState] = None,
                   indices: Optional[torch.Tensor] = None,
                   personal_indices: Optional[torch.Tensor] = None,
                   ):
        """Advance one FL round over the placed, padded population.

        ``participate`` — optional [C] 0/1 mask multiplying the base
        weights. ``num_steps`` — optional per-client local-step counts
        (default ``max_local_steps``). ``personal`` — Ditto state, required
        iff the algorithm is personalized; the return is then ``(state,
        metrics, personal)``. ``control`` — SCAFFOLD state, required iff the
        algorithm uses control variates; the return is then ``(state,
        metrics, control)``; otherwise ``(state, metrics)``. ``indices`` /
        ``personal_indices`` — optional minibatch indices ``[C,
        max_local_steps, batch_size]`` of the global / Ditto branch; by
        default they are drawn from ``state.generator``, global first."""
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
        weight = ds.weight if participate is None else ds.weight * participate.to(dev)
        if num_steps is None:
            num_steps = torch.full((C,), cfg.max_local_steps, dtype=torch.int64)
        steps_eff = torch.clamp(num_steps.to(dev), max=cfg.max_local_steps)
        indices = self._indices(indices, state.generator, ds, dev)
        if alg.personalized:
            personal_indices = self._indices(personal_indices, state.generator, ds, dev)

        params = state.params
        sum_delta = {k: torch.zeros_like(p) for k, p in params.items()}
        sum_w = torch.zeros((), dtype=torch.float32, device=dev)
        sum_loss = torch.zeros_like(sum_w)
        count = torch.zeros_like(sum_w)
        sum_ploss = torch.zeros_like(sum_w)
        sum_dc = ({k: torch.zeros_like(p) for k, p in params.items()}
                  if alg.control_variates else None)
        client_loss = []
        new_client_state = {k: [] for k in params}
        for s in range(0, C, cfg.block_clients):
            blk = slice(s, s + cfg.block_clients)
            bx, by, bsteps = ds.x[blk], ds.y[blk], steps_eff[blk]
            start = {k: v.unsqueeze(0).expand((cfg.block_clients,) + v.shape)
                     for k, v in params.items()}
            transform = None
            if alg.control_variates:
                sc = control.server_control
                ci = {k: v[blk] for k, v in control.client_controls.items()}

                def transform(k, g, _p):
                    return g + sc[k] - ci[k]

            final, losses = self._masked_sgd(start, bx, by, bsteps, indices[blk],
                                             prox_anchor=params, grad_transform=transform)
            deltas = {k: final[k] - params[k] for k in params}
            ok = _finite_client_mask(losses, deltas)
            bw = weight[blk]
            bw_eff = torch.where(ok, bw, 0.0)
            for k, d in deltas.items():
                gated = torch.where(_bcast(ok, d), d.float(), 0.0)
                sum_delta[k] += torch.tensordot(bw_eff, gated, dims=([0], [0]))
            sum_w = sum_w + bw_eff.sum()
            sum_loss = sum_loss + torch.where(ok, bw * losses, 0.0).sum()
            count = count + (bw_eff > 0).sum().float()
            client_loss.append(losses)
            if alg.control_variates:
                # Option II: c_i' - c_i = -c - delta / (K * lr), zero for a
                # client that ran no step; c_i advances only for
                # participants that survived the finiteness gate.
                k_lr = torch.clamp(bsteps, min=1).float() * alg.local_lr
                ran, active = bsteps > 0, bw_eff > 0
                for k, d in deltas.items():
                    dci = torch.where(_bcast(ran, d), -sc[k] - d / _bcast(k_lr, d), 0.0)
                    new_client_state[k].append(ci[k] + torch.where(_bcast(active, d), dci, 0.0))
                    sum_dc[k] += torch.tensordot(
                        bw_eff, torch.where(_bcast(ok, d), dci, 0.0), dims=([0], [0]))
            elif alg.personalized:
                v_old = {k: v[blk] for k, v in personal.params.items()}
                new_v, ploss_sum = self._personal_train(
                    v_old, params, bx, by, bsteps, bw, personal_indices[blk])
                sum_ploss = sum_ploss + ploss_sum
                for k, v in new_v.items():
                    new_client_state[k].append(v)

        denom = torch.clamp(sum_w, min=1e-8)
        # The server optimizer consumes the negative mean delta as a
        # pseudo-gradient (FedOpt formulation).
        pseudo_grad = {k: -(s / denom) for k, s in sum_delta.items()}
        updates, opt_state = alg.server_optimizer.update(pseudo_grad, state.opt_state)
        new_params = {k: p + updates[k] for k, p in params.items()}
        metrics = RoundMetrics(
            mean_loss=sum_loss / denom,
            weight_sum=sum_w,
            clients_trained=count,
            client_loss=torch.cat(client_loss),
            personal_loss=sum_ploss / denom,
        )
        new_state = ServerState(params=new_params, opt_state=opt_state,
                                round_idx=state.round_idx + 1,
                                generator=state.generator)
        if alg.control_variates or alg.personalized:
            per_client = {k: torch.cat(v) for k, v in new_client_state.items()}
        if alg.control_variates:
            # c <- c + (|S| / N) * weighted-mean refresh, N the true
            # population (survives padding and take()).
            frac = count / max(float(ds.population), 1.0)
            server_c = {k: c + frac * (sum_dc[k] / denom)
                        for k, c in control.server_control.items()}
            return new_state, metrics, ControlState(per_client, server_c)
        if alg.personalized:
            return new_state, metrics, PersonalState(per_client)
        return new_state, metrics

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
        okp = _finite_client_mask(plosses, v)
        keep = okp | ~participating
        v = {k: torch.where(_bcast(keep, t), t, v_old[k]) for k, t in v.items()}
        return v, torch.where(participating & okp, bw * plosses, 0.0).sum()

    # ----------------------------------------------------------------- eval
    @torch.no_grad()
    def evaluate(self, params: Params, x, y) -> Tuple[float, float]:
        """Centralized eval of the global model in batches of
        ``eval_batch_size``; host arrays are moved to the params' device
        batch by batch."""
        dev = next(iter(params.values())).device
        bs = self.config.eval_batch_size
        n = x.shape[0]
        loss_sum = acc_sum = 0.0
        for i in range(0, n, bs):
            xb = torch.as_tensor(x[i:i + bs]).to(dev)
            yb = torch.as_tensor(y[i:i + bs]).to(dev, torch.int64)
            logits = functional_call(self.model, params, (xb,)).float()
            w = yb.shape[0]
            loss_sum += float(F.cross_entropy(logits, yb)) * w
            acc_sum += float((logits.argmax(-1) == yb).float().mean()) * w
        return loss_sum / n, acc_sum / n

    @torch.no_grad()
    def evaluate_personal(self, personal: PersonalState, ds: ClientDataset,
                          ) -> Tuple[float, float]:
        """Ditto's metric of record: each client's personal model scored in
        f32 on its own valid prefix, averaged over clients by
        ``ds.weight``."""
        B = self.config.block_clients
        C = ds.num_clients
        if C % B:
            raise ValueError(
                f"client count {C} must be a multiple of block_clients={B}; "
                f"pad with ClientDataset.pad_for(block)"
            )

        def one(v, xc, yc, ns):
            v = {k: t.float() if t.is_floating_point() else t for k, t in v.items()}
            logits = functional_call(self.model, v, (xc,)).float()
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
        w = torch.clamp(sums[2], min=1e-8)
        return float(sums[0] / w), float(sums[1] / w)


def build_fedcore(model_name: str, algorithm: Algorithm,
                  config: FedCoreConfig = FedCoreConfig(),
                  model_overrides: Optional[dict] = None,
                  input_shape: Optional[Tuple[int, ...]] = None,
                  device="cuda") -> FedCore:
    """Convenience constructor from the model registry. ``input_shape`` is
    one example's shape (default the registry's ``example_input_shape``),
    from which the model takes its input widths. ``device`` is checked here
    (a CUDA request without CUDA raises); parameters are placed by
    :meth:`FedCore.init_state`."""
    from olearning_sim_tpu_torch.models import get_model

    resolve_device(device)
    spec = get_model(model_name)
    with torch.device("meta"):
        model = spec.build(input_shape=input_shape, **(model_overrides or {}))
    return FedCore(model, algorithm, config)
