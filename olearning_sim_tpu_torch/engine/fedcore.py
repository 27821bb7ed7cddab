"""FedCore — the federated round engine, synchronous variant on one device.

The port of the plain round program of the JAX package's ``engine/fedcore.py``,
with dp = 1 (the JAX package's ``psum`` over dp is the local sum here)::

    round_step = for each block of ``block_clients`` clients:
                     vmap over clients: masked local SGD, max_local_steps steps
                     finiteness gate, weighted delta sum
                 -> server optimizer on the negative mean delta

Heterogeneity is masking, as in the JAX engine: step ``i`` of a client is
active iff ``i < num_steps[c]``; minibatch indices are drawn in
``[0, num_samples[c])``; aggregation weights are 0 for padded or
non-participating clients. Clients of a block are batched with
``torch.func.vmap(grad(functional_call))``.

Randomness is explicit: the minibatch indices ``[C, max_local_steps,
batch_size]`` come from the ``torch.Generator`` in :class:`ServerState`,
or from the caller (``round_step(..., indices=...)``). The port does not
reproduce JAX's threefry stream; the parity tests hand both engines the
same indices instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call, grad_and_value, vmap

from olearning_sim_tpu_torch.device import resolve_device
from olearning_sim_tpu_torch.engine.algorithms import Algorithm
from olearning_sim_tpu_torch.engine.client_data import ClientDataset

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FedCoreConfig:
    batch_size: int = 32
    max_local_steps: int = 10
    # Clients vmapped at once; the loop over blocks bounds peak memory
    # (activations scale with block_clients * batch_size, not population).
    block_clients: int = 64
    eval_batch_size: int = 1024
    # Minibatch realization. "gather": gather the drawn rows.
    # "multiplicity": weight the client's full local set by how often each
    # row was drawn — the same gradient and loss for the same indices (up
    # to float summation order), without a gather. "auto" picks
    # multiplicity when n_local <= 2 * batch_size.
    sample_mode: str = "auto"

    def __post_init__(self):
        for fld in ("batch_size", "max_local_steps", "block_clients",
                    "eval_batch_size"):
            v = getattr(self, fld)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"FedCoreConfig.{fld} must be an int >= 1, got {v!r}")
        if self.sample_mode not in ("auto", "gather", "multiplicity"):
            raise ValueError(f"unknown sample_mode {self.sample_mode!r}")

    def use_multiplicity(self, n_local: int) -> bool:
        if self.sample_mode == "auto":
            return n_local <= 2 * self.batch_size
        return self.sample_mode == "multiplicity"

    @classmethod
    def from_dict(cls, obj: dict) -> "FedCoreConfig":
        """Engine-params JSON shape (``{"fedcore": {...}}``); unknown keys
        are rejected so that a typo fails at submit time, not mid-round."""
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
        return cls(**kw)


@dataclasses.dataclass
class ServerState:
    """Global FL state carried across rounds."""

    params: Params
    opt_state: dict
    round_idx: int
    generator: torch.Generator  # CPU stream of minibatch indices


@dataclasses.dataclass
class RoundMetrics:
    mean_loss: torch.Tensor        # weight-averaged local training loss
    weight_sum: torch.Tensor       # total aggregation weight (participants)
    clients_trained: torch.Tensor  # number of clients with weight > 0
    # Per-client mean local loss [C]; NaN for a client that ran no step.
    client_loss: torch.Tensor


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

    def _local_train(self, params: Params, x, y, steps_eff,
                     idx) -> Tuple[Params, torch.Tensor]:
        """Masked local SGD for one block of clients: ``x [Cb, n_local,
        ...]``, ``steps_eff [Cb]``, ``idx [Cb, S, B]``. Returns the
        per-client deltas ``[Cb, ...]`` and mean losses ``[Cb]`` (NaN for a
        client that ran no step: "no work" must not read as success)."""
        cfg = self.config
        lr = self.algorithm.local_lr
        cb, n_local = x.shape[0], x.shape[1]
        rows = torch.arange(cb, device=x.device)[:, None]
        p = {k: v.unsqueeze(0).expand((cb,) + tuple(v.shape)) for k, v in params.items()}
        total = torch.zeros(cb, dtype=torch.float32, device=x.device)
        mult = cfg.use_multiplicity(n_local)
        step_fn = vmap(grad_and_value(
            self._loss_multiplicity if mult else self._loss_gather))
        for i in range(cfg.max_local_steps):
            bi = idx[:, i]
            if mult:
                sw = torch.zeros((cb, n_local), dtype=torch.float32, device=x.device)
                sw.scatter_add_(1, bi, torch.ones_like(bi, dtype=torch.float32))
                grads, loss = step_fn(p, x, y, sw / cfg.batch_size)
            else:
                grads, loss = step_fn(p, x[rows, bi], y[rows, bi])
            active = i < steps_eff
            # where, not multiply-by-gate: 0 * non-finite = NaN would let an
            # inactive step corrupt params that must stay frozen.
            p = {k: p[k] + torch.where(_bcast(active, g), g * -lr, 0.0)
                 for k, g in grads.items()}
            total = total + torch.where(active, loss, 0.0)
        mean_loss = torch.where(
            steps_eff > 0,
            total / torch.clamp(steps_eff, min=1).float(),
            torch.full_like(total, float("nan")),
        )
        return {k: p[k] - params[k] for k in p}, mean_loss

    # ----------------------------------------------------------- round step
    def round_step(self, state: ServerState, ds: ClientDataset,
                   participate: Optional[torch.Tensor] = None,
                   num_steps: Optional[torch.Tensor] = None,
                   indices: Optional[torch.Tensor] = None,
                   ) -> Tuple[ServerState, RoundMetrics]:
        """Advance one FL round over the placed, padded population.

        ``participate`` — optional [C] 0/1 mask multiplying the base
        weights. ``num_steps`` — optional per-client local-step counts
        (default ``max_local_steps``). ``indices`` — optional minibatch
        indices ``[C, max_local_steps, batch_size]``; by default they are
        drawn from ``state.generator``."""
        cfg = self.config
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
        weight = ds.weight if participate is None else ds.weight * participate.to(dev)
        if num_steps is None:
            num_steps = torch.full((C,), cfg.max_local_steps, dtype=torch.int64)
        steps_eff = torch.clamp(num_steps.to(dev), max=cfg.max_local_steps)
        if indices is None:
            indices = self.draw_indices(state.generator, ds.num_samples)
        want = (C, cfg.max_local_steps, cfg.batch_size)
        if tuple(indices.shape) != want:
            raise ValueError(f"indices must be {want}, got {tuple(indices.shape)}")
        indices = indices.to(dev, torch.int64)

        params = state.params
        sum_delta = {k: torch.zeros_like(p) for k, p in params.items()}
        sum_w = torch.zeros((), dtype=torch.float32, device=dev)
        sum_loss = torch.zeros_like(sum_w)
        count = torch.zeros_like(sum_w)
        client_loss = []
        for s in range(0, C, cfg.block_clients):
            blk = slice(s, s + cfg.block_clients)
            deltas, losses = self._local_train(
                params, ds.x[blk], ds.y[blk], steps_eff[blk], indices[blk]
            )
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

        denom = torch.clamp(sum_w, min=1e-8)
        # The server optimizer consumes the negative mean delta as a
        # pseudo-gradient (FedOpt formulation).
        pseudo_grad = {k: -(s / denom) for k, s in sum_delta.items()}
        updates, opt_state = self.algorithm.server_optimizer.update(
            pseudo_grad, state.opt_state
        )
        new_params = {k: p + updates[k] for k, p in params.items()}
        metrics = RoundMetrics(
            mean_loss=sum_loss / denom,
            weight_sum=sum_w,
            clients_trained=count,
            client_loss=torch.cat(client_loss),
        )
        new_state = ServerState(params=new_params, opt_state=opt_state,
                                round_idx=state.round_idx + 1,
                                generator=state.generator)
        return new_state, metrics

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


def build_fedcore(model_name: str, algorithm: Algorithm,
                  config: FedCoreConfig = FedCoreConfig(),
                  model_overrides: Optional[dict] = None,
                  device="cuda") -> FedCore:
    """Convenience constructor from the model registry. ``device`` is
    checked here (a CUDA request without CUDA raises); parameters are
    placed by :meth:`FedCore.init_state`."""
    from olearning_sim_tpu_torch.models import get_model

    resolve_device(device)
    spec = get_model(model_name)
    with torch.device("meta"):
        model = spec.build(**(model_overrides or {}))
    return FedCore(model, algorithm, config)
