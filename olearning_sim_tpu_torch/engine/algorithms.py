"""Federated-learning algorithms, with optax's update rules written out.

An :class:`Algorithm` pairs plain local SGD (run per client inside the
round, ``engine/fedcore.py``) with a server optimizer applied to the
aggregated pseudo-gradient, the negative weighted-mean client delta
(the FedOpt formulation: FedAvg is server SGD(1.0), FedAdam server Adam).

A server optimizer is functional: ``init(params) -> state`` and
``update(grads, state) -> (updates, state)`` over dicts of tensors, with
``new_params = params + updates`` as in ``optax.apply_updates``. The
formulas follow optax 0.2.6 term for term (``optax.sgd``, ``optax.adam``,
``optax.yogi``, ``optax.adagrad``) so the parity tests can hold them
against it.

Besides the server optimizer an algorithm may carry a FedProx proximal
coefficient (``prox_mu``), Ditto personalization (``personalized``,
``ditto_lambda``) or SCAFFOLD control variates (``control_variates``); the
round engine reads them. Every factory of the JAX package is here, with
its defaults, and :func:`from_config` picks one by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd(lr, momentum)``: ``trace = g + momentum * trace``;
    update ``-lr * trace`` (no trace kept when momentum is 0)."""

    lr: float
    momentum: float = 0.0

    def init(self, params: Params) -> dict:
        if not self.momentum:
            return {}
        return {"trace": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, grads: Params, state: dict) -> Tuple[Params, dict]:
        if not self.momentum:
            return {k: g * -self.lr for k, g in grads.items()}, state
        trace = {k: g + self.momentum * state["trace"][k] for k, g in grads.items()}
        return {k: t * -self.lr for k, t in trace.items()}, {"trace": trace}


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(lr, b1, b2, eps)``: first and second moments as EMAs,
    bias-corrected by ``1 - b**count``, update
    ``-lr * mu_hat / (sqrt(nu_hat) + eps)`` (eps outside the sqrt)."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Params) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    def update(self, grads: Params, state: dict) -> Tuple[Params, dict]:
        count = state["count"] + 1
        mu = {k: (1 - self.b1) * g + self.b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - self.b2) * (g * g) + self.b2 * state["nu"][k]
              for k, g in grads.items()}
        # optax computes the correction in f32 from an int32 count.
        c1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** count
        c2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** count
        updates = {}
        for k in grads:
            mu_hat = mu[k] / c1.to(mu[k].device)
            nu_hat = nu[k] / c2.to(nu[k].device)
            updates[k] = -self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return updates, {"count": count, "mu": mu, "nu": nu}


@dataclasses.dataclass(frozen=True)
class Yogi:
    """``optax.yogi(lr, b1, b2, eps)``: Adam's first moment, an additive
    second moment ``nu <- nu - (1 - b2) * sign(nu - g^2) * g^2``, both
    initialised to 1e-6 (not 0), bias-corrected like Adam, update
    ``-lr * mu_hat / (sqrt(nu_hat) + eps)``."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-3

    def init(self, params: Params) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.full_like(p, 1e-6) for k, p in params.items()},
            "nu": {k: torch.full_like(p, 1e-6) for k, p in params.items()},
        }

    def update(self, grads: Params, state: dict) -> Tuple[Params, dict]:
        count = state["count"] + 1
        mu = {k: (1 - self.b1) * g + self.b1 * state["mu"][k] for k, g in grads.items()}
        nu = {}
        for k, g in grads.items():
            g2, v = g * g, state["nu"][k]
            nu[k] = v - (1 - self.b2) * torch.sign(v - g2) * g2
        c1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** count
        c2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** count
        updates = {}
        for k in grads:
            mu_hat = mu[k] / c1.to(mu[k].device)
            nu_hat = nu[k] / c2.to(nu[k].device)
            updates[k] = -self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return updates, {"count": count, "mu": mu, "nu": nu}


@dataclasses.dataclass(frozen=True)
class Adagrad:
    """``optax.adagrad(lr, initial_accumulator_value=0.0, eps)``: ``s <- s +
    g^2`` from ``s = 0``; update ``-lr * g * where(s > 0, rsqrt(s + eps), 0)``."""

    lr: float
    eps: float = 1e-7

    def init(self, params: Params) -> dict:
        return {"sum_of_squares": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, grads: Params, state: dict) -> Tuple[Params, dict]:
        sq = {k: g * g + state["sum_of_squares"][k] for k, g in grads.items()}
        updates = {}
        for k, g in grads.items():
            inv = torch.where(sq[k] > 0, torch.rsqrt(sq[k] + self.eps), 0.0)
            updates[k] = -self.lr * (inv * g)
        return updates, {"sum_of_squares": sq}


@dataclasses.dataclass(frozen=True)
class Algorithm:
    name: str
    local_lr: float  # plain local SGD step size
    server_optimizer: object
    # FedProx: 0.5 * prox_mu * ||p - w_global||^2 added to the local loss.
    prox_mu: float = 0.0
    # Ditto: per-client personal params trained beside the global ones with
    # an L2 pull of strength ditto_lambda toward the global model.
    personalized: bool = False
    ditto_lambda: float = 0.0
    # SCAFFOLD: per-client controls c_i and a server control c; local
    # gradients become g + c - c_i (option-II refresh by local_lr).
    control_variates: bool = False


def fedavg(local_lr: float = 0.05, server_lr: float = 1.0,
           server_momentum: float = 0.0) -> Algorithm:
    return Algorithm("fedavg", local_lr, SGD(server_lr, server_momentum))


def fedprox(local_lr: float = 0.05, mu: float = 0.01, server_lr: float = 1.0) -> Algorithm:
    return Algorithm("fedprox", local_lr, SGD(server_lr), prox_mu=mu)


def fedadam(local_lr: float = 0.05, server_lr: float = 1e-2, b1: float = 0.9,
            b2: float = 0.99, eps: float = 1e-3) -> Algorithm:
    return Algorithm("fedadam", local_lr, Adam(server_lr, b1=b1, b2=b2, eps=eps))


def fedyogi(local_lr: float = 0.05, server_lr: float = 1e-2, b1: float = 0.9,
            b2: float = 0.99, eps: float = 1e-3) -> Algorithm:
    """FedYogi (Reddi et al. 2021): Yogi's additive second moment moves less
    than Adam's EMA when pseudo-gradients are sparse or bursty."""
    return Algorithm("fedyogi", local_lr, Yogi(server_lr, b1=b1, b2=b2, eps=eps))


def fedadagrad(local_lr: float = 0.05, server_lr: float = 1e-2,
               eps: float = 1e-3) -> Algorithm:
    """FedAdagrad (Reddi et al. 2021)."""
    return Algorithm("fedadagrad", local_lr, Adagrad(server_lr, eps=eps))


def fedavgm(local_lr: float = 0.05, server_lr: float = 1.0,
            server_momentum: float = 0.9) -> Algorithm:
    """FedAvgM (Hsu et al. 2019): server momentum over round deltas."""
    return Algorithm("fedavgm", local_lr, SGD(server_lr, server_momentum))


def ditto(local_lr: float = 0.05, lam: float = 0.1, server_lr: float = 1.0) -> Algorithm:
    return Algorithm("ditto", local_lr, SGD(server_lr), personalized=True,
                     ditto_lambda=lam)


def scaffold(local_lr: float = 0.05, server_lr: float = 1.0) -> Algorithm:
    """SCAFFOLD (Karimireddy et al. 2020): control variates correct client
    drift under non-IID data (``ControlState`` in the round engine)."""
    return Algorithm("scaffold", local_lr, SGD(server_lr), control_variates=True)


_FACTORIES = {
    "fedavg": fedavg,
    "fedavgm": fedavgm,
    "fedprox": fedprox,
    "fedadam": fedadam,
    "fedyogi": fedyogi,
    "fedadagrad": fedadagrad,
    "ditto": ditto,
    "scaffold": scaffold,
}


def from_config(name: str, **kwargs) -> Algorithm:
    if name not in _FACTORIES:
        raise KeyError(f"unknown algorithm {name!r}; known: {sorted(_FACTORIES)}")
    return _FACTORIES[name](**kwargs)

