"""Federated-learning algorithms, with optax's update rules written out.

An :class:`Algorithm` pairs plain local SGD (run per client inside the
round, ``engine/fedcore.py``) with a server optimizer applied to the
aggregated pseudo-gradient, the negative weighted-mean client delta
(the FedOpt formulation: FedAvg is server SGD(1.0), FedAdam server Adam).

A server optimizer is functional: ``init(params) -> state`` and
``update(grads, state) -> (updates, state)`` over dicts of tensors, with
``new_params = params + updates`` as in ``optax.apply_updates``. The
formulas follow optax 0.2 term for term (``optax.sgd``, ``optax.adam``) so
the parity tests can hold them against it.

Ported: ``fedavg`` and ``fedadam``. The other factories of the JAX
package (fedprox, fedyogi, fedadagrad, fedavgm, ditto, scaffold) are
queued in ``ROADMAP.md``.
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
class Algorithm:
    name: str
    local_lr: float  # plain local SGD step size
    server_optimizer: object


def fedavg(local_lr: float = 0.05, server_lr: float = 1.0,
           server_momentum: float = 0.0) -> Algorithm:
    return Algorithm("fedavg", local_lr, SGD(server_lr, server_momentum))


def fedadam(local_lr: float = 0.05, server_lr: float = 1e-2, b1: float = 0.9,
            b2: float = 0.99, eps: float = 1e-3) -> Algorithm:
    return Algorithm("fedadam", local_lr, Adam(server_lr, b1=b1, b2=b2, eps=eps))

