"""Federated rounds, written from the algorithms' definitions.

One round over a population (McMahan et al., arXiv:1602.05629; FedProx, Li
et al., arXiv:1812.06127; FedOpt/FedAdam, Reddi et al., arXiv:2003.00295):

1. every client that trains this round starts from the global model and
   takes ``max_local_steps`` SGD steps at ``local_lr`` on minibatches of
   ``batch_size`` of its rows (labels rotated by its drift shift), the loss
   the mean cross-entropy plus FedProx's ``mu / 2 * ||w - w_global||^2``;
   its loss is the mean of its steps' losses;
2. a client whose loss or update is not finite is left out;
3. the others' updates are averaged with weights ``n_local`` (the rows a
   client holds), and so are their losses;
4. the server optimizer steps on the negative mean update: SGD at
   ``server_lr`` (FedAvg, FedProx), or Adam (FedAdam; bias-corrected
   moments, ``eps`` outside the square root);
5. the global model is evaluated on the central set: mean cross-entropy
   and accuracy.

Clients are trained one by one in plain PyTorch: no ``vmap``, no blocks,
no masks over absent clients. Minibatch rows are drawn as the task's
engine specifies its draw (``round_indices``): from a CPU
``torch.Generator`` seeded with ``SeedSequence([seed, 1, round, 0])``,
a uniform float64 ``u`` per (client, step, slot) over the whole padded
population, row ``min(floor(u * n_local), n_local - 1)``.

Faults the comparison has to catch, put in the program's place:
``fault="half_batch"`` keeps the first half of each minibatch and takes
the mean over it; ``fault="unchanged"`` returns the server state
unchanged from every round (the optimizer gets nothing).

:func:`follow_round` runs one round from a server state it is handed (the
program's after its timed rounds): a check of that round's arithmetic,
not of the rounds that led to the state.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def round_indices(seed: int, round_idx: int, padded_clients: int, steps: int, batch: int,
                  num_samples: np.ndarray) -> torch.Tensor:
    """``[C, steps, batch]`` int64 row indices of one round."""
    s = int(np.random.SeedSequence([seed, 1, round_idx, 0]).generate_state(1, np.uint64)[0])
    g = torch.Generator().manual_seed(s)
    u = torch.rand((padded_clients, steps, batch), generator=g, dtype=torch.float64)
    n = torch.clamp(torch.as_tensor(num_samples, dtype=torch.int64), min=1)
    u = u[:n.shape[0]]
    idx = torch.floor(u * n[:, None, None]).long()
    return torch.minimum(idx, n[:, None, None] - 1)


class ServerOpt:
    """The server optimizer on the negative mean update."""

    def __init__(self, algo: dict):
        name = algo["name"]
        self.adam = name == "fedadam"
        if name not in ("fedadam", "fedprox", "fedavg"):
            raise NotImplementedError(name)
        self.lr = float(algo.get("server_lr", 1e-2 if self.adam else 1.0))
        self.b1, self.b2 = float(algo.get("b1", 0.9)), float(algo.get("b2", 0.99))
        self.eps = float(algo.get("eps", 1e-3))
        self.count = 0
        self.mu: Params = {}
        self.nu: Params = {}

    def step(self, params: Params, grad: Params) -> Params:
        if not self.adam:
            return {k: params[k] - self.lr * grad[k] for k in params}
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        out = {}
        for k, g in grad.items():
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu.get(k, torch.zeros_like(g))
            self.nu[k] = (1 - self.b2) * g * g + self.b2 * self.nu.get(k, torch.zeros_like(g))
            out[k] = params[k] - self.lr * (self.mu[k] / c1) / (
                torch.sqrt(self.nu[k] / c2) + self.eps)
        return out


def local_train(logits_fn: Callable, start: Params, x: torch.Tensor, y: torch.Tensor,
                idx: torch.Tensor, lr: float, mu: float, fault: Optional[str] = None,
                carry: Optional[torch.dtype] = None):
    """One client's local steps; returns ``(final params, mean loss)``, the
    loss a device scalar. FedProx's term enters the loss's value and, as
    its gradient ``mu (w - w_global)``, the step. ``carry`` stores the
    client's parameters between steps in that dtype (each step rounds
    them to it; the control's arithmetic), float32 by default."""
    keys = list(start)
    anchor = [start[k] for k in keys]
    p = [t.to(carry) if carry is not None else t.clone() for t in anchor]
    total = torch.zeros((), device=x.device)
    for i in range(idx.shape[0]):
        rows = idx[i]
        if fault == "half_batch":
            rows = rows[: rows.shape[0] // 2]
        for t in p:
            t.requires_grad_(True)
        loss = F.cross_entropy(logits_fn({k: t.float() for k, t in zip(keys, p)}, x[rows]),
                               y[rows])
        grads = [g.float() for g in torch.autograd.grad(loss, p)]
        with torch.no_grad():
            p = [t.detach().float() for t in p]
            if mu:
                diff = torch._foreach_sub(p, anchor)
                sq = torch.stack(torch._foreach_norm(diff)).square().sum()
                loss = loss + 0.5 * mu * sq
                grads = torch._foreach_add(grads, diff, alpha=mu)
            p = torch._foreach_add(p, grads, alpha=-lr)
            if carry is not None:
                p = [t.to(carry) for t in p]
            total += loss.detach()
    return {k: t.float() for k, t in zip(keys, p)}, total / max(idx.shape[0], 1)


@torch.no_grad()
def evaluate(logits_fn: Callable, params: Params, x: torch.Tensor, y: torch.Tensor,
             chunk: int = 512):
    """``(mean cross-entropy, accuracy)`` over the central set."""
    loss = correct = 0.0
    for i in range(0, x.shape[0], chunk):
        logits = logits_fn(params, x[i:i + chunk]).float()
        yb = y[i:i + chunk]
        loss += float(F.cross_entropy(logits, yb, reduction="sum"))
        correct += float((logits.argmax(-1) == yb).sum())
    return loss / x.shape[0], correct / x.shape[0]


def one_round(logits_fn: Callable, params: Params, opt: ServerOpt, data: dict, rnd: dict,
              r: int, task: dict, fault: Optional[str] = None,
              carry: Optional[torch.dtype] = None) -> dict:
    """Round ``r`` from ``params`` under ``opt``'s state (stepped in place):
    ``params`` (the new global model), ``grad`` (the pseudo-gradient as the
    server optimizer gets it), ``loss``, ``eval_loss``, ``eval_acc``,
    ``trained``. ``data``, ``rnd``, ``task``: as :func:`run_rounds`."""
    algo, fc = task["algorithm"], task["fedcore"]
    lr, mu = float(algo["local_lr"]), float(algo.get("mu", 0.0))
    steps, batch = int(fc["max_local_steps"]), int(fc["batch_size"])
    x, y, ns = data["x"], data["y"], data["num_samples"]
    idx = round_indices(data["seed"], r, data["padded"], steps, batch, ns).to(x.device)
    labels = y
    if rnd["shift"] is not None:
        sh = torch.as_tensor(rnd["shift"], device=y.device)
        labels = (y + sh[:, None]) % int(task["num_classes"])
    keys = list(params)
    sum_delta = [torch.zeros_like(params[k]) for k in keys]
    sum_w = sum_loss = 0.0
    trained = 0
    for c in np.flatnonzero(rnd["train"]):
        final, loss = local_train(logits_fn, params, x[c], labels[c], idx[c], lr, mu, fault,
                                  carry)
        delta = torch._foreach_sub([final[k] for k in keys], [params[k] for k in keys])
        finite = torch.isfinite(loss + torch.stack(torch._foreach_norm(delta)).sum())
        if not bool(finite):
            continue
        w = float(ns[c])
        torch._foreach_add_(sum_delta, delta, alpha=w)
        sum_w += w
        sum_loss += w * float(loss)
        trained += 1
    grad = {k: -s / max(sum_w, 1e-8) for k, s in zip(keys, sum_delta)}
    if fault == "unchanged":
        grad = {k: torch.zeros_like(g) for k, g in grad.items()}
    else:
        params = opt.step(params, grad)
    el, ea = evaluate(logits_fn, params, data["eval_x"], data["eval_y"])
    return {"params": params, "grad": grad, "loss": sum_loss / max(sum_w, 1e-8),
            "eval_loss": el, "eval_acc": ea, "trained": trained}


def run_rounds(logits_fn: Callable, params: Params, data: dict, plan: List[dict],
               task: dict, fault: Optional[str] = None,
               carry: Optional[torch.dtype] = None) -> dict:
    """Train ``len(plan)`` rounds from ``params``. ``data``: ``x``, ``y``
    (on the device), ``num_samples``, ``eval_x``, ``eval_y``, ``seed`` (of
    the minibatch draw) and ``padded`` (the population padded to whole
    blocks). ``plan[r]``: ``train`` ([C] bool) and ``shift`` ([C] or None).
    ``task``: ``algorithm`` and ``fedcore`` of the engine params and
    ``num_classes``. ``carry``: the dtype the clients' parameters are
    stored in between local steps (float32 by default).

    Returns per round ``loss``, ``eval_loss``, ``eval_acc``, ``trained``;
    ``grad1_t`` (per leaf, the pseudo-gradient of round 0, as the server
    optimizer gets it) and ``change_t`` (per leaf, ``w_R - w_0`` after the
    last round), and ``grad1`` and ``change``, their norms."""
    opt = ServerOpt(task["algorithm"])
    w0 = {k: v.clone() for k, v in params.items()}
    out = {"loss": [], "eval_loss": [], "eval_acc": [], "trained": []}
    for r, rnd in enumerate(plan):
        res = one_round(logits_fn, params, opt, data, rnd, r, task, fault, carry)
        params = res["params"]
        if r == 0:
            out["grad1_t"] = res["grad"]
        for key in ("loss", "eval_loss", "eval_acc", "trained"):
            out[key].append(res[key])
    out["change_t"] = {k: params[k] - w0[k] for k in params}
    for key in ("grad1", "change"):
        out[key] = {k: float(t.norm()) for k, t in out[key + "_t"].items()}
    return out


def follow_round(logits_fn: Callable, start: dict, data: dict, rnd: dict, task: dict,
                 fault: Optional[str] = None, carry: Optional[torch.dtype] = None) -> dict:
    """One round from a given server state: ``start`` holds ``params``,
    ``round`` and, for Adam, ``mu``, ``nu`` and ``count``. Returns the
    round's ``loss``, ``grad_t`` (per leaf, the pseudo-gradient as the
    server optimizer gets it) and ``change_t`` (per leaf, the round's
    change of the global model)."""
    opt = ServerOpt(task["algorithm"])
    if opt.adam:
        opt.mu = {k: v.clone() for k, v in start["mu"].items()}
        opt.nu = {k: v.clone() for k, v in start["nu"].items()}
        opt.count = int(start["count"])
    params = start["params"]
    res = one_round(logits_fn, params, opt, data, rnd, int(start["round"]), task, fault, carry)
    return {"loss": res["loss"], "grad_t": res["grad"],
            "change_t": {k: res["params"][k] - params[k] for k in params}}
