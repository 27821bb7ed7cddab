"""Client partitioners: real labels -> federated populations.

The reference stages pre-partitioned per-client archives (its
``HybridDataSplitter`` re-splits them with sklearn ``train_test_split``,
``ols_core/taskMgr/utils/utils_runner.py:195-382``); the rebuild partitions
centrally-loaded arrays into the engine's rectangular ``ClientDataset``:

- ``dirichlet``: label-skew non-IID (Dirichlet(alpha) over classes per
  client — the BASELINE configs' non-IID recipe).
- ``iid``: uniform shuffle-split.
- ``by_writer``: natural partition (FEMNIST writers, Sent140 users).

A copy of the JAX package's ``data/partition.py``: the same draws from the
same seed, packed into the port's host-numpy ``ClientDataset``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from olearning_sim_tpu_torch.engine.client_data import ClientDataset


def iid_assignments(n: int, num_clients: int, rng: np.random.Generator) -> List[np.ndarray]:
    idx = rng.permutation(n)
    return [np.sort(part) for part in np.array_split(idx, num_clients)]


def dirichlet_assignments(
    y: np.ndarray, num_clients: int, alpha: float, rng: np.random.Generator
) -> List[np.ndarray]:
    """Non-IID label-skew split: each client draws class proportions from
    Dirichlet(alpha); samples of each class are dealt to clients according
    to the normalized per-class column of the proportion matrix. Every
    sample is assigned exactly once (deal-without-replacement, unlike
    naive per-client sampling which duplicates/drops rows)."""
    y = np.asarray(y)
    classes = np.unique(y)
    props = rng.dirichlet([alpha] * len(classes), size=num_clients)  # [C, K]
    out: List[List[np.ndarray]] = [[] for _ in range(num_clients)]
    for k, cls in enumerate(classes):
        rows = rng.permutation(np.flatnonzero(y == cls))
        col = props[:, k]
        if col.sum() <= 0:
            col = np.full(num_clients, 1.0 / num_clients)
        cuts = (np.cumsum(col / col.sum()) * len(rows)).astype(int)[:-1]
        for ci, part in enumerate(np.split(rows, cuts)):
            out[ci].append(part)
    return [np.sort(np.concatenate(parts)) if parts else np.empty(0, int) for parts in out]


def writer_assignments(
    writer: np.ndarray, num_clients: int, rng: np.random.Generator
) -> List[np.ndarray]:
    """Natural partition: one client per writer/user. If there are more
    writers than requested clients, writers are grouped round-robin; if
    fewer, the surplus clients get empty shards (weight 0 downstream)."""
    writer = np.asarray(writer)
    wids = rng.permutation(np.unique(writer))
    out: List[List[np.ndarray]] = [[] for _ in range(num_clients)]
    for i, w in enumerate(wids):
        out[i % num_clients].append(np.flatnonzero(writer == w))
    return [np.sort(np.concatenate(p)) if p else np.empty(0, int) for p in out]


def to_client_dataset(
    x: np.ndarray,
    y: np.ndarray,
    assignments: Sequence[np.ndarray],
    n_local: int,
    rng: Optional[np.random.Generator] = None,
    min_samples: int = 1,
) -> ClientDataset:
    """Pack per-client index lists into the engine's rectangular arrays.

    Clients with more than ``n_local`` samples are subsampled (without
    replacement); clients with fewer keep what they have (``num_samples``
    marks the valid prefix; padding rows are zeros and carry no weight
    because minibatch indices are drawn in ``[0, num_samples)``). Clients
    under ``min_samples`` get weight 0 (never sampled, never aggregated) —
    the deviceflow trace compiler treats them like churned-out devices.
    """
    rng = rng or np.random.default_rng(0)
    C = len(assignments)
    xs = np.zeros((C, n_local) + x.shape[1:], x.dtype)
    ys = np.zeros((C, n_local), np.int32)
    ns = np.zeros(C, np.int32)
    for ci, idx in enumerate(assignments):
        idx = np.asarray(idx)
        if len(idx) > n_local:
            idx = rng.choice(idx, size=n_local, replace=False)
        ns[ci] = len(idx)
        if len(idx):
            xs[ci, : len(idx)] = x[idx]
            ys[ci, : len(idx)] = y[idx]
    weight = np.where(ns >= min_samples, ns, 0).astype(np.float32)
    return ClientDataset(
        x=xs,
        y=ys,
        num_samples=np.maximum(ns, 1),
        client_uid=np.arange(C, dtype=np.int32),
        weight=weight,
        num_real_clients=C,
    )


def partition(
    x: np.ndarray,
    y: np.ndarray,
    num_clients: int,
    n_local: int,
    scheme: str = "dirichlet",
    alpha: float = 0.5,
    writer: Optional[np.ndarray] = None,
    seed: int = 0,
) -> ClientDataset:
    """One-call partitioner used by the task bridge."""
    rng = np.random.default_rng(seed)
    if scheme == "by_writer":
        if writer is None:
            raise ValueError("scheme='by_writer' needs a writer array (FEMNIST/Sent140 formats provide one)")
        asg = writer_assignments(writer, num_clients, rng)
    elif scheme == "dirichlet":
        asg = dirichlet_assignments(y, num_clients, alpha, rng)
    elif scheme == "iid":
        asg = iid_assignments(len(y), num_clients, rng)
    else:
        raise ValueError(f"unknown partition scheme {scheme!r}")
    return to_client_dataset(x, y, asg, n_local, rng)
