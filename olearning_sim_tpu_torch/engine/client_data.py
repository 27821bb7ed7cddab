"""Client populations as tensors with a leading client axis.

The whole simulated population's data is one set of arrays ``[C, n_local,
...]``, padded to a rectangle, so one round advances every client.
Heterogeneous data sizes ride as ``num_samples`` (valid prefix length):
minibatch indices are drawn below it and aggregation weights are
proportional to it, so padding never trains.

The generators are numpy, copied from the JAX package's
``engine/client_data.py`` so that one seed gives the same arrays in both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from olearning_sim_tpu_torch.device import resolve_device

Array = Union[np.ndarray, torch.Tensor]


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


@dataclasses.dataclass
class ClientDataset:
    """A client population (host numpy until :meth:`to`).

      x            [C, n_local, *feature]   features (token ids for text)
      y            [C, n_local]             integer labels
      num_samples  [C]                      valid samples per client
      client_uid   [C]                      stable global client id
      weight       [C]                      base aggregation weight (0 = padding)
    """

    x: Array
    y: Array
    num_samples: Array
    client_uid: Array
    weight: Array
    num_real_clients: int

    @property
    def num_clients(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_local(self) -> int:
        return int(self.x.shape[1])

    def pad_for(self, block: int) -> "ClientDataset":
        """Pad the client axis to a multiple of ``block`` with inert clients
        (weight 0, ``num_samples`` 1)."""
        extra = pad_to_multiple(self.num_clients, block) - self.num_clients
        if extra == 0:
            return self

        def pad0(a):
            a = np.asarray(a)
            return np.pad(a, [(0, extra)] + [(0, 0)] * (a.ndim - 1))

        ns = pad0(self.num_samples)
        ns[self.num_clients:] = 1  # weight 0 keeps them inert
        return ClientDataset(
            x=pad0(self.x), y=pad0(self.y), num_samples=ns,
            client_uid=pad0(self.client_uid), weight=pad0(self.weight),
            num_real_clients=self.num_real_clients,
        )

    def to(self, device="cuda") -> "ClientDataset":
        """The dataset as tensors on ``device``: features in their own
        dtype, labels, counts and ids as int64, weights as float32."""
        dev = resolve_device(device)

        def put(a, dtype=None):
            return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

        return ClientDataset(
            x=put(self.x), y=put(self.y, torch.int64),
            num_samples=put(self.num_samples, torch.int64),
            client_uid=put(self.client_uid, torch.int64),
            weight=put(self.weight, torch.float32),
            num_real_clients=self.num_real_clients,
        )


def make_synthetic_text_dataset(
    seed: int,
    num_clients: int,
    n_local: int,
    seq_len: int,
    num_classes: int = 2,
    vocab_size: int = 30522,
    dirichlet_alpha: Optional[float] = None,
    signal_frac: float = 0.5,
    num_samples_range: Optional[Tuple[int, int]] = None,
) -> ClientDataset:
    """Learnable synthetic token population for the text family (Sent140
    stand-in). Each class owns a token band; a ``signal_frac`` fraction of each
    sequence is drawn from the class band, the rest uniformly — so an
    embedding-pool probe can learn the label. Token 0 is reserved for padding.
    """
    rng = np.random.default_rng([seed, 0x7E87])
    if dirichlet_alpha is None:
        probs = np.full((num_clients, num_classes), 1.0 / num_classes)
    else:
        probs = rng.dirichlet([dirichlet_alpha] * num_classes, size=num_clients)

    if num_samples_range is None:
        num_samples = np.full(num_clients, n_local, np.int32)
    else:
        lo, hi = num_samples_range
        num_samples = rng.integers(lo, hi + 1, size=num_clients).astype(np.int32)
        num_samples = np.minimum(num_samples, n_local)

    band = (vocab_size - 1) // num_classes
    y = np.empty((num_clients, n_local), np.int32)
    for c in range(num_clients):
        y[c] = rng.choice(num_classes, size=n_local, p=probs[c])
    uniform = rng.integers(1, vocab_size, size=(num_clients, n_local, seq_len))
    in_band = 1 + y[..., None] * band + rng.integers(
        0, max(band, 1), size=(num_clients, n_local, seq_len)
    )
    use_band = rng.random((num_clients, n_local, seq_len)) < signal_frac
    x = np.where(use_band, in_band, uniform).astype(np.int32)

    return ClientDataset(
        x=x,
        y=y,
        num_samples=num_samples,
        client_uid=np.arange(num_clients, dtype=np.int32),
        weight=num_samples.astype(np.float32),
        num_real_clients=num_clients,
    )


def make_central_text_eval_set(
    seed: int,
    n: int,
    seq_len: int,
    num_classes: int = 2,
    vocab_size: int = 30522,
    signal_frac: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Held-out token eval set from the same band distribution (IID)."""
    rng = np.random.default_rng([seed, 0x7E88])
    band = (vocab_size - 1) // num_classes
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    uniform = rng.integers(1, vocab_size, size=(n, seq_len))
    in_band = 1 + y[:, None] * band + rng.integers(0, max(band, 1), size=(n, seq_len))
    use_band = rng.random((n, seq_len)) < signal_frac
    return np.where(use_band, in_band, uniform).astype(np.int32), y
