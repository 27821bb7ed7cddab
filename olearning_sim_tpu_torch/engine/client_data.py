"""Client populations as tensors with a leading client axis.

The whole simulated population's data is one set of arrays ``[C, n_local,
...]``, padded to a rectangle, so one round advances every client.
Heterogeneous data sizes ride as ``num_samples`` (valid prefix length):
minibatch indices are drawn below it and aggregation weights are
proportional to it, so padding never trains.

The generators are numpy, copied from the JAX package's
``engine/client_data.py`` so that one seed gives the same arrays in both:
Gaussian class blobs (:func:`make_synthetic_dataset`, the mlp2 and cnn4
tasks' populations), per-class tiled textures
(:func:`make_synthetic_texture_dataset`, learnable by a conv + pooling
model) and token bands (:func:`make_synthetic_text_dataset`), each with
its held-out eval set.
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
    # Size of the population this dataset was drawn from; differs from
    # num_real_clients only after :meth:`take`, so SCAFFOLD's server-control
    # fraction |S|/N sees the true N under partial participation. None:
    # num_real_clients.
    population_size: Optional[int] = None

    @property
    def num_clients(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_local(self) -> int:
        return int(self.x.shape[1])

    @property
    def population(self) -> int:
        """True unpadded population size N (survives :meth:`take`)."""
        return (self.num_real_clients if self.population_size is None
                else self.population_size)

    def take(self, indices) -> "ClientDataset":
        """Host-side row selection (a cohort); the result keeps the
        parent's :attr:`population`."""
        idx = np.asarray(indices)
        return ClientDataset(
            x=np.asarray(self.x)[idx], y=np.asarray(self.y)[idx],
            num_samples=np.asarray(self.num_samples)[idx],
            client_uid=np.asarray(self.client_uid)[idx],
            weight=np.asarray(self.weight)[idx],
            num_real_clients=int(len(idx)), population_size=self.population,
        )

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
            population_size=self.population_size,
        )

    def to(self, device="cuda", feature_dtype: Optional[torch.dtype] = torch.bfloat16,
           ) -> "ClientDataset":
        """The dataset as tensors on ``device``: floating-point features in
        ``feature_dtype`` (bf16 by default, as the JAX package's ``place``
        stores them: the models compute in bf16 anyway; ``None`` keeps the
        host dtype), integer features (token ids) in their own dtype,
        labels, counts and ids as int64, weights as float32."""
        dev = resolve_device(device)

        def put(a, dtype=None):
            return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

        x = put(self.x)
        if feature_dtype is not None and x.is_floating_point():
            x = x.to(feature_dtype)
        return ClientDataset(
            x=x, y=put(self.y, torch.int64),
            num_samples=put(self.num_samples, torch.int64),
            client_uid=put(self.client_uid, torch.int64),
            weight=put(self.weight, torch.float32),
            num_real_clients=self.num_real_clients,
            population_size=self.population_size,
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


def _draw_client_labels(rng, num_clients: int, n_local: int,
                        num_classes: int,
                        dirichlet_alpha: Optional[float]) -> np.ndarray:
    """Per-client label draw: IID or Dirichlet(alpha) label skew, realized
    with one vectorized inverse-CDF pass."""
    if dirichlet_alpha is None:
        probs = np.full((num_clients, num_classes), 1.0 / num_classes)
    else:
        probs = rng.dirichlet([dirichlet_alpha] * num_classes, size=num_clients)
    cum = probs.cumsum(axis=1)
    u = rng.random((num_clients, n_local))
    y = (u[..., None] > cum[:, None, :]).sum(axis=-1).astype(np.int32)
    np.clip(y, 0, num_classes - 1, out=y)  # guard fp roundoff at the edge
    return y


def make_synthetic_dataset(
    seed: int,
    num_clients: int,
    n_local: int,
    input_shape: Tuple[int, ...],
    num_classes: int,
    dirichlet_alpha: Optional[float] = None,
    dtype: np.dtype = np.float32,
    class_sep: float = 2.0,
    num_samples_range: Optional[Tuple[int, int]] = None,
) -> ClientDataset:
    """Learnable synthetic classification population (Gaussian class blobs):
    client samples are mu_y + unit noise. ``dirichlet_alpha`` gives
    Dirichlet(alpha) label skew per client; ``None`` means IID."""
    rng = np.random.default_rng(seed)
    feat_dim = int(np.prod(input_shape))
    # f32 up front: an f64 means table would make means[y] materialize a
    # [C, n, F] float64 temporary before the cast.
    means = _class_means(seed, num_classes, feat_dim, class_sep).astype(np.float32)

    y = _draw_client_labels(rng, num_clients, n_local, num_classes, dirichlet_alpha)
    if num_samples_range is None:
        num_samples = np.full(num_clients, n_local, np.int32)
    else:
        lo, hi = num_samples_range
        num_samples = rng.integers(lo, hi + 1, size=num_clients).astype(np.int32)
        num_samples = np.minimum(num_samples, n_local)
    x = rng.standard_normal((num_clients, n_local, feat_dim), dtype=np.float32)
    x += means[y]
    x = x.astype(dtype, copy=False).reshape(num_clients, n_local, *input_shape)

    return ClientDataset(
        x=x,
        y=y,
        num_samples=num_samples,
        client_uid=np.arange(num_clients, dtype=np.int32),
        weight=num_samples.astype(np.float32),
        num_real_clients=num_clients,
    )


def _class_means(seed: int, num_classes: int, feat_dim: int, class_sep: float) -> np.ndarray:
    """Class-mean vectors shared by the train population and the eval set,
    from a dedicated stream."""
    rng = np.random.default_rng([seed, 0xC1A55])
    return rng.normal(0.0, class_sep / np.sqrt(feat_dim), size=(num_classes, feat_dim))


def make_central_eval_set(
    seed: int,
    n: int,
    input_shape: Tuple[int, ...],
    num_classes: int,
    class_sep: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Held-out eval set drawn from the same blob distribution (IID)."""
    rng = np.random.default_rng([seed, 0xE7A1])
    feat_dim = int(np.prod(input_shape))
    means = _class_means(seed, num_classes, feat_dim, class_sep)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = (means[y] + rng.normal(0.0, 1.0, size=(n, feat_dim))).astype(np.float32)
    return x.reshape(n, *input_shape), y


def _class_textures(seed: int, num_classes: int, shape: Tuple[int, ...],
                    class_sep: float, cell: int = 4) -> np.ndarray:
    """Per-class tiled texture patterns [ncls, H, W, C]: a small per-class
    cell tiled across the image, so the signal is local and
    translation-invariant (what convolutions plus average pooling detect)."""
    H, W, C = shape
    rng = np.random.default_rng([seed, 0x7E87])
    cells = rng.normal(0.0, 1.0, size=(num_classes, cell, cell, C))
    reps = (-(-H // cell), -(-W // cell))  # ceil
    tiled = np.tile(cells, (1, reps[0], reps[1], 1))[:, :H, :W, :]
    # Noise is sigma 1, so class_sep scales the texture against it.
    scale = class_sep / np.sqrt(cell * cell * C)
    return (tiled * scale).astype(np.float32)


def make_synthetic_texture_dataset(
    seed: int,
    num_clients: int,
    n_local: int,
    input_shape: Tuple[int, ...],
    num_classes: int,
    dirichlet_alpha: Optional[float] = None,
    class_sep: float = 2.0,
) -> ClientDataset:
    """Conv-learnable synthetic image population: per-class tiled textures
    plus unit Gaussian noise; label skew and weights as in
    :func:`make_synthetic_dataset`."""
    rng = np.random.default_rng(seed)
    textures = _class_textures(seed, num_classes, input_shape, class_sep)
    y = _draw_client_labels(rng, num_clients, n_local, num_classes, dirichlet_alpha)
    x = rng.standard_normal((num_clients, n_local) + tuple(input_shape), dtype=np.float32)
    x += textures[y]
    num_samples = np.full(num_clients, n_local, np.int32)
    return ClientDataset(
        x=x, y=y, num_samples=num_samples,
        client_uid=np.arange(num_clients, dtype=np.int32),
        weight=num_samples.astype(np.float32),
        num_real_clients=num_clients,
    )


def make_texture_eval_set(
    seed: int,
    n: int,
    input_shape: Tuple[int, ...],
    num_classes: int,
    class_sep: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Held-out eval set from the same texture distribution."""
    rng = np.random.default_rng([seed, 0xE7A2])
    textures = _class_textures(seed, num_classes, input_shape, class_sep)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = textures[y] + rng.normal(0.0, 1.0, size=(n,) + tuple(input_shape)).astype(np.float32)
    return x.astype(np.float32), y
