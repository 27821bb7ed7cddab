"""Client populations as tensors with a leading client axis.

The whole simulated population's data is one set of arrays ``[C, n_local,
...]``, padded to a rectangle, so one round advances every client.
Heterogeneous data sizes ride as ``num_samples`` (valid prefix length):
minibatch indices are drawn below it and aggregation weights are
proportional to it, so padding never trains. A streamed population stays
on the host in a :class:`HostClientStore`, which serves row ranges to
``FedCore.stream_round`` block by block.

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
from olearning_sim_tpu_torch.parallel.mesh import pad_to_multiple, shard_clients

Array = Union[np.ndarray, torch.Tensor]


def _shard_rows(n: int, plan) -> slice:
    """Rank ``plan.dp_rank``'s contiguous rows of ``n`` clients over dp."""
    padded, per = shard_clients(n, plan)
    if padded != n:
        raise ValueError(
            f"{n} clients do not split over dp={plan.dp}; pad with "
            f"pad_for(dp * block_clients) first"
        )
    return slice(plan.dp_rank * per, (plan.dp_rank + 1) * per)


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
    # A rank's shard (:meth:`shard`): its rows start at ``offset`` of a
    # padded population of ``total_clients`` (None: the whole population).
    offset: int = 0
    total_clients: Optional[int] = None

    @property
    def num_clients(self) -> int:
        """Clients held here: this rank's rows of a shard."""
        return int(self.x.shape[0])

    @property
    def padded_clients(self) -> int:
        """The whole padded population's size (a shard's included)."""
        return self.num_clients if self.total_clients is None else int(self.total_clients)

    def _whole(self, what: str) -> None:
        if self.total_clients is not None:
            raise ValueError(f"{what} needs the whole population, not a rank's shard")

    def shard(self, plan) -> "ClientDataset":
        """This rank's contiguous shard of the (padded) population over
        ``plan``'s dp axis, as the JAX package's ``place(plan)`` lays
        clients out (``P("dp")``); the whole population at dp 1. Every
        rank builds the same full host arrays and keeps its own rows."""
        self._whole("shard")
        rows = _shard_rows(self.num_clients, plan)
        return dataclasses.replace(
            self, x=self.x[rows], y=self.y[rows], num_samples=self.num_samples[rows],
            client_uid=self.client_uid[rows], weight=self.weight[rows],
            offset=rows.start, total_clients=self.num_clients)

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
        self._whole("take")
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
        (weight 0, ``num_samples`` 1). Over dp ranks pad to ``dp *
        block_clients`` before :meth:`shard`, as the JAX package's
        ``pad_for(plan, block)`` pads."""
        self._whole("pad_for")
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
            offset=self.offset, total_clients=self.total_clients,
        )


class HostClientStore:
    """Host-resident chunked client population for block-streamed rounds.

    The resident :class:`ClientDataset` path places the whole population
    on the device, so the population is bounded by device memory. A store
    instead keeps clients on the host and serves arbitrary row ranges on
    demand, so the streamed round (``FedCore.stream_round``) can walk a
    million-client population in device-sized blocks with O(block) device
    memory. A copy of the JAX package's store: the same seed gives the
    same rows in both packages.

    Rows are addressed globally in ``[0, padded_clients)``; rows at or
    beyond ``num_real_clients`` are inert padding (weight 0,
    ``num_samples`` 1 — the exact convention ``ClientDataset.pad_for``
    uses, so padding never contributes to training). Two constructions:

    - :meth:`from_dataset` wraps a materialized host dataset (zero-copy
      row views). This is the task-runner path, and the one the
      bitwise streamed-vs-resident parity tests pin.
    - :meth:`synthetic` is a lazy row-range-addressable generator:
      fixed-size chunks are drawn on demand from ``(seed, chunk_idx)``,
      so host memory is O(chunk) no matter the logical population — the
      million-client bench path.

    Persistent per-client state (quarantine strikes, pacing EMAs,
    personalization state at task scale) lives in named ``[C, ...]``
    numpy arrays (:meth:`ensure_state` / :meth:`state_rows`) that survive
    across rounds on the host and stream in/out with the data blocks.
    """

    def __init__(self, *, num_real_clients: int, n_local: int,
                 row_fn, padded_clients: Optional[int] = None,
                 population_size: Optional[int] = None):
        """``row_fn(start, stop) -> dict`` with host arrays ``x``, ``y``,
        ``num_samples``, ``client_uid``, ``weight`` for REAL rows
        ``[start, stop)`` (callers never request padding rows from it —
        the store synthesizes those). Use the classmethod constructors
        unless you are bringing your own storage backend."""
        self.num_real_clients = int(num_real_clients)
        self.n_local = int(n_local)
        self._row_fn = row_fn
        self.padded_clients = int(padded_clients
                                  if padded_clients is not None
                                  else num_real_clients)
        if self.padded_clients < self.num_real_clients:
            raise ValueError(
                f"padded_clients {self.padded_clients} < real clients "
                f"{self.num_real_clients}"
            )
        self.population_size = population_size
        self._state: dict = {}

    @property
    def population(self) -> int:
        return (self.num_real_clients if self.population_size is None
                else self.population_size)

    def pad_to(self, padded_clients: int) -> None:
        """Grow the padded population (streamed execution pads to a
        multiple of the stream block). Never shrinks below real rows."""
        padded_clients = int(padded_clients)
        if padded_clients < self.num_real_clients:
            raise ValueError(
                f"cannot pad to {padded_clients} < real clients "
                f"{self.num_real_clients}"
            )
        if padded_clients < self.padded_clients:
            return
        self.padded_clients = padded_clients
        for name, arr in self._state.items():
            if arr.shape[0] < padded_clients:
                widths = [(0, padded_clients - arr.shape[0])]
                widths += [(0, 0)] * (arr.ndim - 1)
                self._state[name] = np.pad(arr, widths)

    @classmethod
    def from_dataset(cls, ds: ClientDataset) -> "HostClientStore":
        """Wrap a HOST (unplaced) dataset; row reads are views."""
        arrays = {
            "x": np.asarray(ds.x), "y": np.asarray(ds.y),
            "num_samples": np.asarray(ds.num_samples, np.int32),
            "client_uid": np.asarray(ds.client_uid, np.int32),
            "weight": np.asarray(ds.weight, np.float32),
        }

        def row_fn(start, stop):
            return {k: v[start:stop] for k, v in arrays.items()}

        return cls(
            num_real_clients=ds.num_clients, n_local=ds.n_local,
            row_fn=row_fn, padded_clients=ds.num_clients,
            # The dataset may itself carry inert pad rows + a parent
            # population; preserve the true N for SCAFFOLD-style math.
            population_size=(ds.population
                             if ds.population != ds.num_clients else None),
        )

    @classmethod
    def synthetic(cls, seed: int, num_clients: int, n_local: int,
                  input_shape: Tuple[int, ...], num_classes: int,
                  dirichlet_alpha: Optional[float] = None,
                  class_sep: float = 2.0, chunk_rows: int = 8192,
                  cache_chunks: int = 2,
                  dtype: np.dtype = np.float32) -> "HostClientStore":
        """Lazy Gaussian-blob population: chunk ``i`` is drawn from
        ``default_rng([seed, 0x57E4A, i])`` on demand (deterministic and
        row-range addressable; a ``cache_chunks``-deep LRU bounds host
        memory at O(cache_chunks x chunk)). Each rank of the streamed
        executor reads its own segment of each block, so align
        ``chunk_rows`` to the per-rank segment size (stream_rows / dp) —
        then a rank generates only its own chunks, each once per round; a
        misaligned chunk is regenerated once per overlapping segment
        instead. Same
        class-mean table as :func:`make_synthetic_dataset`
        (seed-derived), so central eval sets from
        :func:`make_central_eval_set` stay on-distribution."""
        import collections

        feat_dim = int(np.prod(input_shape))
        means = _class_means(seed, num_classes, feat_dim,
                             class_sep).astype(np.float32)
        cache: "collections.OrderedDict" = collections.OrderedDict()
        keep = max(1, int(cache_chunks))

        def make_chunk(ci: int):
            if ci in cache:
                cache.move_to_end(ci)
                return cache[ci]
            start = ci * chunk_rows
            rows = min(chunk_rows, num_clients - start)
            rng = np.random.default_rng([seed, 0x57E4A, ci])
            y = _draw_client_labels(rng, rows, n_local, num_classes,
                                    dirichlet_alpha)
            x = rng.standard_normal((rows, n_local, feat_dim),
                                    dtype=np.float32)
            x += means[y]
            x = x.astype(dtype, copy=False).reshape(
                (rows, n_local) + tuple(input_shape)
            )
            chunk = {
                "x": x, "y": y,
                "num_samples": np.full(rows, n_local, np.int32),
                "client_uid": np.arange(start, start + rows, dtype=np.int32),
                "weight": np.full(rows, float(n_local), np.float32),
            }
            while len(cache) >= keep:
                cache.popitem(last=False)
            cache[ci] = chunk
            return chunk

        def row_fn(start, stop):
            pieces = []
            pos = start
            while pos < stop:
                ci = pos // chunk_rows
                chunk = make_chunk(ci)
                lo = pos - ci * chunk_rows
                hi = min(stop - ci * chunk_rows, chunk["x"].shape[0])
                pieces.append({k: v[lo:hi] for k, v in chunk.items()})
                pos = ci * chunk_rows + hi
            if len(pieces) == 1:
                return pieces[0]
            return {k: np.concatenate([p[k] for p in pieces])
                    for k in pieces[0]}

        return cls(num_real_clients=num_clients, n_local=n_local,
                   row_fn=row_fn, padded_clients=num_clients)

    # ------------------------------------------------------------- reads
    def rows(self, start: int, stop: int) -> dict:
        """Host arrays for global rows ``[start, stop)``; padding rows are
        synthesized inert (weight 0, ``num_samples`` 1)."""
        if not 0 <= start <= stop <= self.padded_clients:
            raise IndexError(
                f"rows [{start}, {stop}) outside [0, {self.padded_clients})"
            )
        real_stop = min(stop, self.num_real_clients)
        if start < real_stop:
            out = {k: np.asarray(v)
                   for k, v in self._row_fn(start, real_stop).items()}
        else:
            out = None
        n_pad = stop - max(start, real_stop)
        if n_pad:
            if out is None:
                probe = self._row_fn(0, 1) if self.num_real_clients else None
                x_tail = (probe["x"].shape[1:] if probe is not None
                          else (self.n_local,))
                x_dtype = probe["x"].dtype if probe is not None else np.float32
                y_dtype = probe["y"].dtype if probe is not None else np.int32
                out = {
                    "x": np.zeros((0,) + x_tail, x_dtype),
                    "y": np.zeros((0,) + x_tail[:1], y_dtype),
                    "num_samples": np.zeros(0, np.int32),
                    "client_uid": np.zeros(0, np.int32),
                    "weight": np.zeros(0, np.float32),
                }
            pad = {
                "x": np.zeros((n_pad,) + out["x"].shape[1:], out["x"].dtype),
                "y": np.zeros((n_pad,) + out["y"].shape[1:], out["y"].dtype),
                # num_samples 1, weight 0: the pad_for convention — no
                # mod-by-zero, no contribution.
                "num_samples": np.ones(n_pad, np.int32),
                "client_uid": np.arange(max(start, real_stop), stop,
                                        dtype=np.int32),
                "weight": np.zeros(n_pad, np.float32),
            }
            out = {k: np.concatenate([out[k], pad[k]]) for k in out}
        return out

    # ------------------------------------------------- per-client state
    def ensure_state(self, name: str, shape_tail: Tuple[int, ...] = (),
                     dtype=np.float32, fill=0) -> np.ndarray:
        """Allocate (once) a persistent ``[padded_clients, *shape_tail]``
        per-client state array; returns the live array."""
        if name not in self._state:
            arr = np.full((self.padded_clients,) + tuple(shape_tail), fill,
                          dtype=dtype)
            self._state[name] = arr
        return self._state[name]

    def state_rows(self, name: str, start: int, stop: int) -> np.ndarray:
        return self._state[name][start:stop]

    def set_state_rows(self, name: str, start: int, stop: int,
                       values) -> None:
        self._state[name][start:stop] = values

    def state_names(self):
        return sorted(self._state)

    def state_bytes(self) -> int:
        """Resident host bytes of all persistent per-client state
        (published to ``ols_engine_client_state_bytes``)."""
        return int(sum(a.nbytes for a in self._state.values()))


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
