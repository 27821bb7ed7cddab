"""The clients' data and the central eval set, made from the task's seed.

A frozen copy of the synthetic populations the task JSON's
``data.synthetic`` block describes, so that the reference draws the same
arrays from the same seed as the system under test without reading
anything it made. Each draw keeps the generator calls and their order:

- text (Sent140 stand-in): every class owns a band of ``(vocab - 1) //
  classes`` token ids; each position is drawn from the row's class band
  with probability ``signal_frac`` (0.5), else uniformly from ``[1,
  vocab)``; id 0 is never drawn (it is padding);
- images (FEMNIST stand-in): Gaussian class blobs, ``x = mu_y + N(0, 1)``
  with class means ``N(0, class_sep / sqrt(features))``;
- labels per client: IID, or Dirichlet(alpha) class shares per client;
- every client holds ``n_local`` rows and weighs ``n_local``.

All arrays are host numpy; the round moves what it needs to the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def text_population(seed: int, num_clients: int, n_local: int, seq_len: int,
                    num_classes: int, vocab_size: int,
                    dirichlet_alpha: Optional[float], signal_frac: float = 0.5):
    """``(x [C, n, L] int32, y [C, n] int32, num_samples [C])``."""
    rng = np.random.default_rng([seed, 0x7E87])
    if dirichlet_alpha is None:
        probs = np.full((num_clients, num_classes), 1.0 / num_classes)
    else:
        probs = rng.dirichlet([dirichlet_alpha] * num_classes, size=num_clients)
    num_samples = np.full(num_clients, n_local, np.int32)
    band = (vocab_size - 1) // num_classes
    y = np.empty((num_clients, n_local), np.int32)
    for c in range(num_clients):
        y[c] = rng.choice(num_classes, size=n_local, p=probs[c])
    uniform = rng.integers(1, vocab_size, size=(num_clients, n_local, seq_len))
    in_band = 1 + y[..., None] * band + rng.integers(
        0, max(band, 1), size=(num_clients, n_local, seq_len))
    use_band = rng.random((num_clients, n_local, seq_len)) < signal_frac
    x = np.where(use_band, in_band, uniform).astype(np.int32)
    return x, y, num_samples


def text_eval_set(seed: int, n: int, seq_len: int, num_classes: int, vocab_size: int,
                  signal_frac: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng([seed, 0x7E88])
    band = (vocab_size - 1) // num_classes
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    uniform = rng.integers(1, vocab_size, size=(n, seq_len))
    in_band = 1 + y[:, None] * band + rng.integers(0, max(band, 1), size=(n, seq_len))
    use_band = rng.random((n, seq_len)) < signal_frac
    return np.where(use_band, in_band, uniform).astype(np.int32), y


def _class_means(seed: int, num_classes: int, feat_dim: int, class_sep: float) -> np.ndarray:
    rng = np.random.default_rng([seed, 0xC1A55])
    return rng.normal(0.0, class_sep / np.sqrt(feat_dim), size=(num_classes, feat_dim))


def blob_population(seed: int, num_clients: int, n_local: int, input_shape, num_classes: int,
                    dirichlet_alpha: Optional[float], class_sep: float = 2.0):
    """``(x [C, n, *input_shape] float32, y [C, n] int32, num_samples [C])``."""
    rng = np.random.default_rng(seed)
    feat_dim = int(np.prod(input_shape))
    means = _class_means(seed, num_classes, feat_dim, class_sep).astype(np.float32)
    if dirichlet_alpha is None:
        probs = np.full((num_clients, num_classes), 1.0 / num_classes)
    else:
        probs = rng.dirichlet([dirichlet_alpha] * num_classes, size=num_clients)
    cum = probs.cumsum(axis=1)
    u = rng.random((num_clients, n_local))
    y = (u[..., None] > cum[:, None, :]).sum(axis=-1).astype(np.int32)
    np.clip(y, 0, num_classes - 1, out=y)
    num_samples = np.full(num_clients, n_local, np.int32)
    x = rng.standard_normal((num_clients, n_local, feat_dim), dtype=np.float32)
    x += means[y]
    return x.reshape(num_clients, n_local, *input_shape), y, num_samples


def blob_eval_set(seed: int, n: int, input_shape, num_classes: int,
                  class_sep: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng([seed, 0xE7A1])
    feat_dim = int(np.prod(input_shape))
    means = _class_means(seed, num_classes, feat_dim, class_sep)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = (means[y] + rng.normal(0.0, 1.0, size=(n, feat_dim))).astype(np.float32)
    return x.reshape(n, *input_shape), y


def eval_set(params: dict, text: bool, input_shape, vocab_size: int):
    """The central eval set the engine params' ``data`` block asks for."""
    data = params.get("data", {})
    syn = data.get("synthetic", {})
    seed, classes, n = int(syn.get("seed", 0)), int(syn["num_classes"]), int(data["eval_n"])
    if text:
        return text_eval_set(seed, n, int(input_shape[0]), classes, vocab_size)
    return blob_eval_set(seed, n, tuple(input_shape), classes, float(syn.get("class_sep", 2.0)))


def population(params: dict, num_clients: int, text: bool, input_shape, vocab_size: int):
    """The population and eval set the engine params' ``data`` block asks
    for: ``(x, y, num_samples, (eval_x, eval_y))``."""
    syn = params.get("data", {}).get("synthetic", {})
    seed, classes = int(syn.get("seed", 0)), int(syn["num_classes"])
    n_local, alpha = int(syn.get("n_local", 20)), syn.get("dirichlet_alpha")
    if text:
        x, y, ns = text_population(seed, num_clients, n_local, int(input_shape[0]), classes,
                                   vocab_size, alpha)
    else:
        x, y, ns = blob_population(seed, num_clients, n_local, tuple(input_shape), classes,
                                   alpha, float(syn.get("class_sep", 2.0)))
    return x, y, ns, eval_set(params, text, input_shape, vocab_size)
