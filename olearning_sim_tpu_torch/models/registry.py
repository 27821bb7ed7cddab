"""Model registry: a task names a model (``"distilbert"``, ``"mlp2"``,
``"cnn4"``) and the engine builds it from the registered defaults plus
per-task overrides. Same contract as the JAX package's registry, with
``torch.nn.Module`` builders.

flax infers input widths at ``init``; ``torch.nn`` needs them at
construction. So :meth:`ModelSpec.build` takes the JAX package's
``input_shape`` (per-example, without the batch axis; default
``example_input_shape``) and passes the builder what ``shape_kwargs``
derives from it."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch.nn as nn


def _no_shape_kwargs(shape: Tuple[int, ...]) -> Dict[str, Any]:
    return {}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    builder: Callable[..., nn.Module]
    # Example input shape WITHOUT batch dim, used for init and checks.
    example_input_shape: Tuple[int, ...]
    num_classes: int
    defaults: Dict[str, Any]
    # Input element dtype (np.int32 for token models, np.float32 otherwise).
    input_dtype: Any = np.float32
    # Builder kwargs that depend on the input shape (input widths).
    shape_kwargs: Callable[[Tuple[int, ...]], Dict[str, Any]] = _no_shape_kwargs

    def build(self, input_shape: Optional[Sequence[int]] = None, **overrides) -> nn.Module:
        kwargs = dict(self.defaults)
        kwargs.update(self.shape_kwargs(tuple(input_shape or self.example_input_shape)))
        kwargs.update(overrides)
        return self.builder(**kwargs)


_REGISTRY: Dict[str, ModelSpec] = {}


def register_model(spec: ModelSpec) -> ModelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"duplicate model name: {spec.name}")
    _REGISTRY[spec.name] = spec
    return spec


def get_model(name: str) -> ModelSpec:
    # Import model modules lazily so registration happens on first lookup.
    import importlib

    for mod in ("transformer", "mlp", "cnn"):
        importlib.import_module(f"olearning_sim_tpu_torch.models.{mod}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
