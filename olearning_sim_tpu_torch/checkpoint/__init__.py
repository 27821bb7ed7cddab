"""Round-scoped checkpoint / resume and model files.

The port of the JAX package's ``checkpoint`` package: per-round
``torch.save`` steps of (global params, server-optimizer state, round
index and index seed, per-client state) committed through checksummed
manifests, with restore-and-resume
(:class:`~olearning_sim_tpu_torch.checkpoint.checkpointer.RoundCheckpointer`);
and model files in flax's msgpack wire format
(:mod:`~olearning_sim_tpu_torch.checkpoint.msgpack_wire`), which load in
either package (:class:`ModelUpdateExporter`).
"""

from olearning_sim_tpu_torch.checkpoint.checkpointer import (
    ModelUpdateExporter,
    RoundCheckpointer,
    export_model_bytes,
    import_model_bytes,
)

__all__ = [
    "RoundCheckpointer",
    "ModelUpdateExporter",
    "export_model_bytes",
    "import_model_bytes",
]
