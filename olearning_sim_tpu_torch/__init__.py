"""olearning_sim_tpu_torch — the PyTorch/CUDA port of the JAX package beside it.

A second package beside the JAX one, held against it by the
``tests/test_torch_*.py`` parity tests. It imports torch, numpy and the
standard library only. Its entry points (``engine.fedcore.build_fedcore``,
``FedCore.init_state``, ``ClientDataset.to``) run on the GPU unless the
caller passes ``device="cpu"``; hand-written CUDA kernels live under
``csrc/`` and are built with ``nvcc`` at first use (``ops/_build.py``).

Ported so far: the synchronous FedAvg/FedAdam round on one device, the
DistilBERT-shaped ``TextTransformer`` (dense, flash and ring attention),
the long-context sequence-parallel entry points (``parallel``), and both
attention kernels (the flash forward and its softmax-stats variant).
``ROADMAP.md`` lists what is still to come.
"""

from olearning_sim_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
