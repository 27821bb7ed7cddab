"""olearning_sim_tpu_torch — the PyTorch/CUDA port of the JAX package beside it.

A second package beside the JAX one, held against it by the
``tests/test_torch_*.py`` parity tests. It imports torch, numpy and the
standard library only. Its entry points (``engine.fedcore.build_fedcore``,
``FedCore.init_state``, ``ClientDataset.to``) run on the GPU unless the
caller passes ``device="cpu"``; hand-written CUDA kernels live under
``csrc/`` and are built with ``nvcc`` at first use (``ops/_build.py``).

Importing the package imports nothing: a user operator's subprocess that
does ``from olearning_sim_tpu_torch.operators import OperatorABC`` pays no
torch import. ``resolve_device`` is reached through the module's
``__getattr__``. ``ROADMAP.md`` lists what is still to come.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from olearning_sim_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
