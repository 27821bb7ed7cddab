"""Device resolution for the port's entry points.

Every entry point takes a ``device`` that defaults to ``"cuda"``. Asking
for CUDA where there is none is an error, never a silent fall-back to the
CPU: a run that meant to measure the GPU must not quietly measure the host.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a :class:`torch.device`; raise if it names CUDA
    and no CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the host"
        )
    return dev
