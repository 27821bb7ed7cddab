"""One torch thread per pytest-xdist worker. Every ``tests/test_torch_*.py``
imports this module, so the setting is made in any worker that runs one of
the port's tests, and it holds for every test that worker runs after it,
the JAX package's included.

Six workers to a machine, each with torch's default of one OpenMP thread
per core, spin against each other: the port's tests ran in 808 s that way
and in 409 s on one thread each, six workers on eight cores. A file run
alone, without xdist, keeps every core."""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
