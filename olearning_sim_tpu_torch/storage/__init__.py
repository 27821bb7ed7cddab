"""Storage repos: the file-transfer backend the port's model files use.

A copy of the ``FILE`` half of the JAX package's ``storage/file_repo.py``
(:mod:`olearning_sim_tpu_torch.storage.file_repo`). The remote transfer
types (HTTP, S3, MinIO) are not ported (``ROADMAP.md`` A19).
"""

from olearning_sim_tpu_torch.storage.file_repo import (
    TRANSFER_TYPES,
    FileRepo,
    LocalFileRepo,
    ResilientFileRepo,
    make_file_repo,
)

__all__ = [
    "TRANSFER_TYPES",
    "FileRepo",
    "LocalFileRepo",
    "ResilientFileRepo",
    "make_file_repo",
]
