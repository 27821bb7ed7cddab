"""Storage repos: file transfer backends + gradient-fragment consumption.

Copies of the JAX package's ``storage/file_repo.py`` and
``storage/fragment_repo.py``
(:mod:`olearning_sim_tpu_torch.storage.file_repo`,
:mod:`olearning_sim_tpu_torch.storage.fragment_repo`): the FILE, HTTP, S3
and MinIO transfer types (the SDKs of the last two imported only when such
a repo is built) and the fragment queues.
"""

from olearning_sim_tpu_torch.storage.file_repo import (
    TRANSFER_TYPES,
    FileRepo,
    HttpFileRepo,
    LocalFileRepo,
    MinioFileRepo,
    ResilientFileRepo,
    S3FileRepo,
    fetch_operator_code,
    make_file_repo,
    storage_settings_from_env,
)
from olearning_sim_tpu_torch.storage.fragment_repo import (
    Fragment,
    FragmentRepo,
    JsonFragmentRepo,
    QueueFragmentRepo,
    ResilientFragmentRepo,
)

__all__ = [
    "TRANSFER_TYPES",
    "FileRepo",
    "LocalFileRepo",
    "HttpFileRepo",
    "S3FileRepo",
    "MinioFileRepo",
    "make_file_repo",
    "fetch_operator_code",
    "storage_settings_from_env",
    "Fragment",
    "FragmentRepo",
    "JsonFragmentRepo",
    "QueueFragmentRepo",
    "ResilientFileRepo",
    "ResilientFragmentRepo",
]
