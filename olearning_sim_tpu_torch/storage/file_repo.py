"""File-transfer backends behind one interface, ``FILE`` transfer type only.

A copy of the JAX package's ``storage/file_repo.py`` for local files: the
:class:`FileRepo` interface (upload / download / delete / list,
re-specified there after the reference's unreleased ``file_repo.py``),
:class:`LocalFileRepo` (a rooted directory tree, uploads committed stage
-> fsync -> rename -> fsync(dir)), and :class:`ResilientFileRepo`
(retry/backoff plus the ``storage.*`` fault points). The JAX module takes
the transfer type from the generated protobuf enum; the port keys on its
name (the task JSON's ``"FILE"``, ``"S3"``, ...) or its wire number (a
protobuf ``TaskConfig`` handed in by the JAX control plane), since it
imports no protobuf. HTTP, S3 and MinIO are not ported:
S3 and MinIO need SDKs the port does not depend on (``ROADMAP.md`` A19).
"""

from __future__ import annotations

import abc
import os
import shutil
import tempfile
from typing import List, Union

from olearning_sim_tpu_torch.utils.durable import commit_replace, copy_file_durable

# The reference's FileTransferType enum (taskservice.proto:137-142), by
# wire number.
TRANSFER_TYPES = ("FILE", "HTTP", "S3", "MINIO")


def _transfer_type_name(transfer_type: Union[str, int]) -> str:
    """A transfer type's name, from its name or its wire number."""
    if isinstance(transfer_type, str):
        name = transfer_type.upper()
        if name in TRANSFER_TYPES:
            return name
    elif 0 <= int(transfer_type) < len(TRANSFER_TYPES):
        return TRANSFER_TYPES[int(transfer_type)]
    raise ValueError(f"unknown file transfer type {transfer_type!r} "
                     f"(known: {list(TRANSFER_TYPES)})")


class FileRepo(abc.ABC):
    """Narrow file-store interface shared by all transfer backends."""

    @abc.abstractmethod
    def upload_file(self, local_path: str, remote_path: str) -> bool:
        """Copy a local file into the store at ``remote_path``."""

    @abc.abstractmethod
    def download_file(self, remote_path: str, local_path: str) -> bool:
        """Copy ``remote_path`` out of the store to a local file."""

    @abc.abstractmethod
    def delete_file(self, remote_path: str) -> bool:
        """Remove ``remote_path`` from the store."""

    @abc.abstractmethod
    def list_files(self, prefix: str = "") -> List[str]:
        """All stored paths starting with ``prefix``."""

    def exists(self, remote_path: str) -> bool:
        return remote_path in self.list_files(remote_path)


class LocalFileRepo(FileRepo):
    """FILE transfer type: a rooted directory tree.

    Remote paths are interpreted relative to ``root``; absolute remote paths
    are allowed and used as-is (the reference's FILE mode passes raw host
    paths, ``utils_run_task.py:196-214``).
    """

    def __init__(self, root: str = "/"):
        self.root = root

    def _resolve(self, remote_path: str) -> str:
        if os.path.isabs(remote_path):
            return remote_path
        return os.path.join(self.root, remote_path)

    def upload_file(self, local_path: str, remote_path: str) -> bool:
        try:
            dest = self._resolve(remote_path)
            os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
            # Stage-then-rename: a concurrent reader of ``dest`` must never
            # see a half-copied file (os.replace is atomic within one fs);
            # unique staging name so two uploaders don't clobber each other.
            # The staged data is fsynced before the rename and the parent
            # directory after it — without both, a host crash can replay the
            # rename but not the data and "commit" a zero-length/torn file.
            fd, tmp = tempfile.mkstemp(
                prefix=os.path.basename(dest) + ".", dir=os.path.dirname(dest) or "."
            )
            os.close(fd)
            copy_file_durable(local_path, tmp)
            commit_replace(tmp, dest)
            return True
        except OSError:
            return False

    def exists(self, remote_path: str) -> bool:
        # Direct stat — the base-class list_files() walk would scan the whole
        # root tree (root may be "/") just to answer a membership question.
        return os.path.isfile(self._resolve(remote_path))

    def download_file(self, remote_path: str, local_path: str) -> bool:
        try:
            src = self._resolve(remote_path)
            os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
            shutil.copyfile(src, local_path)
            return True
        except OSError:
            return False

    def delete_file(self, remote_path: str) -> bool:
        try:
            os.remove(self._resolve(remote_path))
            return True
        except OSError:
            return False

    def list_files(self, prefix: str = "") -> List[str]:
        base = self._resolve(prefix)
        found: List[str] = []
        if os.path.isfile(base):
            return [prefix]
        search_root = base if os.path.isdir(base) else (os.path.dirname(base) or ".")
        if os.path.abspath(search_root) == os.path.sep:
            # A filesystem-rooted walk from "/" (root="/" with an empty or
            # one-level prefix) would scan the entire host. Demand intent.
            raise ValueError(
                "LocalFileRepo.list_files would walk the whole filesystem "
                f"(root={self.root!r}, prefix={prefix!r}); construct the repo "
                "with an explicit root directory instead"
            )
        if not os.path.isdir(search_root):
            return []
        for dirpath, _dirs, files in os.walk(search_root):
            for f in files:
                full = os.path.join(dirpath, f)
                rel = os.path.relpath(full, self.root) if not os.path.isabs(prefix) else full
                if rel.startswith(prefix):
                    found.append(rel)
        return sorted(found)


class ResilientFileRepo(FileRepo):
    """Wrap any :class:`FileRepo` with retry/backoff + fault injection.

    The bool-contract methods (upload/download/delete) are retried both on
    raised exceptions and on returned ``False`` (the backends' native failure
    signal); after the policy is exhausted the last result/exception is
    surfaced unchanged, so callers keep their existing contracts.
    ``NotImplementedError`` (capability statements) passes straight through.
    Fault-injection points: ``storage.upload``, ``storage.download``,
    ``storage.delete``, ``storage.list``.
    """

    def __init__(self, inner: FileRepo, retry_policy, task_id: str = ""):
        self.inner = inner
        self.retry_policy = retry_policy
        self.task_id = task_id

    def _call(self, point: str, context: str, fn, *args,
              bool_contract: bool = True):
        from olearning_sim_tpu_torch.resilience import faults

        def op():
            spec = faults.fire(point, context=context, task_id=self.task_id)
            if spec is not None:
                if bool_contract and spec.error in ("false", "corrupt"):
                    return False
                # Non-bool APIs (list_files) get the exception flavor even
                # for "false" specs — returning False would violate their
                # List[str] contract.
                raise faults.exception_for(spec, point, context)
            return fn(*args)

        return self.retry_policy.call(
            op, retry_if=(lambda r: r is False) if bool_contract else None,
            point=point, task_id=self.task_id,
        )

    def upload_file(self, local_path: str, remote_path: str) -> bool:
        return self._call("storage.upload", remote_path,
                          self.inner.upload_file, local_path, remote_path)

    def download_file(self, remote_path: str, local_path: str) -> bool:
        return self._call("storage.download", remote_path,
                          self.inner.download_file, remote_path, local_path)

    def delete_file(self, remote_path: str) -> bool:
        return self._call("storage.delete", remote_path,
                          self.inner.delete_file, remote_path)

    def list_files(self, prefix: str = "") -> List[str]:
        return self._call("storage.list", prefix, self.inner.list_files,
                          prefix, bool_contract=False)

    def exists(self, remote_path: str) -> bool:
        # Delegate so LocalFileRepo's direct-stat fast path survives wrapping.
        return self.inner.exists(remote_path)


def make_file_repo(transfer_type: Union[str, int], *, root: str = "/",
                   retry_policy=None) -> FileRepo:
    """Factory keyed by the transfer type's name or wire number (the
    dispatch the reference does ad hoc at every download site,
    ``utils_run_task.py:174-325``). ``root`` is the engine params' ``storage``
    block's; ``retry_policy`` — optional
    :class:`~olearning_sim_tpu_torch.resilience.RetryPolicy`; when given the
    repo is wrapped in :class:`ResilientFileRepo`."""
    name = _transfer_type_name(transfer_type)
    if name != "FILE":
        raise ValueError(f"{name} file transfer is not ported yet: "
                         f"ROADMAP.md A19 (remote object stores)")
    repo = LocalFileRepo(root=root)
    if retry_policy is None:
        return repo
    return ResilientFileRepo(repo, retry_policy=retry_policy)
