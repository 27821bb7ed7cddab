"""File-transfer backends behind one interface.

The reference moves datasets, models, and operator code through four transfer
types (``FileTransferType`` enum, ``ols_core/proto/taskService.proto:131-136``:
FILE/HTTP/S3/MINIO), with concrete repos at
``ofl_commons/infrastructure/FileRepo/s3_file_repo.py:7-64`` (boto3) and
``minio_file_repo.py:22-65`` (minio), a wget/urllib path for HTTP
(``taskMgr/utils/utils_run_task.py:174-325``), and plain paths for FILE.
The abstract base the reference imports (``file_repo.py``) was never released,
so this module re-specifies it: upload / download / delete / list /
download_payload (download-then-delete, the reference's payload semantics).

S3 and MinIO impls import their SDKs lazily and raise a clear error when the
SDK is not installed — single-host mode needs neither.

A copy of the JAX package's ``storage/file_repo.py``. The JAX module takes
the transfer type from the generated protobuf enum; the port keys on its
name (the task JSON's ``"FILE"``, ``"S3"``, ...) or its wire number (a
protobuf ``TaskConfig`` handed in by the JAX control plane), since it
imports no protobuf. Options no caller of the port sets are left out:
``ResilientFileRepo`` takes its retry policy always and no log hook, and
``fetch_operator_code`` unpacks by the ``.zip`` suffix alone.
"""

from __future__ import annotations

import abc
import os
import shutil
import tempfile
import urllib.request
import zipfile
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

    def download_payload(self, remote_path: str, local_path: str) -> bool:
        """Download then delete (reference ``s3_file_repo.py`` download_payload
        semantics: payloads are consumed, not mirrored)."""
        if not self.download_file(remote_path, local_path):
            return False
        return self.delete_file(remote_path)

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


class HttpFileRepo(FileRepo):
    """HTTP transfer type: download-only (the reference fetches HTTP data with
    wget/urllib, ``utils_run_task.py:216-233``; it never uploads over HTTP)."""

    def upload_file(self, local_path: str, remote_path: str) -> bool:
        raise NotImplementedError("HTTP transfer is download-only")

    def download_file(self, remote_path: str, local_path: str) -> bool:
        try:
            os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
            with urllib.request.urlopen(remote_path) as resp, open(local_path, "wb") as out:
                shutil.copyfileobj(resp, out)
            return True
        except Exception:
            # http.client errors (IncompleteRead etc.) are not OSErrors; keep
            # the bool contract and don't leave a truncated file behind.
            try:
                os.remove(local_path)
            except OSError:
                pass
            return False

    def delete_file(self, remote_path: str) -> bool:
        raise NotImplementedError("HTTP transfer is download-only")

    def list_files(self, prefix: str = "") -> List[str]:
        raise NotImplementedError("HTTP transfer is download-only")


class S3FileRepo(FileRepo):
    """S3 transfer type (reference ``s3_file_repo.py:7-64``, boto3). The SDK is
    imported lazily so single-host deployments need no boto3."""

    def __init__(self, endpoint_url: str, access_key: str, secret_key: str, bucket: str):
        try:
            import boto3  # noqa: PLC0415
        except ImportError as e:  # pragma: no cover - exercised only without boto3
            raise RuntimeError("S3 transfer requires boto3 (not installed)") from e
        self.bucket = bucket
        self._client = boto3.client(
            "s3",
            endpoint_url=endpoint_url,
            aws_access_key_id=access_key,
            aws_secret_access_key=secret_key,
        )

    def upload_file(self, local_path: str, remote_path: str) -> bool:
        try:
            self._client.upload_file(local_path, self.bucket, remote_path)
            return True
        except Exception:
            return False

    def download_file(self, remote_path: str, local_path: str) -> bool:
        try:
            os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
            self._client.download_file(self.bucket, remote_path, local_path)
            return True
        except Exception:
            return False

    def delete_file(self, remote_path: str) -> bool:
        try:
            self._client.delete_object(Bucket=self.bucket, Key=remote_path)
            return True
        except Exception:
            return False

    def list_files(self, prefix: str = "") -> List[str]:
        out: List[str] = []
        paginator = self._client.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=self.bucket, Prefix=prefix):
            out.extend(obj["Key"] for obj in page.get("Contents", []))
        return out


class MinioFileRepo(FileRepo):
    """MINIO transfer type (reference ``minio_file_repo.py:22-65``)."""

    def __init__(self, endpoint: str, access_key: str, secret_key: str, bucket: str,
                 secure: bool = False):
        try:
            from minio import Minio  # noqa: PLC0415
        except ImportError as e:  # pragma: no cover - exercised only without minio
            raise RuntimeError("MinIO transfer requires the minio SDK (not installed)") from e
        self.bucket = bucket
        self._client = Minio(endpoint, access_key=access_key, secret_key=secret_key,
                             secure=secure)

    def upload_file(self, local_path: str, remote_path: str) -> bool:
        try:
            self._client.fput_object(self.bucket, remote_path, local_path)
            return True
        except Exception:
            return False

    def download_file(self, remote_path: str, local_path: str) -> bool:
        try:
            self._client.fget_object(self.bucket, remote_path, local_path)
            return True
        except Exception:
            return False

    def delete_file(self, remote_path: str) -> bool:
        try:
            self._client.remove_object(self.bucket, remote_path)
            return True
        except Exception:
            return False

    def list_files(self, prefix: str = "") -> List[str]:
        try:
            return [o.object_name
                    for o in self._client.list_objects(self.bucket, prefix=prefix,
                                                       recursive=True)]
        except Exception:
            return []


class ResilientFileRepo(FileRepo):
    """Wrap any :class:`FileRepo` with retry/backoff + fault injection.

    The bool-contract methods (upload/download/delete) are retried both on
    raised exceptions and on returned ``False`` (the backends' native failure
    signal); after the policy is exhausted the last result/exception is
    surfaced unchanged, so callers keep their existing contracts.
    ``NotImplementedError`` (capability statements, e.g. HTTP upload) passes
    straight through. Fault-injection points: ``storage.upload``,
    ``storage.download``, ``storage.delete``, ``storage.list``.
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


def storage_settings_from_env() -> dict:
    """Object-store connection settings from the environment (the reference
    reads them from ``config/manager_config.yaml``; the deployment config
    system maps that file onto these variables)."""
    return {
        "endpoint": os.environ.get("OLS_STORAGE_ENDPOINT", ""),
        "access_key": os.environ.get("OLS_STORAGE_ACCESS_KEY", ""),
        "secret_key": os.environ.get("OLS_STORAGE_SECRET_KEY", ""),
        "bucket": os.environ.get("OLS_STORAGE_BUCKET", ""),
        "secure": os.environ.get("OLS_STORAGE_SECURE", "") == "1",
    }


def make_file_repo(transfer_type: Union[str, int], *, root: str = "/",
                   endpoint: str = "", access_key: str = "", secret_key: str = "",
                   bucket: str = "", secure: bool = False,
                   retry_policy=None) -> FileRepo:
    """Factory keyed by the transfer type's name or wire number (the
    dispatch the reference does ad hoc at every download site,
    ``utils_run_task.py:174-325``). ``root`` is the FILE repo's (the engine
    params' ``storage`` block's); S3 and MinIO take the object store's
    settings from the keywords, or from ``OLS_STORAGE_*`` when no
    ``endpoint`` is given.

    ``retry_policy`` — optional
    :class:`~olearning_sim_tpu_torch.resilience.RetryPolicy`; when given the
    repo is wrapped in :class:`ResilientFileRepo` (transient I/O failures
    retried with backoff, fault-injection points armed)."""

    def _wrap(repo: FileRepo) -> FileRepo:
        if retry_policy is None:
            return repo
        return ResilientFileRepo(repo, retry_policy=retry_policy)

    name = _transfer_type_name(transfer_type)
    if name == "FILE":
        return _wrap(LocalFileRepo(root=root))
    if name == "HTTP":
        return _wrap(HttpFileRepo())
    if not endpoint:
        env = storage_settings_from_env()
        if not env["endpoint"]:
            raise ValueError(
                f"{name} transfer type needs object-store settings; pass "
                "endpoint/keys/bucket or set OLS_STORAGE_ENDPOINT / "
                "OLS_STORAGE_ACCESS_KEY / OLS_STORAGE_SECRET_KEY / "
                "OLS_STORAGE_BUCKET"
            )
        endpoint = env["endpoint"]
        access_key = access_key or env["access_key"]
        secret_key = secret_key or env["secret_key"]
        bucket = bucket or env["bucket"]
        secure = secure or env["secure"]
    if name == "S3":
        return _wrap(S3FileRepo(endpoint_url=endpoint, access_key=access_key,
                                secret_key=secret_key, bucket=bucket))
    return _wrap(MinioFileRepo(endpoint=endpoint, access_key=access_key,
                               secret_key=secret_key, bucket=bucket,
                               secure=secure))


def fetch_operator_code(repo: FileRepo, remote_path: str, dest_dir: str) -> str:
    """Fetch user operator code (zip or single file) into ``dest_dir`` and
    return the code directory — the reference's ``get_operator_code``
    (``taskMgr/utils/utils_runner.py:684-782``) without the temp-dir juggling.
    Zips are extracted; a plain file is copied as-is."""
    os.makedirs(dest_dir, exist_ok=True)
    name = os.path.basename(remote_path)
    local = os.path.join(dest_dir, name)
    if not repo.download_file(remote_path, local):
        raise FileNotFoundError(f"operator code not found: {remote_path}")
    if name.endswith(".zip"):
        with zipfile.ZipFile(local) as zf:
            zf.extractall(dest_dir)
        os.remove(local)
    return dest_dir
