"""Task-data ingestion: ``dataPath`` + ``dataTransferType`` -> placed population.

Reference behavior being matched (``ols_core/taskMgr/utils/utils_run_task.py:
174-325`` ``download_data_files``): each actor downloads the task's archive
via FILE/HTTP/S3/MINIO, unzips it, and feeds per-phone files to operator
subprocesses. Here ingestion happens once per task: fetch archive -> parse
the standard dataset format (:mod:`formats`) -> partition into the
rectangular client population (:mod:`partition`). The fetched/parsed arrays
are cached per (path, split) so multi-operator tasks don't re-download.

A copy of the JAX package's ``data/ingest.py``, its cache key included: a
second read of the same path and split returns the first read's arrays,
whatever text settings or transfer type it asks for (``ROADMAP.md``
section C), so both packages give the same arrays for the same calls.
"""

from __future__ import annotations

import collections
import os
import tempfile
import threading
import zipfile
from typing import Any, Optional, Tuple

import numpy as np

from olearning_sim_tpu_torch.data import formats
from olearning_sim_tpu_torch.data.partition import partition

# LRU-bounded: a long-lived manager running many tasks must not retain
# every task's parsed arrays for process lifetime. The cap is datasets,
# not bytes — typical entries are one benchmark archive each.
_CACHE_MAX = max(1, int(os.environ.get("OLS_INGEST_CACHE_MAX", "4")))
_cache: "collections.OrderedDict[Tuple[str, str], Any]" = collections.OrderedDict()
_cache_lock = threading.Lock()


def fetch_dataset_dir(
    data_path: str,
    transfer_type: Any = None,
    storage_settings: Optional[dict] = None,
) -> str:
    """Materialize ``data_path`` as a local directory.

    - local directory -> itself
    - local/remote ``.zip`` or ``.tar[.gz]`` -> fetched (FileRepo for
      non-FILE transfer types), extracted into a temp dir (path-traversal
      guarded), nested-once roots flattened by
      :func:`formats.detect_and_load`. Tarballs matter because the genuine
      published archives (``cifar-10-python.tar.gz`` etc.) are tars, not
      zips — they ingest unchanged.
    """
    import tarfile

    if os.path.isdir(data_path):
        return data_path
    local_arc = data_path
    is_remote = transfer_type is not None and getattr(transfer_type, "name", str(transfer_type)) not in ("FILE", "0")
    if is_remote or not os.path.exists(data_path):
        from olearning_sim_tpu_torch.storage import make_file_repo

        # The port's factory takes a transfer type's name or wire number.
        tt = transfer_type if transfer_type is not None else 0
        repo = make_file_repo(tt, **(storage_settings or {}))
        local_arc = os.path.join(tempfile.mkdtemp(prefix="olsdata_"), os.path.basename(data_path))
        if not repo.download_file(data_path, local_arc):
            raise FileNotFoundError(f"could not fetch dataset {data_path!r} via {tt}")
    if zipfile.is_zipfile(local_arc):
        out = tempfile.mkdtemp(prefix="olsdata_x_")
        with zipfile.ZipFile(local_arc) as zf:
            for m in zf.namelist():
                target = os.path.realpath(os.path.join(out, m))
                if not target.startswith(os.path.realpath(out) + os.sep):
                    raise ValueError(f"zip entry escapes extraction root: {m!r}")
            zf.extractall(out)
        return out
    if tarfile.is_tarfile(local_arc):
        out = tempfile.mkdtemp(prefix="olsdata_x_")
        with tarfile.open(local_arc) as tf:
            try:
                # filter="data" (py>=3.12) rejects absolute paths, ..
                # traversal, links outside the root, and device/sticky bits.
                tf.extractall(out, filter="data")
            except TypeError:
                # Older interpreters: the zip branch's traversal guard, by
                # hand — plus a link-member rejection the zip branch does
                # not need (zipfile never materializes symlinks, tarfile
                # does: a symlink pointing outside the root followed by a
                # member extracting *through* it would pass a name-only
                # realpath check, because the realpath runs before the
                # symlink exists on disk).
                root = os.path.realpath(out)
                for m in tf.getmembers():
                    if m.issym() or m.islnk():
                        raise ValueError(
                            f"tar link member rejected: {m.name!r} -> "
                            f"{m.linkname!r} (published dataset archives "
                            f"contain no links)"
                        )
                    target = os.path.realpath(os.path.join(out, m.name))
                    if not target.startswith(root + os.sep):
                        raise ValueError(
                            f"tar entry escapes extraction root: {m.name!r}"
                        )
                tf.extractall(out)
        return out
    raise ValueError(
        f"dataset path {data_path!r} is neither a directory, a zip, nor a tar"
    )


def load_arrays(
    data_path: str,
    split: str = "train",
    transfer_type: Any = None,
    storage_settings: Optional[dict] = None,
    **text_kwargs,
) -> formats.Parsed:
    """Fetch + parse with per-(path, split) caching."""
    key = (data_path, split)
    with _cache_lock:
        if key in _cache:
            _cache.move_to_end(key)
            return _cache[key]
    d = fetch_dataset_dir(data_path, transfer_type, storage_settings)
    parsed = formats.detect_and_load(d, split, **text_kwargs)
    with _cache_lock:
        _cache[key] = parsed
        _cache.move_to_end(key)
        while len(_cache) > _CACHE_MAX:
            _cache.popitem(last=False)
    return parsed


def clear_cache() -> None:
    with _cache_lock:
        _cache.clear()


def load_population(
    data_path: str,
    num_clients: int,
    n_local: int,
    scheme: str = "dirichlet",
    alpha: float = 0.5,
    seed: int = 0,
    transfer_type: Any = None,
    storage_settings: Optional[dict] = None,
    eval_split: str = "test",
    eval_n: Optional[int] = None,
    **text_kwargs,
):
    """Full ingestion: returns ``(ClientDataset, (eval_x, eval_y) | None,
    num_classes)``. The eval set comes from the archive's test split when
    present, else a held-out tail of train (deterministic, disjoint from
    every client shard by construction: holdout rows are removed before
    partitioning)."""
    x, y, writer = load_arrays(
        data_path, "train", transfer_type, storage_settings, **text_kwargs
    )
    eval_data = None
    try:
        ex, ey, _ = load_arrays(
            data_path, eval_split, transfer_type, storage_settings, **text_kwargs
        )
        eval_data = (ex, ey)
    except (FileNotFoundError, KeyError):
        if eval_n:
            hold = min(int(eval_n), len(y) // 5)
            rng = np.random.default_rng([seed, 0xE7A1])
            hold_idx = rng.choice(len(y), size=hold, replace=False)
            mask = np.ones(len(y), bool)
            mask[hold_idx] = False
            eval_data = (x[hold_idx], y[hold_idx])
            x, y = x[mask], y[mask]
            if writer is not None:
                writer = writer[mask]
    if eval_data is not None and eval_n:
        eval_data = (eval_data[0][: int(eval_n)], eval_data[1][: int(eval_n)])
    ds = partition(
        x, y, num_clients, n_local,
        scheme=scheme, alpha=alpha, writer=writer, seed=seed,
    )
    num_classes = int(np.max(y)) + 1 if len(y) else 0
    return ds, eval_data, num_classes
