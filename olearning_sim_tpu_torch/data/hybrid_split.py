"""Hybrid data splitting: give the logical and device halves disjoint shards.

Reference: ``HybridDataSplitter.split_data_classification``
(``ols_core/taskMgr/utils/utils_runner.py:195-382``) — after the ILP decides
how many device-rounds run logically vs on phones, download the dataset,
stratified-split it by label in that proportion, re-zip the device share and
re-upload both halves. The rebuild does the same through the
:mod:`formats`/:mod:`ingest` parsers, staging each half as an NPZ zip next
to the original archive (``<base>_logical.zip`` / ``<base>_device.zip``).

A copy of the JAX package's ``data/hybrid_split.py``, but for its temporary
directories: one that staged uploaded halves is removed after the upload,
and one holding local halves is the caller's to remove (the task manager
removes it when it releases the task).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import zipfile
from typing import Any, Optional, Tuple

import numpy as np

from olearning_sim_tpu_torch.data import ingest


def stratified_split_indices(
    y: np.ndarray, device_fraction: float, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-label proportional split (the reference's
    ``train_test_split(..., stratify=y)``): every label contributes
    ``device_fraction`` of its rows to the device half. Returns
    (logical_idx, device_idx) — disjoint, covering all rows."""
    if not 0.0 <= device_fraction <= 1.0:
        raise ValueError(f"device_fraction must be in [0,1], got {device_fraction}")
    rng = np.random.default_rng(seed)
    logical, device = [], []
    for label in np.unique(y):
        rows = rng.permutation(np.flatnonzero(y == label))
        k = int(round(len(rows) * device_fraction))
        device.append(rows[:k])
        logical.append(rows[k:])
    return np.sort(np.concatenate(logical)), np.sort(np.concatenate(device))


def _write_npz_zip(path: str, x: np.ndarray, y: np.ndarray,
                   writer: Optional[np.ndarray]) -> None:
    with tempfile.TemporaryDirectory() as d:
        npz = os.path.join(d, "train.npz")
        payload = {"x": x, "y": y}
        if writer is not None:
            payload["writer"] = writer
        np.savez_compressed(npz, **payload)
        with zipfile.ZipFile(path, "w") as zf:
            zf.write(npz, "train.npz")


def stage_hybrid_split(
    data_path: str,
    device_fraction: float,
    transfer_type: Any = None,
    storage_settings: Optional[dict] = None,
    seed: int = 0,
    repo=None,
    dest_prefix: Optional[str] = None,
) -> Tuple[str, str]:
    """Fetch ``data_path``, split it, stage both halves, return
    ``(logical_path, device_path)``.

    With a ``repo`` (FileRepo), the halves are uploaded next to the
    original (``<base>_logical.zip``/``<base>_device.zip``) — the
    reference's re-zip-and-re-upload step. Without one, they are staged
    as local files (single-host mode), under ``dest_prefix`` when given,
    else in a new temporary directory that is the caller's to remove (the
    halves' directory). A temporary directory that staged uploaded halves
    is removed once they are uploaded (the JAX package keeps both).
    """
    x, y, writer = ingest.load_arrays(
        data_path, "train", transfer_type, storage_settings
    )
    li, di = stratified_split_indices(y, device_fraction, seed)
    base = data_path[:-4] if data_path.endswith(".zip") else data_path
    staging = None
    if dest_prefix is None:
        staging = tempfile.mkdtemp(prefix="olshybrid_")
        dest_prefix = os.path.join(staging, os.path.basename(base))
    local_logical = f"{dest_prefix}_logical.zip"
    local_device = f"{dest_prefix}_device.zip"
    try:
        _write_npz_zip(local_logical, x[li], y[li],
                       writer[li] if writer is not None else None)
        _write_npz_zip(local_device, x[di], y[di],
                       writer[di] if writer is not None else None)
        if repo is None:
            staging = None  # the caller's now
            return local_logical, local_device
        remote_logical = f"{base}_logical.zip"
        remote_device = f"{base}_device.zip"
        if not repo.upload_file(local_logical, remote_logical):
            raise IOError(f"failed to upload logical share to {remote_logical}")
        if not repo.upload_file(local_device, remote_device):
            raise IOError(f"failed to upload device share to {remote_device}")
        return remote_logical, remote_device
    finally:
        if staging is not None:
            shutil.rmtree(staging, ignore_errors=True)


def device_fraction_of(td) -> float:
    """Device share of the total simulated device-rounds for one TargetData
    (post-allocation): sum(device) / (sum(logical) + sum(device))."""
    logical = sum(td.allocation.allocationLogicalSimulation)
    device = sum(td.allocation.allocationDeviceSimulation)
    total = logical + device
    return device / total if total else 0.0
