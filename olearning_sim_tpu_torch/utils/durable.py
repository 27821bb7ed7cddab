"""Crash-consistent file commit helpers.

The platform's durable artifacts (staged file-repo uploads, checkpoint
manifests, supervision records) all follow the same commit discipline:
write to a unique temp file in the destination directory, fsync the data,
``os.replace`` onto the final name (atomic within one filesystem), then
fsync the parent directory so the rename itself survives a host crash.
``os.replace`` without the surrounding fsyncs only protects against
*process* death — after a power cut or kernel panic the filesystem may
replay the rename but not the data, "committing" a zero-length or torn
file. These helpers are that discipline, written once.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-committed rename inside it is durable.
    Best-effort: some filesystems (and all of Windows) refuse directory
    fds — an environment limitation, not a caller error."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        with contextlib.suppress(OSError):
            os.fsync(fd)
    finally:
        os.close(fd)


def copy_file_durable(src: str, tmp: str) -> None:
    """Copy ``src`` into the (already created) staging path ``tmp`` and
    fsync the data before returning — the pre-rename half of a durable
    stage-then-rename."""
    with open(src, "rb") as fin, open(tmp, "wb") as fout:
        shutil.copyfileobj(fin, fout)
        fout.flush()
        os.fsync(fout.fileno())


def commit_replace(tmp: str, dest: str) -> None:
    """The commit point: atomically rename the fsynced staging file onto
    ``dest`` and fsync the parent directory."""
    os.replace(tmp, dest)
    fsync_dir(os.path.dirname(dest) or ".")


def atomic_write_bytes(dest: str, data: bytes) -> None:
    """Write ``data`` to ``dest`` with full tmp -> fsync -> replace ->
    fsync(dir) crash consistency. A reader never observes a partial file;
    after return the content survives a host crash."""
    directory = os.path.dirname(dest) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(dest) + ".", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        commit_replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            with contextlib.suppress(OSError):
                os.remove(tmp)
