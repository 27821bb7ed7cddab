"""Parsers for the benchmark datasets' canonical on-disk formats.

The reference downloads a per-task archive and feeds CSV/MNN files to
operator subprocesses (``ols_core/taskMgr/utils/utils_run_task.py:174-325``);
the expected file names per task type live in
``ols_core/config/task_type_config.yaml``. The rebuild ingests the standard
public formats of the BASELINE datasets directly:

- MNIST / FEMNIST-style: IDX (``train-images-idx3-ubyte`` etc., the
  yann.lecun.com binary layout; FEMNIST additionally carries a writer-id
  array or LEAF JSON).
- CIFAR-10 / CIFAR-100: the "binary version" (``data_batch_*.bin`` /
  ``train.bin``: 1 or 2 label bytes + 3072 image bytes per record).
- Sent140: CSV with (polarity, ..., user, text) columns, hashed-token
  encoding.
- NPZ: ``{"x": ..., "y": ..., ["writer": ...]}`` escape hatch for
  pre-processed populations.

All parsers return ``(x, y, writer)`` where ``x`` is float32 in [0, 1]
(images) or int32 token ids (text), ``y`` is int32 labels, and ``writer``
is an optional int32 natural-partition key (FEMNIST writers, Sent140
users).
"""

from __future__ import annotations

import csv
import gzip
import io
import json
import os
import pickle
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

Parsed = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]


def _open_maybe_gzip(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_idx(path: str) -> np.ndarray:
    """Read one IDX file (optionally gzipped). Layout: 2 zero bytes, dtype
    code, ndim, then ndim big-endian uint32 dims, then row-major data."""
    with _open_maybe_gzip(path) as f:
        raw = f.read()
    if len(raw) < 4:
        raise ValueError(f"{path}: truncated IDX header")
    zeros, dtype_code, ndim = raw[0] << 8 | raw[1], raw[2], raw[3]
    if zeros != 0:
        raise ValueError(f"{path}: bad IDX magic {raw[:4]!r}")
    dtypes = {
        0x08: np.uint8, 0x09: np.int8, 0x0B: np.dtype(">i2"),
        0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"), 0x0E: np.dtype(">f8"),
    }
    if dtype_code not in dtypes:
        raise ValueError(f"{path}: unknown IDX dtype 0x{dtype_code:02x}")
    dims = struct.unpack(f">{ndim}I", raw[4 : 4 + 4 * ndim])
    data = np.frombuffer(raw, dtypes[dtype_code], offset=4 + 4 * ndim)
    expected = int(np.prod(dims)) if dims else 0
    if data.size < expected:
        raise ValueError(f"{path}: IDX payload shorter than header dims {dims}")
    return data[:expected].reshape(dims)


def load_mnist_dir(d: str, split: str = "train") -> Parsed:
    """MNIST from a directory of IDX files. ``split``: train | test (t10k)."""
    stems = {"train": ["train"], "test": ["t10k", "test"]}[split]
    img = _find_file(d, [f"{s}-images" for s in stems], ["idx3-ubyte", "idx3-ubyte.gz"])
    lab = _find_file(d, [f"{s}-labels" for s in stems], ["idx1-ubyte", "idx1-ubyte.gz"])
    x = read_idx(img).astype(np.float32) / 255.0
    y = read_idx(lab).astype(np.int32)
    if x.ndim == 3:
        x = x[..., None]  # [N, 28, 28, 1]
    writer = None
    wfile = _find_file(d, [f"{s}-writers" for s in stems], ["idx1-ubyte", "npy"], required=False)
    if wfile:  # FEMNIST-style writer partition key
        writer = (np.load(wfile) if wfile.endswith(".npy") else read_idx(wfile)).astype(np.int32)
    return x, y, writer


def load_cifar_dir(d: str, split: str = "train", coarse: bool = False) -> Parsed:
    """CIFAR-10/100 "binary version". CIFAR-10: 1 label byte + 3072 image
    bytes; CIFAR-100: coarse + fine label bytes + 3072. Detects the variant
    from the file names (``data_batch_*.bin``/``test_batch.bin`` vs
    ``train.bin``/``test.bin``)."""
    names = sorted(os.listdir(d))
    c10 = [n for n in names if n.startswith("data_batch") and n.endswith(".bin")]
    c100_train = [n for n in names if n == "train.bin"]
    if split == "train":
        files, label_bytes = (c10, 1) if c10 else (c100_train, 2)
    else:
        files = [n for n in names if n in ("test_batch.bin", "test.bin")]
        label_bytes = 1 if c10 or any(n == "test_batch.bin" for n in files) else 2
        if any(n == "test.bin" for n in files) and not c10:
            label_bytes = 2
    if not files:
        raise FileNotFoundError(f"no CIFAR binary files for split={split!r} in {d}")
    rec = label_bytes + 3072
    xs, ys = [], []
    for n in files:
        raw = np.fromfile(os.path.join(d, n), np.uint8)
        if raw.size % rec != 0:
            raise ValueError(f"{n}: size {raw.size} not a multiple of record {rec}")
        rows = raw.reshape(-1, rec)
        # CIFAR-100 rows: [coarse, fine, pixels]; fine is the standard label.
        ys.append(rows[:, 0 if (label_bytes == 1 or coarse) else 1])
        xs.append(rows[:, label_bytes:])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y = np.concatenate(ys).astype(np.int32)
    return x.astype(np.float32) / 255.0, y, None


class _CifarUnpickler(pickle.Unpickler):
    """Unpickler allowing only what the published CIFAR batches contain:
    plain containers (handled without ``find_class``) and numpy array
    reconstruction. Everything else — ``os.system``, ``builtins.eval``,
    arbitrary class instantiation — raises instead of importing."""

    _ALLOWED = {
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),  # numpy >= 2 module name
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        # protocol-2 pickles route py2-str/bytes payloads through
        # _codecs.encode (side-effect-free byte encoding) — the genuine
        # python-2 CIFAR batches need it under encoding="bytes".
        ("_codecs", "encode"),
    }

    def find_class(self, module, name):  # noqa: D102 — see class docstring
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"global {module}.{name} forbidden in CIFAR batch pickles"
        )


def load_cifar_python_dir(d: str, split: str = "train", coarse: bool = False) -> Parsed:
    """CIFAR-10/100 "python version" — the format of the actually-published
    ``cifar-10-python.tar.gz`` / ``cifar-100-python.tar.gz`` archives: pickled
    dicts with ``data`` (uint8 [N, 3072], channel-planar R/G/B row-major) and
    ``labels`` / ``fine_labels``+``coarse_labels``. File names:
    ``data_batch_1..5``/``test_batch`` (CIFAR-10) or ``train``/``test``
    (CIFAR-100). Keys may be bytes (the published files are python-2
    pickles). Unpickling is RESTRICTED: the published batches need nothing
    beyond dict/list/bytes plus numpy array reconstruction, so
    :class:`_CifarUnpickler` refuses every other global — a malicious
    pickle arriving through the remote FileRepo download path gets
    ``UnpicklingError``, not code execution (the reference trusts its
    downloaded task data outright, ``utils_run_task.py:174-325``)."""
    names = sorted(os.listdir(d))
    if any(n.startswith("data_batch") for n in names):
        files = ([n for n in names if n.startswith("data_batch")]
                 if split == "train" else ["test_batch"])
        label_key = "labels"
    else:
        files = ["train"] if split == "train" else ["test"]
        label_key = "coarse_labels" if coarse else "fine_labels"
    missing = [n for n in files if n not in names]
    if missing:
        raise FileNotFoundError(f"CIFAR python files {missing} not in {d}")

    def get(blob, key):
        return blob[key.encode()] if key.encode() in blob else blob[key]

    xs, ys = [], []
    for n in files:
        with open(os.path.join(d, n), "rb") as f:
            blob = _CifarUnpickler(f, encoding="bytes").load()
        xs.append(np.asarray(get(blob, "data"), np.uint8))
        ys.append(np.asarray(get(blob, label_key), np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x.astype(np.float32) / 255.0, np.concatenate(ys), None


def hash_tokenize(text: str, vocab_size: int, seq_len: int) -> np.ndarray:
    """Deterministic hashed-token encoding (token 0 = padding). Stands in
    for the DistilBERT tokenizer without bundling vocab files; stable across
    processes (crc32, not PYTHONHASHSEED)."""
    import zlib

    toks = [1 + zlib.crc32(w.lower().encode()) % (vocab_size - 1)
            for w in text.split()[:seq_len]]
    out = np.zeros(seq_len, np.int32)
    out[: len(toks)] = toks
    return out


def load_sent140_csv(path: str, vocab_size: int = 30522, seq_len: int = 64,
                     max_rows: Optional[int] = None) -> Parsed:
    """Sent140 CSV: ``polarity,id,date,query,user,text``; polarity 0/4 ->
    label 0/1; ``user`` is the natural partition key."""
    xs, ys, users = [], [], []
    user_ids: Dict[str, int] = {}
    with open(path, newline="", encoding="utf-8", errors="replace") as f:
        for i, row in enumerate(csv.reader(f)):
            if max_rows is not None and i >= max_rows:
                break
            if len(row) < 6:
                continue
            polarity, user, text = row[0], row[4], row[5]
            try:
                label = {0: 0, 4: 1, 2: 1}[int(polarity)]
            except (ValueError, KeyError):
                continue
            xs.append(hash_tokenize(text, vocab_size, seq_len))
            ys.append(label)
            users.append(user_ids.setdefault(user, len(user_ids)))
    if not xs:
        raise ValueError(f"{path}: no parsable sent140 rows")
    return (np.stack(xs), np.asarray(ys, np.int32), np.asarray(users, np.int32))


def load_leaf_json(path: str, vocab_size: int = 30522, seq_len: int = 64) -> Parsed:
    """LEAF-format JSON (FEMNIST/Sent140 as published by the LEAF benchmark):
    ``{"users": [...], "user_data": {u: {"x": [...], "y": [...]}}}``."""
    with open(path, encoding="utf-8") as f:
        blob = json.load(f)
    xs: List[np.ndarray] = []
    ys: List[int] = []
    writers: List[int] = []
    for wid, user in enumerate(blob["users"]):
        ud = blob["user_data"][user]
        for xv, yv in zip(ud["x"], ud["y"]):
            if isinstance(xv, str):
                xs.append(hash_tokenize(xv, vocab_size, seq_len))
            else:
                a = np.asarray(xv, np.float32)
                if a.size == 784:  # FEMNIST flattened 28x28
                    a = a.reshape(28, 28, 1)
                xs.append(a)
            ys.append(int(yv))
            writers.append(wid)
    return np.stack(xs), np.asarray(ys, np.int32), np.asarray(writers, np.int32)


def load_npz(path: str) -> Parsed:
    blob = np.load(path, allow_pickle=False)
    if "x" not in blob or "y" not in blob:
        raise KeyError(f"{path}: npz must contain 'x' and 'y'")
    x = blob["x"]
    if np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float32)
    writer = blob["writer"].astype(np.int32) if "writer" in blob else None
    return x, blob["y"].astype(np.int32), writer


def _find_file(d: str, stems: List[str], suffixes: List[str], required: bool = True) -> Optional[str]:
    names = os.listdir(d)
    for stem in stems:
        for suf in suffixes:
            for n in names:
                if n.startswith(stem) and n.endswith(suf):
                    return os.path.join(d, n)
    if required:
        raise FileNotFoundError(f"no file matching {stems}x{suffixes} in {d} (have {sorted(names)[:10]})")
    return None


def detect_and_load(d: str, split: str = "train", **text_kwargs) -> Parsed:
    """Sniff the dataset format inside directory ``d`` and parse it.

    Detection order: NPZ ({split}.npz or data.npz) -> IDX (MNIST/FEMNIST) ->
    CIFAR binaries -> LEAF JSON -> Sent140 CSV.
    """
    names = sorted(os.listdir(d))
    for cand in (f"{split}.npz", "data.npz"):
        if cand in names:
            return load_npz(os.path.join(d, cand))
    if any("idx3-ubyte" in n for n in names):
        return load_mnist_dir(d, split)
    if any(n.endswith(".bin") for n in names):
        return load_cifar_dir(d, split)
    if any(n.startswith("data_batch") for n in names) or (
        "meta" in names and {"train", "test"} & set(names)
    ):
        return load_cifar_python_dir(d, split)
    ljson = [n for n in names if n.endswith(".json")]
    if ljson:
        tk = {k: v for k, v in text_kwargs.items() if k in ("vocab_size", "seq_len")}
        return load_leaf_json(os.path.join(d, ljson[0]), **tk)
    csvs = [n for n in names if n.endswith(".csv")]
    if csvs:
        pick = [n for n in csvs if split in n] or csvs
        return load_sent140_csv(os.path.join(d, pick[0]), **text_kwargs)
    # single subdirectory (zip roots often nest once)
    subdirs = [n for n in names if os.path.isdir(os.path.join(d, n))]
    if len(subdirs) == 1:
        return detect_and_load(os.path.join(d, subdirs[0]), split, **text_kwargs)
    raise FileNotFoundError(f"unrecognized dataset layout in {d}: {names[:10]}")
