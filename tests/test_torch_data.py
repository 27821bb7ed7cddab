"""The port's real-dataset ingest against the JAX package's, on archives the
tests write from a seed in the published layouts: every format parser, the
partitioners, ``load_population`` (a holdout, a test split, zip and tar),
the archive guards (zip traversal, tar links with and without
``filter="data"``, the CIFAR pickle), the ingest cache (its bound, and the
reference's cache key, copied as it is), the hybrid split, the bridge's
populations and eval sets on MNIST and Sent140 archives (local and over
HTTP), a runner and a round on real data against JAX's, the manager's
hybrid staging, and a real-data task resumed from its checkpoint."""

import csv
import importlib
import io
import json
import os
import pickle
import tarfile
import tempfile
import zipfile

import jax
import numpy as np
import pytest
import torch

from olearning_sim_tpu.data import formats as jfmt
from olearning_sim_tpu.data import hybrid_split as jhyb
from olearning_sim_tpu.data import ingest as jing
from olearning_sim_tpu_torch.data import formats as tfmt
from olearning_sim_tpu_torch.data import hybrid_split as thyb
from olearning_sim_tpu_torch.data import ingest as ting
from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
from olearning_sim_tpu_torch.weights import params_from_jax
from test_data import make_cifar10_dir, make_cifar100_dir, make_mnist_dir, write_idx

import torch_threads  # noqa: F401

# The packages' data/__init__ export the function partition over the module.
jpart = importlib.import_module("olearning_sim_tpu.data.partition")
tpart = importlib.import_module("olearning_sim_tpu_torch.data.partition")
PACKAGES = (("jax", jfmt, jing, jpart, jhyb), ("port", tfmt, ting, tpart, thyb))
WORDS = ["the", "day", "phone", "rain", "train", "lunch", "work", "music", "game", "city",
         "home", "night", "friend", "movie", "coffee", "code"]
GOOD, BAD = ["love", "great", "happy"], ["hate", "awful", "sad"]


@pytest.fixture(autouse=True)
def _fresh_caches(tmp_path, monkeypatch):
    """Empty ingest caches, and the archives both packages extract (into
    ``tempfile.mkdtemp`` directories they never remove) kept under the
    test's own directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    jing.clear_cache()
    ting.clear_cache()
    yield
    jing.clear_cache()
    ting.clear_cache()


def _same(a, b):
    """Parsed tuples, arrays or None: equal bitwise, dtype included."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if a is None:
        assert b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _same_ds(a, b):
    for f in ("x", "y", "num_samples", "client_uid", "weight"):
        _same(getattr(a, f), getattr(b, f))
    assert a.num_real_clients == b.num_real_clients


def write_sent140(path, n, users, seed, extra_bad_rows=True):
    """A Sent140 CSV (polarity,id,date,query,user,text) from a seeded word
    list; the label follows the sentiment words."""
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        for i in range(n):
            label = int(rng.integers(0, 2))
            words = list(rng.choice(WORDS, size=int(rng.integers(3, 12))))
            words.insert(int(rng.integers(0, len(words))), str(rng.choice(GOOD if label else BAD)))
            w.writerow([4 * label, 1000 + i, "Mon Apr 06 22:19:45 PDT 2009", "NO_QUERY",
                        f"user{int(rng.integers(0, users))}", " ".join(words)])
        if extra_bad_rows:
            w.writerow(["x", "short"])
            w.writerow([3, 1, "d", "NO_QUERY", "user0", "bad polarity"])


def _zip_dir(d, zp, prefix=""):
    with zipfile.ZipFile(zp, "w") as zf:
        for name in sorted(os.listdir(d)):
            zf.write(os.path.join(d, name), prefix + name)
    return str(zp)


def _cifar_python(d, hundred, n=12, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    names = ["train", "test"] if hundred else ["data_batch_1", "data_batch_2", "test_batch"]
    for name in names:
        blob = {b"data": rng.integers(0, 256, size=(n, 3072), dtype=np.uint8)}
        if hundred:
            blob[b"fine_labels"] = rng.integers(0, 100, n).tolist()
            blob[b"coarse_labels"] = rng.integers(0, 20, n).tolist()
        else:
            blob[b"labels"] = rng.integers(0, 10, n).tolist()
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(blob, f, protocol=2)
    if hundred:
        with open(os.path.join(d, "meta"), "wb") as f:
            pickle.dump({b"fine_label_names": [b"a"]}, f, protocol=2)


def _leaf(path, text, users=3, per=4, seed=0):
    rng = np.random.default_rng(seed)
    data = {}
    for u in range(users):
        xs = ([" ".join(rng.choice(WORDS, 5)) for _ in range(per)] if text
              else rng.random((per, 784)).round(4).tolist())
        data[f"f{u}"] = {"x": xs, "y": rng.integers(0, 5, per).tolist()}
    with open(path, "w") as f:
        json.dump({"users": list(data), "user_data": data}, f)


# ------------------------------------------------------------------ parsers
@pytest.mark.parametrize("dtype,gz", [("u1", False), ("u1", True), (">i4", False),
                                      (">f4", True)])
def test_read_idx_equal(tmp_path, dtype, gz):
    rng = np.random.default_rng(1)
    arr = (rng.random((3, 4, 5)) * 100).astype(dtype)
    write_idx(tmp_path / "a.idx", arr, gz=gz)
    _same(jfmt.read_idx(str(tmp_path / "a.idx")), tfmt.read_idx(str(tmp_path / "a.idx")))
    _same(tfmt.read_idx(str(tmp_path / "a.idx")), arr)


def test_read_idx_refusals_equal(tmp_path):
    for raw in (b"\x00", b"\x01\x00\x08\x01", b"\x00\x00\x07\x01", b"\x00\x00\x08\x01\x00\x00\x00\x09ab"):
        (tmp_path / "bad").write_bytes(raw)
        msgs = []
        for fmt in (jfmt, tfmt):
            with pytest.raises(ValueError) as e:
                fmt.read_idx(str(tmp_path / "bad"))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("gz,writers", [(False, False), (True, False), (False, True)],
                         ids=["plain", "gz", "writers"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_mnist_equal(tmp_path, gz, writers, split):
    make_mnist_dir(str(tmp_path), n=40, gz=gz,
                   writers=np.arange(40) % 7 if writers else None)
    _same(jfmt.load_mnist_dir(str(tmp_path), split), tfmt.load_mnist_dir(str(tmp_path), split))


@pytest.mark.parametrize("split", ["train", "test"])
def test_cifar10_binary_equal(tmp_path, split):
    make_cifar10_dir(str(tmp_path))
    _same(jfmt.load_cifar_dir(str(tmp_path), split), tfmt.load_cifar_dir(str(tmp_path), split))


@pytest.mark.parametrize("coarse", [False, True], ids=["fine", "coarse"])
def test_cifar100_binary_equal(tmp_path, coarse):
    make_cifar100_dir(str(tmp_path))
    _same(jfmt.load_cifar_dir(str(tmp_path), "train", coarse=coarse),
          tfmt.load_cifar_dir(str(tmp_path), "train", coarse=coarse))


@pytest.mark.parametrize("hundred,coarse,split", [(False, False, "train"),
                                                  (False, False, "test"),
                                                  (True, False, "train"),
                                                  (True, True, "test")])
def test_cifar_python_equal(tmp_path, hundred, coarse, split):
    _cifar_python(str(tmp_path), hundred)
    _same(jfmt.load_cifar_python_dir(str(tmp_path), split, coarse),
          tfmt.load_cifar_python_dir(str(tmp_path), split, coarse))


@pytest.mark.parametrize("kw", [{}, {"vocab_size": 97, "seq_len": 8},
                                {"max_rows": 5}])
def test_sent140_csv_equal(tmp_path, kw):
    write_sent140(tmp_path / "s.csv", 30, 6, 0)
    _same(jfmt.load_sent140_csv(str(tmp_path / "s.csv"), **kw),
          tfmt.load_sent140_csv(str(tmp_path / "s.csv"), **kw))
    assert tfmt.hash_tokenize("Hello World x", 97, 5).tolist() == \
        jfmt.hash_tokenize("Hello World x", 97, 5).tolist()


@pytest.mark.parametrize("text", [False, True], ids=["image", "text"])
def test_leaf_json_equal(tmp_path, text):
    _leaf(tmp_path / "all.json", text)
    _same(jfmt.load_leaf_json(str(tmp_path / "all.json"), vocab_size=97, seq_len=6),
          tfmt.load_leaf_json(str(tmp_path / "all.json"), vocab_size=97, seq_len=6))


@pytest.mark.parametrize("writer", [False, True])
def test_npz_equal(tmp_path, writer):
    rng = np.random.default_rng(0)
    extra = {"writer": np.arange(9) % 3} if writer else {}
    np.savez(tmp_path / "train.npz", x=rng.normal(size=(9, 3)), y=np.arange(9) % 2, **extra)
    _same(jfmt.load_npz(str(tmp_path / "train.npz")), tfmt.load_npz(str(tmp_path / "train.npz")))
    np.savez(tmp_path / "bad.npz", x=np.zeros(3))
    msgs = []
    for fmt in (jfmt, tfmt):
        with pytest.raises(KeyError) as e:
            fmt.load_npz(str(tmp_path / "bad.npz"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _layout(d, kind):
    os.makedirs(d, exist_ok=True)
    if kind == "npz":
        np.savez(os.path.join(d, "data.npz"), x=np.ones((4, 2), np.float64), y=[0, 1, 0, 1])
    elif kind == "mnist":
        make_mnist_dir(d, n=20)
    elif kind == "cifar_bin":
        make_cifar10_dir(d, n_per_batch=5)
    elif kind == "cifar_py":
        _cifar_python(d, hundred=True)
    elif kind == "leaf":
        _leaf(os.path.join(d, "data.json"), text=True)
    elif kind == "sent140":
        write_sent140(os.path.join(d, "training.1600000.processed.noemoticon.csv"), 20, 4, 1)
        write_sent140(os.path.join(d, "testdata.manual.2009.06.14.csv"), 8, 4, 2)
    elif kind == "nested":
        _layout(os.path.join(d, "inner"), "mnist")
    elif kind == "unknown":
        open(os.path.join(d, "README"), "w").close()


@pytest.mark.parametrize("kind", ["npz", "mnist", "cifar_bin", "cifar_py", "leaf", "sent140",
                                  "nested", "unknown"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_detect_and_load_equal(tmp_path, kind, split):
    _layout(str(tmp_path / "d"), kind)
    out = []
    for fmt in (jfmt, tfmt):
        try:
            out.append(fmt.detect_and_load(str(tmp_path / "d"), split, vocab_size=97, seq_len=8))
        except (FileNotFoundError, KeyError) as e:
            out.append((type(e).__name__, str(e)))
    if isinstance(out[0][0], str):
        assert out[0] == out[1]
    else:
        _same(out[0], out[1])


# ------------------------------------------------------------- partitions
@pytest.mark.parametrize("scheme", ["iid", "dirichlet", "by_writer"])
def test_assignments_equal(scheme):
    rng_data = np.random.default_rng(3)
    y = rng_data.integers(0, 5, 200)
    writer = rng_data.integers(0, 23, 200)
    out = []
    for _, _, _, part, _ in PACKAGES:
        rng = np.random.default_rng(9)
        if scheme == "iid":
            out.append(part.iid_assignments(200, 7, rng))
        elif scheme == "dirichlet":
            out.append(part.dirichlet_assignments(y, 7, 0.3, rng))
        else:
            out.append(part.writer_assignments(writer, 7, rng))
    assert len(out[0]) == len(out[1]) == 7
    for a, b in zip(*out):
        _same(a, b)


@pytest.mark.parametrize("scheme", ["iid", "dirichlet", "by_writer", "none", "bogus"])
def test_partition_equal(scheme):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(90, 3)).astype(np.float32)
    y = (np.arange(90) % 4).astype(np.int32)
    writer = None if scheme == "none" else (np.arange(90) % 11).astype(np.int32)
    kind = "by_writer" if scheme == "none" else scheme
    out = []
    for _, _, _, part, _ in PACKAGES:
        try:
            out.append(part.partition(x, y, 6, 10, scheme=kind, alpha=0.4, writer=writer, seed=2))
        except ValueError as e:
            out.append(str(e))
    if isinstance(out[0], str):
        assert out[0] == out[1]
        return
    _same_ds(out[0], out[1])
    assert isinstance(out[1].x, np.ndarray)


def test_to_client_dataset_equal():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = (np.arange(20) % 3).astype(np.int32)
    asg = [np.arange(0, 12), np.arange(12, 14), np.array([], int), np.arange(14, 20)]
    _same_ds(jpart.to_client_dataset(x, y, asg, 5, np.random.default_rng(1), min_samples=3),
             tpart.to_client_dataset(x, y, asg, 5, np.random.default_rng(1), min_samples=3))


# -------------------------------------------------------- load_population
def _archive(tmp_path, kind):
    d = tmp_path / f"raw_{kind}"
    d.mkdir()
    if kind == "npz_holdout":
        rng = np.random.default_rng(0)
        np.savez(d / "train.npz", x=rng.normal(size=(120, 6)).astype(np.float32),
                 y=(np.arange(120) % 4).astype(np.int32), writer=np.arange(120) % 13)
        return _zip_dir(d, tmp_path / "data.zip")
    if kind in ("mnist_zip", "mnist_tar"):
        make_mnist_dir(str(d), n=80, gz=kind == "mnist_tar")
        if kind == "mnist_zip":
            return _zip_dir(d, tmp_path / "mnist.zip", prefix="mnist/")
        tp = tmp_path / "mnist.tar.gz"
        with tarfile.open(tp, "w:gz") as tf:
            for name in sorted(os.listdir(d)):
                tf.add(d / name, f"mnist/{name}")
        return str(tp)
    write_sent140(d / "training.1600000.processed.noemoticon.csv", 150, 20, 5)
    write_sent140(d / "testdata.manual.2009.06.14.csv", 30, 20, 6)
    return _zip_dir(d, tmp_path / "sent140.zip")


POP_CASES = {
    "npz_holdout": dict(num_clients=10, n_local=16, scheme="iid", eval_n=20, seed=3),
    "npz_writer": dict(num_clients=5, n_local=12, scheme="by_writer", eval_n=10, seed=1),
    "mnist_zip": dict(num_clients=8, n_local=9, scheme="dirichlet", alpha=0.5, eval_n=25),
    "mnist_tar": dict(num_clients=6, n_local=20, scheme="iid"),
    "sent140": dict(num_clients=7, n_local=11, scheme="by_writer", eval_n=16,
                    vocab_size=97, seq_len=12),
}


@pytest.mark.parametrize("case", sorted(POP_CASES))
def test_load_population_equal(tmp_path, case):
    path = _archive(tmp_path, {"npz_writer": "npz_holdout"}.get(case, case))
    out = [ing.load_population(path, **POP_CASES[case]) for _, _, ing, _, _ in PACKAGES]
    _same_ds(out[0][0], out[1][0])
    _same(out[0][1], out[1][1])
    assert out[0][2] == out[1][2]
    if case == "npz_holdout":
        assert len(out[1][1][1]) == 20 and int(out[1][0].num_samples.sum()) <= 100


def _malicious_link_tar(tmp_path):
    tar_path = tmp_path / "evil.tar"
    with tarfile.open(tar_path, "w") as tf:
        link = tarfile.TarInfo("sub")
        link.type = tarfile.SYMTYPE
        link.linkname = str(tmp_path / "outside")
        tf.addfile(link)
        payload = tarfile.TarInfo("sub/owned.txt")
        payload.size = 7
        tf.addfile(payload, io.BytesIO(b"escaped"))
    return str(tar_path)


def _traversal_tar(tmp_path):
    tar_path = tmp_path / "up.tar"
    with tarfile.open(tar_path, "w") as tf:
        info = tarfile.TarInfo("../escaped.txt")
        info.size = 1
        tf.addfile(info, io.BytesIO(b"x"))
    return str(tar_path)


def _no_filter(monkeypatch):
    orig = tarfile.TarFile.extractall

    def extractall(self, *args, **kwargs):
        if "filter" in kwargs:
            raise TypeError("extractall() got an unexpected keyword argument 'filter'")
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(tarfile.TarFile, "extractall", extractall)


@pytest.mark.parametrize("archive", ["link", "traversal"])
@pytest.mark.parametrize("branch", ["filter", "fallback"])
def test_tar_guards_raise_alike(tmp_path, monkeypatch, archive, branch):
    path = (_malicious_link_tar if archive == "link" else _traversal_tar)(tmp_path)
    if branch == "fallback":
        _no_filter(monkeypatch)
    errs = []
    for _, _, ing, _, _ in PACKAGES:
        with pytest.raises(Exception) as e:
            ing.fetch_dataset_dir(path)
        errs.append((e.type, str(e.value)))
    assert errs[0][0] == errs[1][0]
    if branch == "fallback" or archive == "link":
        assert errs[0][1] == errs[1][1]
    if branch == "fallback":
        assert errs[1][0] is ValueError
    assert not (tmp_path / "outside" / "owned.txt").exists()


def test_zip_traversal_and_unknown_archive_raise_alike(tmp_path):
    zp = tmp_path / "up.zip"
    with zipfile.ZipFile(zp, "w") as zf:
        zf.writestr("../escaped.txt", "x")
    (tmp_path / "plain.bin").write_bytes(b"not an archive")
    for path in (str(zp), str(tmp_path / "plain.bin"), str(tmp_path / "missing.zip")):
        errs = []
        for _, _, ing, _, _ in PACKAGES:
            with pytest.raises((ValueError, FileNotFoundError)) as e:
                ing.fetch_dataset_dir(path, transfer_type=0)
            errs.append((e.type, str(e.value)))
        assert errs[0] == errs[1]


def test_cifar_pickle_guard_raises_alike(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.getenv, ("HOME",))

    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    for name in ["data_batch_1", "test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump(Evil(), f, protocol=2)
    msgs = []
    for fmt in (jfmt, tfmt):
        with pytest.raises(pickle.UnpicklingError) as e:
            fmt.load_cifar_python_dir(str(d), "train")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "forbidden" in msgs[1]


# ------------------------------------------------------------------ cache
def test_ingest_cache_is_bounded_alike(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    for i in range(5):
        d = tmp_path / f"raw{i}"
        d.mkdir()
        np.savez(d / "train.npz", x=rng.normal(size=(8, 4)).astype(np.float32),
                 y=(np.arange(8) % 2).astype(np.int32))
    keys = []
    for _, _, ing, _, _ in PACKAGES:
        monkeypatch.setattr(ing, "_CACHE_MAX", 3)
        for i in range(5):
            ing.load_arrays(str(tmp_path / f"raw{i}"))
        keys.append([os.path.basename(k[0]) for k in ing._cache])
        hit = ing.load_arrays(str(tmp_path / "raw4"))
        assert ing.load_arrays(str(tmp_path / "raw4")) is hit
    assert keys[0] == keys[1] == ["raw2", "raw3", "raw4"]


def test_cache_key_ignores_text_settings_in_both(tmp_path):
    """The reference's cache key is (path, split) only: a second read of the
    same archive at another seq_len (or over another transfer type) gets
    the first read's arrays. The port copies this (ROADMAP.md section C)."""
    write_sent140(tmp_path / "train.csv", 12, 3, 0, extra_bad_rows=False)
    shapes = []
    for _, _, ing, _, _ in PACKAGES:
        first = ing.load_arrays(str(tmp_path), "train", seq_len=8, vocab_size=97)
        second = ing.load_arrays(str(tmp_path), "train", transfer_type=1, seq_len=16,
                                 vocab_size=50)
        assert second is first
        ing.clear_cache()
        fresh = ing.load_arrays(str(tmp_path), "train", seq_len=16, vocab_size=50)
        shapes.append((first[0].shape, second[0].shape, fresh[0].shape))
    assert shapes[0] == shapes[1] == ((12, 8), (12, 8), (12, 16))


# ------------------------------------------------------------ hybrid split
@pytest.mark.parametrize("frac", [0.0, 0.25, 0.3, 1.0])
def test_stratified_split_indices_equal(frac):
    y = np.random.default_rng(2).integers(0, 5, 301)
    out = [hyb.stratified_split_indices(y, frac, seed=4) for *_, hyb in PACKAGES]
    _same(out[0], out[1])
    assert len(out[1][1]) == sum(int(round(np.sum(y == k) * frac)) for k in range(5))


def test_stratified_split_bounds_equal():
    msgs = []
    for *_, hyb in PACKAGES:
        with pytest.raises(ValueError) as e:
            hyb.stratified_split_indices(np.zeros(4, int), 1.5)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("with_repo", [False, True])
def test_stage_hybrid_split_equal(tmp_path, with_repo):
    from olearning_sim_tpu.storage import LocalFileRepo as JLocal
    from olearning_sim_tpu_torch.storage import LocalFileRepo as TLocal

    path = _archive(tmp_path, "npz_holdout")
    halves = []
    for name, _, ing, _, hyb in PACKAGES:
        repo = None
        if with_repo:
            repo = (JLocal if name == "jax" else TLocal)(root=str(tmp_path / f"store_{name}"))
        dest = str(tmp_path / f"{name}_stage" / "data")
        os.makedirs(os.path.dirname(dest))
        lp, dp = hyb.stage_hybrid_split(path, 0.3, seed=3, repo=repo, dest_prefix=dest)
        if with_repo:
            assert lp.endswith("data_logical.zip") and dp.endswith("data_device.zip")
            lp, dp = (os.path.join(str(tmp_path / f"store_{name}"), p) for p in (lp, dp))
        got = []
        for p in (lp, dp):
            ing.clear_cache()
            got.append(ing.load_arrays(p))
        halves.append(got)
    for a, b in zip(*halves):
        _same(a, b)
    assert len(halves[1][1][1]) == 36 and len(halves[1][0][1]) == 84  # 4 x round(30 * 0.3)


# ----------------------------------------------------------- the bridge
MNIST_PARAMS = {
    "model": {"name": "mlp2", "overrides": {"hidden": [16], "num_classes": 10},
              "input_shape": [28, 28, 1]},
    "algorithm": {"name": "fedavg", "local_lr": 0.1},
    "fedcore": {"batch_size": 4, "max_local_steps": 2, "block_clients": 4},
    "data": {"real": {"n_local": 10, "scheme": "dirichlet", "alpha": 0.5}, "eval_n": 30,
             "compute_profiles": {"high": 2, "low": 1}},
}
SENT140_SMALL = {"depth": 1, "width": 16, "heads": 2, "mlp_dim": 32, "vocab_size": 97,
                 "max_len": 16}
SENT140_PARAMS = {
    "model": {"name": "distilbert", "overrides": dict(SENT140_SMALL, num_classes=2),
              "input_shape": [16]},
    "algorithm": {"name": "fedadam", "local_lr": 0.05, "server_lr": 0.01},
    "fedcore": {"batch_size": 4, "max_local_steps": 2, "block_clients": 4},
    "data": {"real": {"n_local": 8, "scheme": "by_writer"}, "eval_n": 24},
}


def real_task(task_id, data_path, params, rounds=2, transfer="FILE", checkpoint=None,
              evaluate=True):
    """The runner test's task JSON (two device classes, a flow_dispatch
    strategy) over a real archive."""
    from test_torch_runner import task_json

    task = task_json(task_id, rounds=rounds, evaluate=evaluate)
    td = task["target"]["data"][0]
    td.update(data_path=data_path, data_transfer_type=transfer)
    p = json.loads(json.dumps(params))
    if checkpoint is not None:
        p["checkpoint"] = checkpoint
    task["operatorflow"]["operators"][0]["logical_simulation"]["operator_params"] = \
        json.dumps(p)
    return task


def _jax_build(task):
    from olearning_sim_tpu.engine.task_bridge import build_runner_from_taskconfig as jbuild
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan

    return jbuild(task, plan=make_mesh_plan(devices=jax.devices()[:1]))


def _host_ds(ds):
    """A placed population's arrays on the host: floats (bf16 features
    included) as float32, integers as int64 (the port keeps labels in
    int64, JAX in int32)."""
    out = {}
    for f in ("x", "y", "num_samples", "client_uid", "weight"):
        v = getattr(ds, f)
        if isinstance(v, torch.Tensor):
            v = v.float() if v.is_floating_point() else v
            v = v.numpy()
        v = np.asarray(v)
        out[f] = v.astype(np.int64 if v.dtype.kind in "iu" else np.float32)
    return out


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("archives")
    mnist = tmp / "mnist"
    mnist.mkdir()
    make_mnist_dir(str(mnist), n=160)
    sent = tmp / "sent140"
    sent.mkdir()
    write_sent140(sent / "training.1600000.processed.noemoticon.csv", 240, 30, 7)
    write_sent140(sent / "testdata.manual.2009.06.14.csv", 40, 30, 8)
    return {"mnist": _zip_dir(mnist, tmp / "mnist.zip"),
            "sent140": _zip_dir(sent, tmp / "sent140.zip", prefix="sent140/")}


@pytest.mark.parametrize("which", ["mnist", "sent140"])
def test_bridge_populations_equal_jax(archives, which):
    params = MNIST_PARAMS if which == "mnist" else SENT140_PARAMS
    task = real_task(f"real_{which}", archives[which], params)
    jrunner = _jax_build(task)
    trunner = build_runner_from_taskconfig(task, device="cpu")
    jp, tp = jrunner.populations[0], trunner.populations[0]
    jds, tds = _host_ds(jp.dataset), _host_ds(tp.dataset)
    for f in jds:
        _same(jds[f], tds[f])
    _same(tuple(np.asarray(a) for a in jp.eval_data), tuple(np.asarray(a) for a in tp.eval_data))
    assert tp.num_classes == jp.num_classes == (10 if which == "mnist" else 2)
    assert tp.dataset.num_real_clients == 12 and len(tp.eval_data[1]) == \
        (30 if which == "mnist" else 24)
    if which == "sent140":
        assert tp.dataset.x.dtype == torch.int32 and tp.eval_data[0].shape == (24, 16)


def test_bridge_refuses_more_classes_than_the_head(archives):
    params = json.loads(json.dumps(MNIST_PARAMS))
    params["model"]["overrides"]["num_classes"] = 4
    task = real_task("few_classes", archives["mnist"], params)
    with pytest.raises(ValueError) as want:
        _jax_build(task)
    with pytest.raises(ValueError) as got:
        build_runner_from_taskconfig(task, device="cpu")
    assert str(got.value) == str(want.value) and "classes" in str(got.value)


def test_bridge_http_data_path_equals_file(archives, tmp_path):
    """dataTransferType HTTP: the archive fetched from a local http.server
    thread gives the population of the same archive read as a FILE path."""
    from test_torch_storage import _Server

    srv = _Server(os.path.dirname(archives["mnist"]))
    try:
        url = f"{srv.url}/{os.path.basename(archives['mnist'])}"
        http_runner = build_runner_from_taskconfig(
            real_task("over_http", url, MNIST_PARAMS, transfer="HTTP"), device="cpu")
    finally:
        srv.close()
    file_runner = build_runner_from_taskconfig(
        real_task("over_file", archives["mnist"], MNIST_PARAMS), device="cpu")
    a, b = _host_ds(http_runner.populations[0].dataset), _host_ds(file_runner.populations[0].dataset)
    for f in a:
        _same(a[f], b[f])
    _same(tuple(http_runner.populations[0].eval_data), tuple(file_runner.populations[0].eval_data))


def test_real_data_runner_matches_jax_runner(archives):
    """The runner test's comparison (JAX's initial params and minibatch
    draws handed to the port) on the MNIST archive: host outputs exact,
    numbers within mlp2's bf16 bounds."""
    from olearning_sim_tpu.telemetry import MetricsRegistry
    from test_torch_runner import LOSS_ATOL, PARAM_ATOL, _run_jax, _run_port

    registry = MetricsRegistry()
    jrunner, jrepo, jhist, init = _run_jax(
        real_task("real_jax", archives["mnist"], MNIST_PARAMS, rounds=3), registry)
    trunner, trepo, thist = _run_port(
        real_task("real_port", archives["mnist"], MNIST_PARAMS, rounds=3), registry, init)
    for col in ("logical_target", "logical_result", "logical_round", "logical_operator"):
        assert trepo.get_item_value("real_port", col) == jrepo.get_item_value("real_jax", col)
    for jr, tr in zip(jhist, thist):
        j, t = jr["train"]["data_0"], tr["train"]["data_0"]
        for k in ("released", "dropped", "clients_trained", "sim_duration_s"):
            assert t[k] == j[k], (jr["round"], k)
        assert abs(t["mean_loss"] - j["mean_loss"]) <= LOSS_ATOL
        assert abs(tr["evaluate"]["data_0"]["eval_loss"]
                   - jr["evaluate"]["data_0"]["eval_loss"]) <= LOSS_ATOL
    jparams = params_from_jax(jax.tree.map(np.asarray, jrunner.states["data_0"].params))
    for k, v in jparams.items():
        np.testing.assert_allclose(trunner.states["data_0"].params[k].numpy(), v.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_real_text_round_matches_jax(archives):
    """One FedAdam round of an f32 DistilBERT on the Sent140 archive's
    by-writer population, the port handed JAX's minibatch indices: params
    within tests/test_torch_fedcore.py's f32 bounds."""
    import jax.numpy as jnp

    from olearning_sim_tpu.engine import algorithms as jalg
    from olearning_sim_tpu.engine import fedcore as jfc
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu_torch.engine import algorithms as talg
    from olearning_sim_tpu_torch.engine import fedcore as tfc
    from test_torch_fedcore import PARAM_ATOL, PARAM_RTOL, _jax_indices

    kw = dict(num_clients=8, n_local=8, scheme="by_writer", vocab_size=97, seq_len=16)
    jds, _, _ = jing.load_population(archives["sent140"], **kw)
    tds, _, _ = ting.load_population(archives["sent140"], **kw)
    _same_ds(jds, tds)
    cfg = dict(batch_size=4, max_local_steps=2, block_clients=4)
    plan = make_mesh_plan(devices=jax.devices()[:1])
    over = dict(SENT140_SMALL, num_classes=2)
    jcore = jfc.build_fedcore("distilbert", jalg.fedadam(0.05, 0.01), plan,
                              jfc.FedCoreConfig(**cfg),
                              model_overrides=dict(over, dtype=jnp.float32), input_shape=(16,))
    tcore = tfc.build_fedcore("distilbert", talg.fedadam(0.05, 0.01), tfc.FedCoreConfig(**cfg),
                              model_overrides=dict(over, dtype=torch.float32), device="cpu")
    jstate = jcore.init_state(jax.random.key(0))
    tstate = tcore.init_state(device="cpu", params=params_from_jax(
        jax.tree.map(np.asarray, jstate.params)))
    jplaced = jds.pad_for(plan, 4).place(plan)
    tplaced = tds.pad_for(4).to("cpu")
    idx = _jax_indices(np.asarray(jax.random.key_data(jstate.base_key)),
                       tplaced.client_uid.numpy(), tplaced.num_samples.numpy(), 0, 2, 4)
    jstate, jm = jcore.round_step(jstate, jplaced)
    tstate, tm = tcore.round_step(tstate, tplaced, indices=torch.from_numpy(idx))
    assert float(tm.clients_trained) == float(jm.clients_trained) == 8
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k, v in ref.items():
        np.testing.assert_allclose(tstate.params[k].numpy(), v.numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=k)


def test_real_data_task_resumes_bitwise(archives, tmp_path):
    """A real-data task preempted at round 2's start resumes from its
    checkpoint to the uninterrupted run's state, bit for bit."""
    from olearning_sim_tpu_torch.resilience import HostPreemption
    from olearning_sim_tpu_torch.resilience import faults as tfaults
    from test_torch_checkpoint import _assert_same_state

    straight = build_runner_from_taskconfig(
        real_task("real_ck", archives["sent140"], SENT140_PARAMS, rounds=4), device="cpu")
    straight.run()
    ckpt = {"directory": str(tmp_path / "{task_id}"), "every": 1}
    first = build_runner_from_taskconfig(
        real_task("real_ck", archives["sent140"], SENT140_PARAMS, rounds=4, checkpoint=ckpt),
        device="cpu")
    plan = {"seed": 0, "specs": [{"point": "runner.round_begin", "rounds": [2],
                                  "error": "preempt"}]}
    with tfaults.chaos(tfaults.FaultPlan.from_dict(plan)):
        with pytest.raises(HostPreemption):
            first.run()
    ting.clear_cache()  # the resumed runner parses the archive afresh
    resumed = build_runner_from_taskconfig(
        real_task("real_ck", archives["sent140"], SENT140_PARAMS, rounds=4, checkpoint=ckpt),
        device="cpu")
    history = resumed.run()
    assert [h["round"] for h in history] == [0, 1, 2, 3]
    _assert_same_state(resumed, straight)
    assert history == json.loads(json.dumps(straight.history, default=float))


# ----------------------------------------------------------- the manager
def _hybrid_task(task_id, data_path):
    return {
        "user_id": "u", "task_id": task_id,
        "target": {"priority": 1, "data": [{
            "name": "data_0", "data_path": data_path,
            "data_split_type": True, "data_transfer_type": "FILE",
            "task_type": "classification",
            "total_simulation": {"devices": ["high"], "nums": [20], "dynamic_nums": [0]},
            "allocation": {"optimization": False, "logical_simulation": [15],
                           "device_simulation": [5],
                           "running_response": {"devices": [], "nums": []}},
        }]},
        "operatorflow": {"flow_setting": {"round": 1}, "operators": [{
            "name": "train", "input": [],
            "logical_simulation": {"operator_code_path": "builtin:train",
                                   "operator_entry_file": "", "operator_transfer_type": "FILE",
                                   "operator_params": "{}"},
            "operation_behavior_controller": {"use_gradient_house": False,
                                              "strategy_gradient_house": ""}}]},
    }


class _Phone:
    def __init__(self):
        self.jobs = []

    def submit_task(self, task_id, rounds, operators, data):
        self.jobs.append(data)
        return True


def test_manager_stages_hybrid_split_and_routes_device_path_alike(tmp_path):
    """tests/test_hybrid_split.py's manager scenario in both packages: the
    logical half's dataPath rewritten to its shard, the device shard's
    rows equal, its path handed to the phone job, and the staged file
    removed when the task's staging is dropped."""
    from olearning_sim_tpu.taskmgr.codecs import json2taskconfig as jjson
    from olearning_sim_tpu.taskmgr.task_manager import TaskManager as JManager
    from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig as tjson
    from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager as TManager

    path = _archive(tmp_path, "npz_holdout")
    out = []
    for mgr, codec, ing in ((JManager(), jjson, jing), (TManager(device="cpu"), tjson, ting)):
        tc = codec(_hybrid_task("hybrid_t1", path))
        mgr._stage_hybrid_data(tc)
        td = tc.target.targetData[0]
        staged = mgr._device_paths[("hybrid_t1", "data_0")]
        ing.clear_cache()
        logical, device = ing.load_arrays(td.dataPath), ing.load_arrays(staged)
        mgr._phone_client = _Phone()
        mgr._task_repo.add_task("hybrid_t1")
        assert mgr._submit_device_half(tc)
        job = mgr._phone_client.jobs[0][0]
        assert job["data_path"] == staged and staged.endswith("_device.zip")
        assert td.dataPath.endswith("_logical.zip")
        mgr._cleanup_hybrid_staging("hybrid_t1")
        assert not os.path.exists(staged) and not mgr._device_paths
        out.append((logical, device, {k: v for k, v in job.items() if k != "data_path"},
                    json.loads(mgr._task_repo.get_item_value("hybrid_t1", "device_target"))))
    _same(out[0][0], out[1][0])
    _same(out[0][1], out[1][1])
    assert out[0][2:] == out[1][2:]
    assert len(out[1][1][1]) == 32  # 4 classes x round(30 * 5 / 20)


def test_manager_runs_the_logical_half_on_its_shard(tmp_path):
    """A hybrid task submitted to a port manager: staged, launched, the
    logical half trained on its shard (15 of 20 clients), the device shard
    routed to the phone job and removed at the release."""
    from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo
    from test_taskmgr import make_task_json
    from test_torch_taskmgr import join, side

    path = _archive(tmp_path, "npz_holdout")
    task = make_task_json("hybrid_run", rounds=1, num_clients=20)
    td = task["target"]["data"][0]
    td.update(data_split_type=True, data_path=path)
    td["allocation"].update(logical_simulation=[15], device_simulation=[5])
    op = task["operatorflow"]["operators"][0]["logical_simulation"]
    params = json.loads(op["operator_params"])
    params["model"]["overrides"]["num_classes"] = 4
    params["model"]["input_shape"] = [6]
    params["data"] = {"real": {"n_local": 6, "scheme": "iid"}, "eval_n": 8}
    op["operator_params"] = json.dumps(params)
    task["device_simulation"]["resource_request"] = [{"name": "data_0", "devices": ["high"],
                                                      "num_request": [5]}]
    from olearning_sim_tpu_torch.phonemgr import SimulatedPhoneFarm

    class RecordingFarm(SimulatedPhoneFarm):
        """A phone farm whose device rounds take no time, recording jobs."""

        jobs = []

        def submit_task(self, task_id, rounds, operators, data):
            self.jobs.append(data)
            return super().submit_task(task_id, rounds, operators, data)

    repo = TaskTableRepo()
    phone = RecordingFarm(inventory={"user1": {"high": 5}}, speedup=1e9)
    port = side("port")
    rm = port.ResourceManager(topology=port.topology(),
                              phone_provider=lambda: {"user1": {"high": 5}})
    mgr = TaskManager(task_repo=repo, resource_manager=rm, schedule_interval=3600,
                      device="cpu", phone_client=phone)
    assert mgr.submit_task(task)
    assert mgr.schedule_once() == "hybrid_run"
    staged = mgr._device_paths[("hybrid_run", "data_0")]
    assert phone.jobs[0][0]["data_path"] == staged and os.path.isfile(staged)
    join(mgr._launcher, repo.get_item_value("hybrid_run", "job_id"))
    stored = json.loads(repo.get_item_value("hybrid_run", "task_params"))
    assert stored["target"]["data"][0]["data_path"].endswith("_logical.zip")
    assert repo.get_item_value("hybrid_run", "logical_round") == 1
    result = json.loads(repo.get_item_value("hybrid_run", "logical_result"))
    assert result["logical_result"][0]["simulation_target"]["success_num"] == [15]
    mgr.release_once()
    assert repo.get_item_value("hybrid_run", "task_status") == "SUCCEEDED"
    assert not os.path.exists(staged) and not mgr._device_paths
