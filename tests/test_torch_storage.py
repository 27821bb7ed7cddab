"""The port's storage package against the JAX package's: the HTTP repo
against a local ``http.server`` thread, the S3 and MinIO repos through fake
``boto3`` and ``minio`` modules set in ``sys.modules`` (the same SDK calls,
the same bool contract), the factory's settings from keywords and from
``OLS_STORAGE_*``, ``fetch_operator_code``, the fragment queues, the
platform config's ``storage`` section, and the selection-service websocket
barrier against a ``websockets.sync.server`` fake."""

import http.server
import json
import os
import sys
import threading
import time
import types
import zipfile

import pytest

from olearning_sim_tpu import storage as jst
from olearning_sim_tpu.taskmgr import operator_flow as jflow
from olearning_sim_tpu_torch import storage as tst
from olearning_sim_tpu_torch.taskmgr import operator_flow as tflow

import torch_threads  # noqa: F401

ENV_KEYS = ("OLS_STORAGE_ENDPOINT", "OLS_STORAGE_ACCESS_KEY", "OLS_STORAGE_SECRET_KEY",
            "OLS_STORAGE_BUCKET", "OLS_STORAGE_SECURE")


@pytest.fixture
def clean_env(monkeypatch):
    """No object-store settings in the environment (another test file of
    the same worker may have exported some)."""
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


def _jax_type(kind):
    return jst.FileTransferType(kind) if isinstance(kind, int) else jst.FileTransferType[kind]


# ------------------------------------------------------------------- HTTP
class _Server:
    """``http.server`` on 127.0.0.1:0 serving one directory from a thread."""

    def __init__(self, root):
        class Quiet(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **k):
                super().__init__(*a, directory=str(root), **k)

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def served(tmp_path):
    root = tmp_path / "www"
    (root / "sub").mkdir(parents=True)
    payload = os.urandom(300_000)
    (root / "sub" / "blob.bin").write_bytes(payload)
    srv = _Server(root)
    yield srv, payload
    srv.close()


@pytest.mark.parametrize("kind", ["HTTP", 1])
def test_http_repo_downloads_the_same_bytes(served, tmp_path, kind):
    srv, payload = served
    out = {}
    for name, mod in (("jax", jst), ("port", tst)):
        repo = mod.make_file_repo(_jax_type(kind) if name == "jax" else kind)
        assert type(repo).__name__ == "HttpFileRepo"
        dest = tmp_path / name / "deep" / "blob.bin"
        ok = repo.download_file(f"{srv.url}/sub/blob.bin", str(dest))
        missing = tmp_path / name / "missing.bin"
        gone = repo.download_file(f"{srv.url}/sub/nope.bin", str(missing))
        out[name] = (ok, dest.read_bytes(), gone, missing.exists())
    assert out["port"] == out["jax"] == (True, payload, False, False)


@pytest.mark.parametrize("call", ["upload_file", "delete_file", "list_files"])
def test_http_repo_is_download_only(call):
    args = {"upload_file": ("a", "b"), "delete_file": ("a",), "list_files": ("",)}[call]
    msgs = []
    for mod in (jst, tst):
        with pytest.raises(NotImplementedError) as e:
            getattr(mod.HttpFileRepo(), call)(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_http_download_payload_consumes_through_local(tmp_path):
    """download_payload (download then delete) on the FILE repo, both
    packages: the payload is gone from the store afterwards."""
    out = []
    for name, mod in (("jax", jst), ("port", tst)):
        store = tmp_path / name / "store"
        store.mkdir(parents=True)
        (store / "p.bin").write_bytes(b"payload")
        repo = mod.LocalFileRepo(root=str(store))
        ok = repo.download_payload("p.bin", str(tmp_path / name / "got.bin"))
        out.append((ok, (tmp_path / name / "got.bin").read_bytes(), repo.exists("p.bin"),
                    repo.download_payload("p.bin", str(tmp_path / name / "again.bin"))))
    assert out[0] == out[1] == (True, b"payload", False, False)


# ------------------------------------------------------------ S3 and MinIO
class _Sdk:
    """Fake boto3 and minio modules that record every call."""

    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail
        sdk = self

        class S3Client:
            def __init__(self, **kw):
                sdk.calls.append(("boto3.client", tuple(sorted(kw.items()))))

            def _rec(self, *a, **kw):
                sdk.calls.append(a + tuple(sorted(kw.items())))
                if sdk.fail:
                    raise OSError("store down")

            def upload_file(self, local, bucket, key):
                self._rec("upload_file", os.path.basename(local), bucket, key)

            def download_file(self, bucket, key, local):
                self._rec("download_file", bucket, key, os.path.basename(local))
                with open(local, "wb") as f:
                    f.write(b"s3:" + key.encode())

            def delete_object(self, **kw):
                self._rec("delete_object", **kw)

            def get_paginator(self, name):
                sdk.calls.append(("get_paginator", name))

                class Pages:
                    def paginate(self, **kw):
                        sdk.calls.append(("paginate",) + tuple(sorted(kw.items())))
                        return [{"Contents": [{"Key": kw["Prefix"] + "a"}]}, {},
                                {"Contents": [{"Key": kw["Prefix"] + "b"}]}]

                return Pages()

        class Obj:
            def __init__(self, name):
                self.object_name = name

        class Minio:
            def __init__(self, endpoint, **kw):
                sdk.calls.append(("Minio", endpoint) + tuple(sorted(kw.items())))

            def _rec(self, *a, **kw):
                sdk.calls.append(a + tuple(sorted(kw.items())))
                if sdk.fail:
                    raise OSError("store down")

            def fput_object(self, bucket, key, local):
                self._rec("fput_object", bucket, key, os.path.basename(local))

            def fget_object(self, bucket, key, local):
                self._rec("fget_object", bucket, key, os.path.basename(local))
                with open(local, "wb") as f:
                    f.write(b"minio:" + key.encode())

            def remove_object(self, bucket, key):
                self._rec("remove_object", bucket, key)

            def list_objects(self, bucket, prefix="", recursive=False):
                self._rec("list_objects", bucket, prefix=prefix, recursive=recursive)
                return [Obj(prefix + "x"), Obj(prefix + "y")]

        self.boto3 = types.ModuleType("boto3")
        self.boto3.client = lambda service, **kw: S3Client(service=service, **kw)
        self.minio = types.ModuleType("minio")
        self.minio.Minio = Minio


def _drive(mod, kind, tmp_path, **settings):
    repo = mod.make_file_repo(kind, **settings)
    src = tmp_path / "up.bin"
    src.write_bytes(b"up")
    dest = tmp_path / mod.__name__ / "down.bin"
    dest.parent.mkdir(parents=True, exist_ok=True)
    out = [type(repo).__name__, repo.upload_file(str(src), "models/m.bin"),
           repo.download_file("models/m.bin", str(dest))]
    out.append(dest.read_bytes() if dest.exists() else None)
    out += [repo.delete_file("models/m.bin")]
    try:
        out.append(repo.list_files("models/"))
    except OSError as e:
        out.append(f"raised {e}")
    return out


SETTINGS = {"endpoint": "store:9000", "access_key": "ak", "secret_key": "sk",
            "bucket": "ols", "secure": True}


@pytest.mark.parametrize("kind", ["S3", "MINIO"])
@pytest.mark.parametrize("source", ["keywords", "environment"])
@pytest.mark.parametrize("fail", [False, True], ids=["up", "down"])
def test_object_store_repos_make_the_same_sdk_calls(kind, source, fail, tmp_path, clean_env):
    outs, calls = [], []
    for mod in (jst, tst):
        sdk = _Sdk(fail=fail)
        clean_env.setitem(sys.modules, "boto3", sdk.boto3)
        clean_env.setitem(sys.modules, "minio", sdk.minio)
        if source == "environment":
            for key, env in (("endpoint", "OLS_STORAGE_ENDPOINT"),
                             ("access_key", "OLS_STORAGE_ACCESS_KEY"),
                             ("secret_key", "OLS_STORAGE_SECRET_KEY"),
                             ("bucket", "OLS_STORAGE_BUCKET")):
                clean_env.setenv(env, SETTINGS[key])
            clean_env.setenv("OLS_STORAGE_SECURE", "1")
            settings = {}
        else:
            settings = dict(SETTINGS)
        outs.append(_drive(mod, _jax_type(kind) if mod is jst else kind, tmp_path, **settings))
        calls.append(sdk.calls)
    assert outs[0] == outs[1]
    assert calls[0] == calls[1]
    assert outs[1][0] == {"S3": "S3FileRepo", "MINIO": "MinioFileRepo"}[kind]
    if not fail:
        assert outs[1][1:4] == [True, True, outs[1][3]] and outs[1][3].endswith(b"models/m.bin")


@pytest.mark.parametrize("kind", ["S3", "MINIO", 2, 3])
def test_object_store_without_settings_raises_jax_error(kind, clean_env):
    with pytest.raises(ValueError) as want:
        jst.make_file_repo(_jax_type(kind))
    with pytest.raises(ValueError) as got:
        tst.make_file_repo(kind)
    assert str(got.value) == str(want.value)
    assert "OLS_STORAGE_ENDPOINT" in str(got.value)


@pytest.mark.parametrize("kind,module", [("S3", "boto3"), ("MINIO", "minio")])
def test_missing_sdk_raises_jax_error(kind, module, clean_env):
    clean_env.setitem(sys.modules, module, None)  # import fails
    with pytest.raises(RuntimeError) as want:
        jst.make_file_repo(_jax_type(kind), **SETTINGS)
    with pytest.raises(RuntimeError) as got:
        tst.make_file_repo(kind, **SETTINGS)
    assert str(got.value) == str(want.value)


def test_storage_settings_from_env_equal(clean_env):
    assert jst.file_repo.storage_settings_from_env() == tst.storage_settings_from_env()
    clean_env.setenv("OLS_STORAGE_ENDPOINT", "e:1")
    clean_env.setenv("OLS_STORAGE_SECURE", "1")
    assert jst.file_repo.storage_settings_from_env() == tst.storage_settings_from_env()
    assert tst.storage_settings_from_env()["secure"] is True


def test_config_storage_section_reaches_the_factory(tmp_path, clean_env):
    """A platform INI's [storage] section exports OLS_STORAGE_* as the JAX
    config does, and an S3 repo then builds from the environment alone."""
    from olearning_sim_tpu import config as jconfig
    from olearning_sim_tpu_torch import config as tconfig

    ini = tmp_path / "platform.ini"
    ini.write_text("[storage]\nendpoint = store:9000\naccess_key = ak\nsecret_key = sk\n"
                   "bucket = ols\nsecure = true\n")
    envs = []
    for mod in (jconfig, tconfig):
        for key in ENV_KEYS:
            clean_env.delenv(key, raising=False)
        mod.apply_storage_env(mod.load_config(str(ini))["storage"])
        envs.append({k: os.environ.get(k) for k in ENV_KEYS})
    assert envs[0] == envs[1]
    assert envs[1]["OLS_STORAGE_SECURE"] == "1"
    sdk = _Sdk()
    clean_env.setitem(sys.modules, "boto3", sdk.boto3)
    assert isinstance(tst.make_file_repo("S3"), tst.S3FileRepo)
    assert sdk.calls[0][1] == (("aws_access_key_id", "ak"), ("aws_secret_access_key", "sk"),
                               ("endpoint_url", "store:9000"), ("service", "s3"))


def test_retry_policy_wraps_every_transfer_type(clean_env):
    from olearning_sim_tpu_torch.resilience import RetryPolicy

    sdk = _Sdk()
    clean_env.setitem(sys.modules, "boto3", sdk.boto3)
    clean_env.setitem(sys.modules, "minio", sdk.minio)
    policy = RetryPolicy(max_attempts=2, base_delay=0.0)
    for kind in ("FILE", "HTTP", "S3", "MINIO"):
        repo = tst.make_file_repo(kind, retry_policy=policy, **SETTINGS)
        assert isinstance(repo, tst.ResilientFileRepo)
        assert type(repo.inner).__name__ == type(
            jst.make_file_repo(jst.FileTransferType[kind], **SETTINGS)).__name__


# -------------------------------------------------------- operator code
def _code_zip(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    zp = d / "op.zip"
    with zipfile.ZipFile(zp, "w") as zf:
        zf.writestr("entry.py", "print('hi')\n")
        zf.writestr("pkg/util.py", "X = 1\n")
    (d / "single.py").write_text("print(1)\n")
    return d


def _tree(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("what", ["zip", "plain", "missing"])
def test_fetch_operator_code_equal(tmp_path, what):
    out = []
    for name, mod in (("jax", jst), ("port", tst)):
        src = _code_zip(tmp_path, name)
        repo = mod.LocalFileRepo(root=str(src))
        dest = tmp_path / f"{name}_dest"
        remote = {"zip": "op.zip", "plain": "single.py", "missing": "gone.zip"}[what]
        try:
            got = mod.fetch_operator_code(repo, remote, str(dest))
            out.append((os.path.relpath(got, tmp_path).split("_", 1)[1], _tree(got)))
        except FileNotFoundError as e:
            out.append(str(e))
    assert out[0] == out[1]


# --------------------------------------------------------------- fragments
def test_fragments_serialize_equal():
    kw = dict(task_id="t", client_id="c7", round_idx=3, payload=[0.5, -1.0],
              metrics={"train_tp_fragment": 0.91, "loss": 2})
    j, t = jst.Fragment(**kw), tst.Fragment(**kw)
    assert t.serialize() == j.serialize()
    back = tst.Fragment.deserialize(j.serialize())
    assert back == tst.Fragment(**dict(kw, metrics={"train_tp_fragment": 0.91, "loss": 2.0}))
    assert jst.Fragment.deserialize(t.serialize()).serialize() == back.serialize()


def _queue_run(mod):
    q = mod.JsonFragmentRepo()
    for i in range(5):
        q.put_serialized(mod.Fragment("t", f"c{i}", i, metrics={"m": i}).serialize())
    first = q.get_fragment(timeout=0)
    two = q.drain(max_items=2)
    rest = q.drain()
    return [f.serialize() for f in [first] + two + rest] + [q.get_fragment(timeout=0)]


def test_fragment_queues_equal():
    assert _queue_run(jst) == _queue_run(tst)


def test_resilient_fragment_repo_retries_port_faults():
    from olearning_sim_tpu_torch.resilience import RetryPolicy
    from olearning_sim_tpu_torch.resilience import faults as tfaults

    policy = RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0, sleep=lambda _s: None)
    repo = tst.ResilientFragmentRepo(tst.QueueFragmentRepo(), retry_policy=policy)
    plan = {"seed": 0, "specs": [{"point": "fragment.put", "times": 2}]}
    with tfaults.chaos(tfaults.FaultPlan.from_dict(plan)):
        repo.put_fragment(tst.Fragment("t", "c0", 0))
    assert repo.get_fragment(timeout=0).client_id == "c0"
    plan = {"seed": 0, "specs": [{"point": "fragment.get", "times": 3}]}
    with tfaults.chaos(tfaults.FaultPlan.from_dict(plan)):
        with pytest.raises(Exception):
            repo.get_fragment(timeout=0)


# ------------------------------------------------- the websocket barrier
class _RoundService:
    """Selection-service stand-in (tests/test_outbound.py's): answers every
    query with the current round index."""

    def __init__(self):
        from websockets.sync.server import serve

        self.round_idx = 0
        self.queries = []
        self._server = serve(self._handler, "127.0.0.1", 0)
        self.url = f"ws://127.0.0.1:{self._server.socket.getsockname()[1]}"
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def _handler(self, ws):
        try:
            for frame in ws:
                self.queries.append(json.loads(frame))
                ws.send(json.dumps({"round_idx": self.round_idx}))
        except Exception:
            pass

    def close(self):
        self._server.shutdown()


def _barrier_run(mod, srv):
    srv.round_idx, srv.queries = 0, []
    provider = mod.WebsocketRoundProvider(srv.url, query={"task": "t1"})
    seen = [provider()]
    srv.round_idx = 7
    seen.append(provider())
    provider.close()
    flow = mod.OperatorFlowController(
        "t1", rounds=3,
        start_params={"strategy": "waiting_for_global_aggregation",
                      "wait_interval": 0.02, "total_timeout": 5},
        stop_params={"strategy": "waiting_for_global_aggregation",
                     "wait_interval": 0.02, "total_timeout": 5},
        strategy_kwargs={"selection_url": srv.url, "selection_query": {"q": 1}})
    seen += [flow.start(), flow.current_round]
    waited = {}

    def advance():
        time.sleep(0.2)
        srv.round_idx = 8
        waited["t"] = True

    threading.Thread(target=advance).start()
    seen += [flow.stop(), flow.current_round, "t" in waited]
    return seen, srv.queries[:3]


def test_websocket_provider_and_barrier_equal_jax():
    pytest.importorskip("websockets")
    srv = _RoundService()
    try:
        jout = _barrier_run(jflow, srv)
        tout = _barrier_run(tflow, srv)
    finally:
        srv.close()
    assert tout == jout
    assert tout[0] == [0, 7, True, 7, True, 8, True]
    assert tout[1] == [{"task": "t1"}, {"task": "t1"}, {"q": 1}]


def test_websocket_provider_unreachable_returns_none():
    for mod in (jflow, tflow):
        assert mod.WebsocketRoundProvider("ws://127.0.0.1:1/never", timeout=0.2)() is None


def test_websocket_missing_package_fails_at_build(monkeypatch):
    """Kept on purpose: without websocket-client the port's barrier fails
    when built, naming the package; the JAX provider polls to its
    timeout."""
    monkeypatch.setitem(sys.modules, "websocket", None)
    kw = {"selection_url": "ws://127.0.0.1:1/never"}
    ctx = {"wait_interval": 0.01, "total_timeout": 0.05}
    assert jflow._polling_barrier(**kw).start(ctx) == (False, None)
    with pytest.raises(ImportError, match="websocket-client"):
        tflow._polling_barrier(**kw)
    with pytest.raises(ImportError, match="websocket-client"):
        tflow.require_websocket_client()
