"""The port's platform entry point against the JAX package's
(``tests/test_config.py``, its cases that need no gRPC): both packages'
``load_config`` give equal dicts on the same YAML and INI, the storage
section and the ``OLS_SQLITE_PATH`` / ``OLS_INTAKE_QUEUE_PATH`` overrides
act alike, ``build_session`` builds the same services with the same
intervals, and ``python -m olearning_sim_tpu_torch --config x.ini --device
cpu`` boots in process (``address = none``), runs a task pushed onto its
intake queue to SUCCEEDED and exits 0 on SIGTERM. What the port refuses: a
YAML file without PyYAML (named), and the CPU unless asked for. The wire
(``--print-port``, a ``grpc`` outbound, the servicers) is held against the
JAX package's in ``tests/test_torch_grpc.py`` and
``tests/test_torch_grpc_session.py``."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

import torch_threads  # noqa: F401
from test_taskmgr import make_task_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

YAML_DOC = """
session:
  services: [taskmgr, resourcemgr, deviceflow, phonemgr, slicemgr, performancemgr]
  address: "127.0.0.1:0"
taskmgr:
  schedule_interval: 0.05
  release_interval: 0.1
  interrupt_interval: 5
  interrupt_queue_time: 120
  interrupt_running_time: 600
  scheduler_strategy: fifo
repos:
  sqlite_path: "{sqlite}"
deviceflow:
  poll_interval: 0.01
phonemgr:
  inventory:
    user1: {{high: 3, low: 5}}
  failure_rate: 0.0
  speedup: 2.5
"""

CONF_DOC = """
[session]
services = taskmgr, resourcemgr, deviceflow
address = 127.0.0.1:0

[taskmgr]
scheduler_sleep_time = 0.25
release_sleep_time = 0.5
interrupt_sleep_time = 60
interrupt_queue_time = 3600
interrupt_running_time = 172800

[deviceflow]
poll_interval = 0.02
use_flag = true
name = relay
"""


def config_modules():
    from olearning_sim_tpu import config as jconfig

    from olearning_sim_tpu_torch import config as tconfig

    return jconfig, tconfig


def describe(session):
    """What a session was built with, in either package."""
    tm = session.task_manager
    out = {"services": session.services, "address": session.address,
           "max_workers": session._max_workers,
           "managers": {k: getattr(session, k) is not None
                        for k in ("task_manager", "resource_manager", "deviceflow",
                                  "phone_farm", "cluster_manager", "performance_manager",
                                  "supervisor")}}
    if tm is not None:
        out["taskmgr"] = {k: getattr(tm, k) for k in (
            "_schedule_interval", "_release_interval", "_interrupt_interval",
            "_interrupt_queue_time", "_interrupt_running_time", "_supervise_orphans",
            "lease_ttl")}
        out["taskmgr"]["strategy"] = type(tm._strategy).__name__
        out["taskmgr"]["intake"] = tm._intake_queue is not None
        out["taskmgr"]["wired"] = (tm._deviceflow is session.deviceflow,
                                   tm._resource_manager is session.resource_manager,
                                   tm._perf is session.performance_manager,
                                   tm._phone_client is session.phone_farm)
    if session.deviceflow is not None:
        out["deviceflow"] = (session.deviceflow.poll_interval, session.deviceflow.seed,
                             session.deviceflow.durable)
    if session.phone_farm is not None:
        pf = session.phone_farm
        out["phonemgr"] = (pf.inventory, pf.speedup, pf.failure_rate, pf.seed)
    if session.supervisor is not None:
        out["supervisor"] = (session.supervisor.resume_budget, session.supervisor.lease_ttl,
                             session.supervisor.scan_interval)
    return out


# ---------------------------------------------------------------- parsing
def test_load_yaml_equals_jax(tmp_path):
    jconfig, tconfig = config_modules()
    p = tmp_path / "platform.yaml"
    p.write_text(YAML_DOC.format(sqlite=tmp_path / "state.db"))
    cfg = tconfig.load_config(str(p))
    assert cfg == jconfig.load_config(str(p))
    assert cfg["taskmgr"]["schedule_interval"] == 0.05


def test_load_reference_conf_aliases_equals_jax(tmp_path):
    jconfig, tconfig = config_modules()
    p = tmp_path / "config.conf"
    p.write_text(CONF_DOC)
    cfg = tconfig.load_config(str(p))
    assert cfg == jconfig.load_config(str(p))
    assert cfg["taskmgr"]["schedule_interval"] == 0.25
    assert cfg["session"]["services"] == ["taskmgr", "resourcemgr", "deviceflow"]
    assert cfg["deviceflow"]["use_flag"] is True
    with pytest.raises(FileNotFoundError):
        tconfig.load_config(str(tmp_path / "missing.ini"))


def test_yaml_without_pyyaml_names_it(tmp_path, monkeypatch):
    _, tconfig = config_modules()
    p = tmp_path / "platform.yaml"
    p.write_text("session: {services: [performancemgr]}\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        tconfig.load_config(str(p))


# ----------------------------------------------------------------- build
@pytest.mark.parametrize("doc", ["yaml", "conf"])
def test_build_session_same_services_and_intervals(tmp_path, doc):
    jconfig, tconfig = config_modules()
    if doc == "yaml":
        p = tmp_path / "platform.yaml"
        p.write_text(YAML_DOC.format(sqlite=tmp_path / "state.db"))
    else:
        p = tmp_path / "config.conf"
        p.write_text(CONF_DOC)
    cfg = tconfig.load_config(str(p))
    jax_session = jconfig.build_session(jconfig.load_config(str(p)))
    port_session = tconfig.build_session(cfg, device="cpu")
    assert describe(port_session) == describe(jax_session)
    assert port_session.device.type == "cpu"
    with port_session:
        assert port_session.task_manager._threads and port_session.deviceflow._threads
    assert not port_session.task_manager._threads and not port_session.deviceflow._threads
    if doc == "yaml":
        assert os.path.exists(tmp_path / "state.db")
        assert port_session.cluster_manager.devices[0].type == "cpu"


def test_storage_section_feeds_env_equals_jax(tmp_path, monkeypatch):
    jconfig, tconfig = config_modules()
    keys = [k for k in os.environ if k.startswith("OLS_STORAGE_")]
    p = tmp_path / "platform.ini"
    p.write_text("[session]\nservices = performancemgr\n\n[storage]\nendpoint = minio:9000\n"
                 "access_key = ak\nsecret_key = sk\nbucket = ols\nsecure = false\n")
    envs = []
    for config in (jconfig, tconfig):
        for k in keys + ["OLS_STORAGE_ENDPOINT", "OLS_STORAGE_ACCESS_KEY",
                         "OLS_STORAGE_SECRET_KEY", "OLS_STORAGE_BUCKET", "OLS_STORAGE_SECURE"]:
            monkeypatch.delenv(k, raising=False)
        session = config.session_from_file(str(p)) if config is jconfig else \
            config.session_from_file(str(p), device="cpu")
        assert session.performance_manager is not None and session.task_manager is None
        envs.append({k: v for k, v in os.environ.items() if k.startswith("OLS_STORAGE_")})
    assert envs[1] == envs[0]
    assert envs[1]["OLS_STORAGE_ENDPOINT"] == "minio:9000"
    assert envs[1]["OLS_STORAGE_SECURE"] == "0"


def test_env_overrides_sqlite_and_intake_equal_jax(tmp_path, monkeypatch):
    jconfig, tconfig = config_modules()
    out = []
    for name, config in (("jax", jconfig), ("port", tconfig)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.setenv("OLS_SQLITE_PATH", str(d / "env_state.db"))
        monkeypatch.setenv("OLS_INTAKE_QUEUE_PATH", str(d / "intake.db"))
        cfg = {"session": {"services": ["taskmgr", "deviceflow"], "address": "127.0.0.1:0"},
               "repos": {"sqlite_path": str(d / "cfg_state.db")}}
        session = config.build_session(cfg) if name == "jax" else \
            config.build_session(cfg, device="cpu")
        out.append((sorted(p.name for p in d.iterdir() if p.suffix == ".db"),
                    session.task_manager._intake_queue is not None, describe(session)))
    assert out[1] == out[0]
    assert out[1][0] == ["env_state.db", "intake.db"]


# ----------------------------------------------------------------- session
def test_session_defaults_to_the_card(tmp_path):
    import torch

    from olearning_sim_tpu_torch.services import ALL_SERVICES, SimulatorSession

    _, tconfig = config_modules()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SimulatorSession()
        with pytest.raises(RuntimeError, match="cuda"):
            tconfig.build_session({"session": {"services": ["taskmgr"]}})
    session = SimulatorSession(device="cpu")
    assert session.services == ALL_SERVICES
    assert session.task_manager._device.type == "cpu"
    assert session.resource_manager.topology.platform == "cpu"
    assert session.supervisor is not None and session.task_manager._supervise_orphans


def test_session_serves_metrics_and_stops_every_thread():
    from olearning_sim_tpu_torch.services import SimulatorSession

    session = SimulatorSession(services=("taskmgr", "deviceflow", "performancemgr"),
                               metrics_port=0, device="cpu")
    with session:
        port = session.metrics_server.port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            assert r.status == 200
        assert session.supervisor._thread is not None
    assert session.metrics_server is None
    assert not session.task_manager._threads and not session.deviceflow._threads


# ------------------------------------------------------------ entry point
def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_main_runs_an_intake_task_and_exits_on_sigterm(tmp_path):
    """The entry point boots from an INI file, runs a task pushed onto its
    intake queue to SUCCEEDED, and exits 0 on SIGTERM."""
    from olearning_sim_tpu_torch.taskmgr.queue_repo import SqliteQueueRepo
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo

    db, intake = tmp_path / "state.db", tmp_path / "intake.db"
    p = tmp_path / "platform.ini"
    p.write_text(
        "[session]\nservices = taskmgr, resourcemgr, deviceflow, phonemgr, slicemgr, "
        "performancemgr\naddress = none\n\n[taskmgr]\nscheduler_sleep_time = 0.05\n"
        f"release_sleep_time = 0.05\n\n[repos]\nsqlite_path = {db}\n"
        f"intake_queue_path = {intake}\n\n[deviceflow]\npoll_interval = 0.01\n")
    task = make_task_json("intake_task", rounds=2, cpus=1, request_units=1)
    strategy = {"flow_dispatch": {"use_strategy": True, "total_dispatch_amount": 20,
                                  "specific_timing": {"use": True, "time_type": "relative",
                                                      "timings": [0], "amounts": [20]}}}
    task["operatorflow"]["operators"][0]["operation_behavior_controller"].update(
        use_gradient_house=True, strategy_gradient_house=json.dumps(strategy))
    log_path = tmp_path / "platform.log"
    log = open(log_path, "w")  # a pipe nobody drains could stall the child
    proc = subprocess.Popen([sys.executable, "-m", "olearning_sim_tpu_torch", "--config",
                             str(p), "--device", "cpu"], cwd=REPO, env=_env(),
                            stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while "platform running in process (no port) on cpu" not in log_path.read_text():
            assert proc.poll() is None and time.monotonic() < deadline, log_path.read_text()
            time.sleep(0.05)
        SqliteQueueRepo(str(intake)).push(json.dumps(task))
        repo = TaskTableRepo(sqlite_path=str(db))
        deadline, row = time.monotonic() + 90, None
        while time.monotonic() < deadline:
            row = {r["task_id"]: r for r in repo.query_all()}.get("intake_task")
            if row is not None and row["task_status"] in ("SUCCEEDED", "FAILED") \
                    and str(row["resource_occupied"]) == "0":
                break
            time.sleep(0.1)
        assert row is not None and row["task_status"] == "SUCCEEDED", row
        assert int(row["logical_round"]) == 2
        result = json.loads(row["logical_result"])["logical_result"][0]
        assert result["simulation_target"]["success_num"] == [24]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        finally:
            log.close()
    assert rc == 0, log_path.read_text()
