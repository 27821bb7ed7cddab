"""Deployment configuration: boot a fully-wired platform from one file.

The reference wires services from INI ``config/config.conf`` (gRPC
endpoints + taskMgr timer intervals, ``config.conf:1-45``) plus per-concern
YAMLs (object-store credentials ``manager_config.yaml``, deviceflow
endpoints ``deviceflow_config.yaml``, MySQL table configs). The rebuild
folds those concerns into ONE document (YAML, or INI with the reference's
timer spellings) consumed by :func:`build_session`::

    session:
      services: [taskmgr, resourcemgr, deviceflow, phonemgr, slicemgr, performancemgr]
      address: "0.0.0.0:50051"      # gRPC; null or none -> in process
    taskmgr:
      schedule_interval: 5          # config.conf scheduler_sleep_time
      release_interval: 10          # config.conf release_sleep_time
      interrupt_interval: 300       # config.conf interrupt_sleep_time
      interrupt_queue_time: 3600
      interrupt_running_time: 172800
      scheduler_strategy: default
    repos:
      sqlite_path: /var/lib/ols/state.db   # omit -> in-memory
      intake_queue_path: /var/lib/ols/intake.db   # task JSON FIFO
    storage:                        # object store (manager_config.yaml role)
      endpoint: "minio:9000"
      access_key: ...
      secret_key: ...
      bucket: ols
    deviceflow:
      poll_interval: 0.05
      outbound: {type: websocket, url: "ws://aggregator:8765"}
    phonemgr:
      inventory: {user1: {high: 4, low: 8}}
      speedup: 1.0
      failure_rate: 0.0

Entry point: ``python -m olearning_sim_tpu_torch --config platform.ini``.

A copy of the JAX package's ``config.py``: the same parser, the same
environment overrides (``OLS_SQLITE_PATH``, ``OLS_INTAKE_QUEUE_PATH``, the
``OLS_STORAGE_*`` exports) and the same wiring, building the port's
:class:`~olearning_sim_tpu_torch.services.session.SimulatorSession`.
``session.address`` (default ``"127.0.0.1:0"``, as JAX's) is where it
serves gRPC with ``session.max_workers`` threads (default 16); a null or
``none`` address runs it in process, serving nothing. YAML needs PyYAML,
imported only when a ``.yaml`` file is read; INI needs only
``configparser``.
"""

from __future__ import annotations

import configparser
import os
from typing import Any, Dict, Optional

# INI key aliases: the reference config.conf timer spellings -> ours.
_CONF_ALIASES = {
    "scheduler_sleep_time": "schedule_interval",
    "release_sleep_time": "release_interval",
    "interrupt_sleep_time": "interrupt_interval",
    "interrupt_queue_time": "interrupt_queue_time",
    "interrupt_running_time": "interrupt_running_time",
}


def load_config(path: str) -> Dict[str, Any]:
    """Parse a platform config file (YAML by extension, else INI)."""
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"{path}: reading a YAML config needs PyYAML (import yaml "
                f"failed: {e}); install it or write the config as INI"
            ) from e

        with open(path, encoding="utf-8") as f:
            cfg = yaml.safe_load(f) or {}
        if not isinstance(cfg, dict):
            raise ValueError(f"{path}: top level must be a mapping")
        return cfg
    parser = configparser.ConfigParser()
    if not parser.read(path, encoding="utf-8"):
        raise FileNotFoundError(path)
    cfg: Dict[str, Any] = {}
    for section in parser.sections():
        out: Dict[str, Any] = {}
        for key, value in parser.items(section):
            key = _CONF_ALIASES.get(key, key)
            for cast in (int, float):
                try:
                    value = cast(value)
                    break
                except ValueError:
                    continue
            if value in ("true", "True"):
                value = True
            elif value in ("false", "False"):
                value = False
            out[key] = value
        cfg[section.lower()] = out
    if "session" in cfg and isinstance(cfg["session"].get("services"), str):
        cfg["session"]["services"] = [
            s.strip() for s in cfg["session"]["services"].split(",") if s.strip()
        ]
    return cfg


def apply_storage_env(storage: Dict[str, Any]) -> None:
    """Export object-store settings where ``storage_settings_from_env``
    finds them (single source of truth for every FileRepo construction)."""
    mapping = {
        "endpoint": "OLS_STORAGE_ENDPOINT",
        "access_key": "OLS_STORAGE_ACCESS_KEY",
        "secret_key": "OLS_STORAGE_SECRET_KEY",
        "bucket": "OLS_STORAGE_BUCKET",
    }
    for key, env in mapping.items():
        if storage.get(key):
            os.environ[env] = str(storage[key])
    if "secure" in storage:
        os.environ["OLS_STORAGE_SECURE"] = "1" if storage["secure"] else "0"


def build_session(cfg: Dict[str, Any], device="cuda"):
    """Construct a fully-wired :class:`SimulatorSession` from a parsed
    config (not started — call ``.start()`` / use as a context manager).
    ``device`` — where the session runs (``"cuda"`` unless the caller
    asks for the CPU)."""
    from olearning_sim_tpu_torch.services.session import ALL_SERVICES, SimulatorSession

    session_cfg = dict(cfg.get("session", {}))
    services = tuple(session_cfg.get("services", ALL_SERVICES))
    address = session_cfg.get("address", "127.0.0.1:0")
    if address is None or str(address).strip().lower() in ("none", "null"):
        address = None

    repos = cfg.get("repos", {})
    # OLS_SQLITE_PATH overrides the config file's path so one shared config
    # can be mounted read-only while the deployment points state at its own
    # volume (deploy/k8s/platform.yaml sets it to the PVC mount).
    sqlite_path = os.environ.get("OLS_SQLITE_PATH") or repos.get("sqlite_path")

    if cfg.get("storage"):
        apply_storage_env(cfg["storage"])

    # Phone farm (reference PhoneMgr is an external service; here the
    # simulated farm boots from declared inventory).
    phone_farm = None
    pm_cfg = cfg.get("phonemgr", {})
    if "phonemgr" in services and pm_cfg.get("inventory"):
        from olearning_sim_tpu_torch.phonemgr import SimulatedPhoneFarm

        phone_farm = SimulatedPhoneFarm(
            inventory=pm_cfg["inventory"],
            speedup=float(pm_cfg.get("speedup", 1.0)),
            failure_rate=float(pm_cfg.get("failure_rate", 0.0)),
            seed=int(pm_cfg.get("seed", 0)),
        )

    deviceflow = None
    df_cfg = cfg.get("deviceflow", {})
    if "deviceflow" in services:
        from olearning_sim_tpu_torch.deviceflow.service import DeviceFlowService

        outbound_factory = None
        if df_cfg.get("outbound"):
            from olearning_sim_tpu_torch.deviceflow.outbound import make_outbound_factory

            svc_holder = []

            def fallback(flow_id, _cfg):
                def producer(batch):
                    svc_holder[0].delivered.setdefault(flow_id, []).extend(batch)

                return producer

            outbound_factory = make_outbound_factory(
                default_cfg=df_cfg["outbound"], fallback=fallback
            )
        flow_repo = registry_repo = None
        if sqlite_path:
            from olearning_sim_tpu_torch.deviceflow.flow import FLOW_COLUMNS
            from olearning_sim_tpu_torch.deviceflow.registry import REGISTRY_COLUMNS
            from olearning_sim_tpu_torch.utils.repo import SqliteTableRepo

            flow_repo = SqliteTableRepo(sqlite_path, "deviceflow_flow", FLOW_COLUMNS)
            registry_repo = SqliteTableRepo(
                sqlite_path, "deviceflow_registry", REGISTRY_COLUMNS
            )
        deviceflow = DeviceFlowService(
            flow_repo=flow_repo,
            registry_repo=registry_repo,
            outbound_factory=outbound_factory,
            poll_interval=float(df_cfg.get("poll_interval", 0.05)),
        )
        if df_cfg.get("outbound"):
            svc_holder.append(deviceflow)

    resource_manager = None
    if "resourcemgr" in services:
        from olearning_sim_tpu_torch.resourcemgr.resource_manager import (
            DeviceTopology,
            ResourceManager,
        )

        repo = None
        if sqlite_path:
            from olearning_sim_tpu_torch.resourcemgr.resource_manager import RES_COLUMNS
            from olearning_sim_tpu_torch.utils.repo import SqliteTableRepo

            repo = SqliteTableRepo(sqlite_path, "resmgr_table", RES_COLUMNS)
        resource_manager = ResourceManager(
            topology=DeviceTopology.detect(device),
            repo=repo,
            phone_provider=(
                phone_farm.get_device_available_resource if phone_farm else None
            ),
        )

    performance_manager = None
    if "performancemgr" in services:
        from olearning_sim_tpu_torch.performancemgr import PerformanceManager

        performance_manager = PerformanceManager()

    task_manager = None
    if "taskmgr" in services:
        from olearning_sim_tpu_torch.taskmgr.task_manager import TaskManager
        from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo

        tm_cfg = dict(cfg.get("taskmgr", {}))
        task_repo = TaskTableRepo(sqlite_path=sqlite_path) if sqlite_path else None
        # Alternate non-gRPC intake (reference RedisRepo path): a durable
        # sqlite FIFO any local producer can push task JSON onto.
        intake_queue = None
        intake_path = os.environ.get("OLS_INTAKE_QUEUE_PATH") or repos.get(
            "intake_queue_path"
        )
        if intake_path:
            from olearning_sim_tpu_torch.taskmgr.queue_repo import SqliteQueueRepo

            intake_queue = SqliteQueueRepo(intake_path)
        task_manager = TaskManager(
            task_repo=task_repo,
            resource_manager=resource_manager,
            deviceflow=deviceflow,
            phone_client=phone_farm,
            perf=performance_manager,
            scheduler_strategy=tm_cfg.get("scheduler_strategy", "default"),
            schedule_interval=float(tm_cfg.get("schedule_interval", 5.0)),
            release_interval=float(tm_cfg.get("release_interval", 10.0)),
            interrupt_interval=float(tm_cfg.get("interrupt_interval", 300.0)),
            interrupt_queue_time=float(tm_cfg.get("interrupt_queue_time", 3600.0)),
            interrupt_running_time=float(
                tm_cfg.get("interrupt_running_time", 172800.0)
            ),
            intake_queue=intake_queue,
            device=device,
        )

    return SimulatorSession(
        services=services,
        address=address,
        task_manager=task_manager,
        resource_manager=resource_manager,
        deviceflow=deviceflow,
        phone_farm=phone_farm,
        performance_manager=performance_manager,
        max_workers=int(session_cfg.get("max_workers", 16)),
        device=device,
    )


def session_from_file(path: str, device="cuda"):
    return build_session(load_config(path), device=device)
