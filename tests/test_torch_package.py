"""Package rules of the PyTorch port: it imports no JAX, flax, optax, orbax,
msgpack, protobuf or grpc (nor anything of the JAX package), builds no
kernel and imports no triton when imported, brings in none of its optional
clients (redis, pymysql, yaml, websocket) until they are used, and its GPU
smoke script refuses to run without a card."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import torch_threads  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "olearning_sim_tpu_torch"
FORBIDDEN = re.compile(r"import (jax|flax|optax|orbax|msgpack|grpc|google)\b|"
                       r"from (jax|flax|optax|orbax|msgpack|grpc|google)\b|"
                       r"olearning_sim_tpu[^_]")


def _run(code, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    # The interpreter's site hooks may pre-import namespace packages (a
    # ``google`` namespace here): only what the port's imports add counts.
    proc = _run(
        "import sys\n"
        "before = set(sys.modules)\n"
        "import olearning_sim_tpu_torch.engine, olearning_sim_tpu_torch.weights\n"
        "import olearning_sim_tpu_torch.models.transformer, chip_smoke\n"
        "import olearning_sim_tpu_torch.models.mlp, olearning_sim_tpu_torch.models.cnn\n"
        "import olearning_sim_tpu_torch.models.resnet, olearning_sim_tpu_torch.models.vit\n"
        "import olearning_sim_tpu_torch.models.moe\n"
        "from olearning_sim_tpu_torch.engine import (ControlState, PersonalState,\n"
        "    make_synthetic_dataset, make_synthetic_texture_dataset, from_config,\n"
        "    parse_float_dtype, Yogi, Adagrad)\n"
        "from olearning_sim_tpu_torch.models import get_model\n"
        "for name in ('mlp2', 'cnn4', 'cnn4_pool', 'distilbert', 'resnet18', 'vit_tiny',\n"
        "             'moe_text'):\n"
        "    get_model(name)\n"
        "import olearning_sim_tpu_torch.parallel.mesh\n"
        "import olearning_sim_tpu_torch.parallel.ring_attention\n"
        "import olearning_sim_tpu_torch.parallel.long_context\n"
        "import olearning_sim_tpu_torch.engine.runner, olearning_sim_tpu_torch.engine.task_bridge\n"
        "import olearning_sim_tpu_torch.utils, olearning_sim_tpu_torch.telemetry\n"
        "import olearning_sim_tpu_torch.resilience, olearning_sim_tpu_torch.deviceflow\n"
        "import olearning_sim_tpu_torch.taskmgr.codecs, olearning_sim_tpu_torch.taskmgr.task_repo\n"
        "import olearning_sim_tpu_torch.taskmgr.operator_flow\n"
        "from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig\n"
        "from olearning_sim_tpu_torch.resilience import (faults, retry, policy,\n"
        "    quarantine, events)\n"
        "from olearning_sim_tpu_torch.utils import clocks, repo, logging\n"
        "from olearning_sim_tpu_torch.telemetry import metrics, tracing\n"
        "from olearning_sim_tpu_torch.deviceflow import strategy, trace_compiler\n"
        "from olearning_sim_tpu_torch.checkpoint import checkpointer, msgpack_wire\n"
        "from olearning_sim_tpu_torch.storage import file_repo\n"
        "from olearning_sim_tpu_torch.engine import convergence, scenario, staging\n"
        "from olearning_sim_tpu_torch.engine import async_rounds\n"
        "from olearning_sim_tpu_torch.engine.runner import MultiTaskDispatcher\n"
        "from olearning_sim_tpu_torch.utils import durable\n"
        "from olearning_sim_tpu_torch.parallel import collectives\n"
        "from olearning_sim_tpu_torch.parallel.mesh import (ParallelConfig, pad_to_multiple,\n"
        "    shard_clients)\n"
        "from olearning_sim_tpu_torch.telemetry import exporters\n"
        "from olearning_sim_tpu_torch.taskmgr import (status, task_queue, queue_repo,\n"
        "    scheduler, validation, jobs, hybrid, task_manager, codecs)\n"
        "from olearning_sim_tpu_torch import resourcemgr, phonemgr, performancemgr, supervisor\n"
        "from olearning_sim_tpu_torch.resourcemgr import resource_manager\n"
        "from olearning_sim_tpu_torch.phonemgr import phone_farm\n"
        "from olearning_sim_tpu_torch.performancemgr import performance_manager, hbm_budget\n"
        "from olearning_sim_tpu_torch.supervisor import supervisor as _sup\n"
        "from olearning_sim_tpu_torch.utils.repo import SqliteTableRepo, MySqlTableRepo\n"
        "from olearning_sim_tpu_torch.deviceflow import (validate, rooms, sorter, registry,\n"
        "    flow, dispatcher, durable_rooms, outbound, service, DeviceFlowService)\n"
        "from olearning_sim_tpu_torch.taskmgr import pool\n"
        "from olearning_sim_tpu_torch.clustermgr import slice_manager, ClusterManager\n"
        "from olearning_sim_tpu_torch.clustermgr import (launcher, worker, targets, elastic,\n"
        "    ElasticWorldRunner, MultiHostLauncher, DistributedConfig)\n"
        "from olearning_sim_tpu_torch.analysis import convergence_gate\n"
        "from olearning_sim_tpu_torch.engine.convergence import run_convergence_task\n"
        "from olearning_sim_tpu_torch.services import session, SimulatorSession\n"
        "from olearning_sim_tpu_torch import config, __main__\n"
        "from olearning_sim_tpu_torch import data, operators, storage\n"
        "from olearning_sim_tpu_torch.data import formats, ingest, partition, hybrid_split\n"
        "from olearning_sim_tpu_torch.operators import base, external\n"
        "from olearning_sim_tpu_torch.storage import fragment_repo\n"
        "from olearning_sim_tpu_torch.taskmgr.operator_flow import WebsocketRoundProvider\n"
        "v = validation.validate_task_parameters(codecs.json2taskconfig(\n"
        "    open('configs/fedavg_mnist_mlp.json').read()))\n"
        "assert v == (True, 'Pass'), v\n"
        "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'optax', 'orbax', 'msgpack', 'google',\n"
        "              'olearning_sim_tpu', 'triton', 'grpc', 'redis', 'pymysql', 'yaml',\n"
        "              'websocket'))\n"
        "print(bad)\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_operators_import_leaves_torch_out():
    """An operator's subprocess imports the port's operators package
    without torch, or numpy (the package ``__init__`` imports nothing,
    the operators package only its stdlib base; ``resolve_device`` and
    ``ExternalOperator`` are reached through module ``__getattr__``s)."""
    proc = _run(
        "import sys\n"
        "import olearning_sim_tpu_torch.operators\n"
        "from olearning_sim_tpu_torch.operators import OperatorABC\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
        "assert 'numpy' not in sys.modules, 'numpy imported'\n"
        "from olearning_sim_tpu_torch.operators import ExternalOperator\n"
        "assert ExternalOperator.__name__ == 'ExternalOperator'\n"
        "import olearning_sim_tpu_torch as p\n"
        "print(p.resolve_device('cpu'))\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "cpu"


def test_port_sources_name_no_jax():
    files = [REPO / "chip_smoke.py"] + sorted(
        p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh"))
    hits = [f"{p.relative_to(REPO)}:{i}: {line.strip()}"
            for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if FORBIDDEN.search(line)]
    assert hits == []


def test_import_builds_nothing():
    from olearning_sim_tpu_torch.ops import _build

    assert _build.build_logs == {}
    src, lib = _build.library_path("flash_attention.cu")
    assert src.exists() and lib.name.startswith("libflash_attention-")


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
