"""Package rules of the PyTorch port: it imports no JAX (nor anything of the
JAX package), builds no kernel and imports no triton when imported, and its
GPU smoke script refuses to run without a card."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "olearning_sim_tpu_torch"
FORBIDDEN = re.compile(r"import (jax|flax|optax)|from (jax|flax|optax)|olearning_sim_tpu[^_]")


def _run(code, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    proc = _run(
        "import sys\n"
        "import olearning_sim_tpu_torch.engine, olearning_sim_tpu_torch.weights\n"
        "import olearning_sim_tpu_torch.models.transformer, chip_smoke\n"
        "import olearning_sim_tpu_torch.models.mlp, olearning_sim_tpu_torch.models.cnn\n"
        "from olearning_sim_tpu_torch.engine import (ControlState, PersonalState,\n"
        "    make_synthetic_dataset, make_synthetic_texture_dataset, from_config,\n"
        "    parse_float_dtype, Yogi, Adagrad)\n"
        "from olearning_sim_tpu_torch.models import get_model\n"
        "for name in ('mlp2', 'cnn4', 'cnn4_pool', 'distilbert'):\n"
        "    get_model(name)\n"
        "import olearning_sim_tpu_torch.parallel.mesh\n"
        "import olearning_sim_tpu_torch.parallel.ring_attention\n"
        "import olearning_sim_tpu_torch.parallel.long_context\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'optax', 'olearning_sim_tpu', 'triton'))\n"
        "print(bad)\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


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
