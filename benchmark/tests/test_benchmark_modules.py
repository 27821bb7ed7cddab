"""What the harness and the reference load: no module whose top-level name
(the part before the first dot, compared whole) is jax, jaxlib, flax,
optax or olearning_sim_tpu; and the reference loads nothing of the port."""

import ast
import os
import subprocess
import sys

from benchmark import run

ROOT = run.ROOT
REFERENCE = os.path.join(ROOT, "benchmark", "reference")


def _tops_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.', 1)[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["olearning_sim_tpu_torch.engine", "jaxtyping",
                                  "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "olearning_sim_tpu.engine", "optax",
                                  "flax.linen", "jaxlib"]) == sorted(run.FORBIDDEN)


def test_harness_and_program_load_no_jax():
    """Every module a run loads: the harness, the readers, the reference
    and the port's task path."""
    code = ("import benchmark.run as r, benchmark.calibrate, benchmark.flops, "
            "benchmark.correct, benchmark.inputs\n"
            "import benchmark.reference.data, benchmark.reference.availability, "
            "benchmark.reference.models, benchmark.reference.fl\n"
            "import olearning_sim_tpu_torch.engine.task_bridge\n"
            "import olearning_sim_tpu_torch.telemetry\n"
            "import torch.profiler\n"
            "import glob, os\n"
            "for f in glob.glob(os.path.join(r.ROOT, 'benchmark', 'metrics', '*.py')):\n"
            "    r.load_reader(r.ROOT, os.path.basename(f)[:-3])\n")
    tops = _tops_after(code)
    assert not tops & set(run.FORBIDDEN), tops & set(run.FORBIDDEN)
    assert "olearning_sim_tpu_torch" in tops


def test_reference_loads_nothing_of_the_repo():
    tops = _tops_after("import benchmark.reference.data, benchmark.reference.availability, "
                       "benchmark.reference.models, benchmark.reference.fl")
    assert not tops & (set(run.FORBIDDEN) | {"olearning_sim_tpu_torch"})


def test_reference_sources_import_only_plain_libraries():
    allowed = {"__future__", "json", "math", "typing", "numpy", "torch"}
    for name in sorted(os.listdir(REFERENCE)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REFERENCE, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".", 1)[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".", 1)[0]}
            else:
                continue
            assert tops <= allowed, (name, tops)
