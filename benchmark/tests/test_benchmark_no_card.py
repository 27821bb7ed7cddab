"""A run that finds no card, or no program, exits with another code than 0
and prints no result."""

import os
import shutil
import subprocess
import sys

from benchmark import run


def _run(code_or_args, cwd, env_extra=None, script=True):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    cmd = ([sys.executable] + code_or_args) if script else [sys.executable, "-c", code_or_args]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _run(["benchmark/run.py", "--workload", "resnet18_fedprox.full", "--seed",
                str(2**31 + 7), "--seconds", "1", "--trace", "0"], run.ROOT,
               {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_no_program_no_result(tmp_path):
    """A directory that holds only ``BENCHMARK.json`` and the benchmark's
    files: with a card (faked here) the run still fails, for want of the
    program."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), root)
    code = ("import sys, torch\n"
            f"sys.path.insert(0, {root!r})\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "from benchmark import run\n"
            "sys.exit(run.main(['--workload', 'resnet18_fedprox.full', '--seed', '1',"
            " '--seconds', '1', '--trace', '0']))\n")
    out = _run(code, root, script=False)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "olearning_sim_tpu_torch" in out.stderr
