"""A later change adds a configuration, a cell and a per-layer metric as
new files (and entries in ``BENCHMARK.json``) and edits no file of the
benchmark: the harness finds each by its name."""

import hashlib
import json
import os
import shutil

import torch

from benchmark import run
from tinycells import shrink

NEW_METRIC = '''"""Rounds the traced stretch held."""


def read(ctx):
    return float(ctx.traced_rounds) if ctx.traced_rounds else None
'''


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), root)
    before = _digests(root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    old = json.loads(json.dumps(bench))

    # A configuration: ResNet-18 at blocks of 32 clients.
    with open(os.path.join(root, "benchmark", "configs", "resnet18_fedprox.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "resnet18_fedprox_b32"
    with open(os.path.join(root, "benchmark", "configs", "resnet18_fedprox_b32.json"), "w") as f:
        json.dump(cfg, f)
    # A cell: half the population, under the task's dispatch trace.
    traffic = {"config": "resnet18_fedprox_b32", "devices": ["high", "low"], "nums": [4, 4],
               "dispatch": True, "scenario": None, "trace_rounds": 1,
               "window_rounds": 2}
    with open(os.path.join(root, "benchmark", "workloads", "resnet18_fedprox_b32.dispatch.json"),
              "w") as f:
        json.dump(traffic, f)
    # A per-layer metric.
    with open(os.path.join(root, "benchmark", "metrics", "round.traced.py"), "w") as f:
        f.write(NEW_METRIC)
    bench["configs"].append({"name": "resnet18_fedprox_b32", "source": cfg["source"],
                             "file": "benchmark/configs/resnet18_fedprox_b32.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "resnet18_fedprox_b32.dispatch",
                               "config": "resnet18_fedprox_b32", "traffic": "dispatch",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "round.traced", "unit": "rounds", "better": "higher",
                               "source": "program_counter", "layer": "round (engine/fedcore.py)",
                               "moves": "device_rounds_per_s",
                               "workloads": ["resnet18_fedprox_b32.dispatch"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    after = _digests(root)
    assert all(after[k] == v for k, v in before.items()), "an existing file was edited"
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert bench[key][:len(old[key])] == old[key]

    cell = run.Cell(root, "resnet18_fedprox_b32.dispatch")
    assert cell.config["name"] == "resnet18_fedprox_b32"
    assert cell.traffic["dispatch"] is True
    assert [m["name"] for m in cell.per_layer()] == ["round.traced"]
    res = run.run_cell(root, cell, 4, 0.0, True, torch.device("cpu"), shrink=shrink())
    assert res["metrics"]["round.traced"]["value"] == 1.0
    assert res["checks"]["trained_mismatch"]["value"] == 0
