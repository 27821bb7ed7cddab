"""Tiny widths of the two configurations, for runs of the harness on the
CPU: the same code path as a cell, a few clients, a few rows."""

import json

import torch

from benchmark import inputs, run
from benchmark.reference import data


def shrink(dtype=None):
    """A ``shrink(config, task)`` for :func:`run.run_cell`; ``dtype``
    ("float32") asks the program for float32 compute."""
    extra = {"dtype": dtype} if dtype else {}

    def fn(config, task):
        config = json.loads(json.dumps(config))
        arch = config["architecture"]
        p = inputs.engine_params(task)
        if arch["family"] == "distilbert":
            arch.update(dim=16, n_layers=2, n_heads=2, hidden_dim=32, vocab_size=97, max_len=8)
            p["model"]["overrides"] = {"num_classes": 2, "width": 16, "depth": 2, "heads": 2,
                                       "mlp_dim": 32, "vocab_size": 97, "max_len": 8, **extra}
            p["model"]["input_shape"] = [8]
        else:
            arch.update(stage_widths=[16, 16, 16, 32], image_size=16)
            p["model"]["overrides"] = {"num_classes": 62, "stage_features": [16, 16, 16, 32],
                                       **extra}
            p["model"]["input_shape"] = [16, 16, 1]
        p["fedcore"].update(batch_size=4, max_local_steps=2, block_clients=4)
        p["data"]["synthetic"]["n_local"] = 6
        p["data"]["eval_n"] = 32
        inputs.train_operator(task)["logical_simulation"]["operator_params"] = json.dumps(p)
        return config, task
    return fn


def tiny_cell(name, root=None, nums=None):
    """A cell of the committed benchmark (or of ``root``'s) with a smaller
    population (``nums`` per device class)."""
    cell = run.Cell(root or run.ROOT, name)
    cell.traffic = dict(cell.traffic)
    if nums is not None:
        cell.traffic["nums"] = list(nums)
    return cell


def round_images_like_the_port(monkeypatch):
    """The port stores float features in bfloat16 (``ClientDataset.to``);
    with this the reference's images are rounded alike, so that a float32
    program and the reference differ by the order of float32 sums alone."""
    real = data.blob_population

    def rounded(*args, **kwargs):
        x, y, ns = real(*args, **kwargs)
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy(), y, ns
    monkeypatch.setattr(data, "blob_population", rounded)
