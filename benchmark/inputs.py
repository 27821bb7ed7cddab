"""A cell's inputs, made from ``--seed``: the task JSON and the initial
weights, handed alike to the program and to the reference.

The task is the configuration's frozen task JSON with the traffic mix
applied (one general generator: every workload file is data):

- ``devices`` / ``nums``: the population's device classes and clients per
  class (the target's ``total_simulation`` and ``allocation``);
- ``dispatch``: whether the train operator's dispatch trace (its
  ``strategy_gradient_house``) stays on; off, every client is released;
- ``scenario``: the engine params' ``scenario`` block, or none;
- the round count is set above what any window holds, and
  ``data.synthetic.seed`` is the run's seed, so every seed draws other
  rows, labels and minibatches over the same sizes and the same
  availability (the trace seed of a task JSON is 0).

The weights: one draw of standard normals for every parameter, made on the
device by a ``torch.Generator`` seeded with the run's seed, cut into the
leaves and scaled by their kind (``reference.models``' specs): embeddings
by 0.02, matrices and kernels by 1/sqrt(fan-in), norms' scales 1, biases 0.
"""

from __future__ import annotations

import copy
import json
import math
from typing import Dict

import torch

from benchmark.reference import models

ROUNDS = 100_000


def seed_of(seed: int) -> int:
    """The run's seed as the non-negative integer every generator takes."""
    return int(seed) % (1 << 63)


def train_operator(task: dict) -> dict:
    return next(op for op in task["operatorflow"]["operators"]
                if op["logical_simulation"]["operator_code_path"] == "builtin:train")


def engine_params(task: dict) -> dict:
    return json.loads(train_operator(task)["logical_simulation"]["operator_params"])


def make_task(config: dict, workload: dict, seed: int) -> dict:
    """The configuration's task under the workload's traffic, seeded."""
    task = copy.deepcopy(config["task"])
    task["operatorflow"]["flow_setting"]["round"] = ROUNDS
    target = task["target"]["data"][0]
    nums = [int(n) for n in workload["nums"]]
    target["total_simulation"]["devices"] = list(workload["devices"])
    target["total_simulation"]["nums"] = nums
    target["total_simulation"]["dynamic_nums"] = [0] * len(nums)
    target["allocation"]["logical_simulation"] = nums
    target["allocation"]["device_simulation"] = [0] * len(nums)
    task["logical_simulation"]["computation_unit"]["devices"] = list(workload["devices"])
    task["logical_simulation"]["computation_unit"]["setting"] = [
        {"num_cpus": 1} for _ in nums]
    task["logical_simulation"]["resource_request"][0]["devices"] = list(workload["devices"])
    task["logical_simulation"]["resource_request"][0]["num_request"] = [1] * len(nums)
    op = train_operator(task)
    if not workload["dispatch"]:
        op["operation_behavior_controller"]["use_gradient_house"] = False
        op["operation_behavior_controller"]["strategy_gradient_house"] = ""
    params = json.loads(op["logical_simulation"]["operator_params"])
    params["data"]["synthetic"]["seed"] = seed_of(seed)
    params.pop("scenario", None)
    if workload.get("scenario"):
        params["scenario"] = workload["scenario"]
    op["logical_simulation"]["operator_params"] = json.dumps(params)
    return task


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial float32 parameters, drawn on ``device`` in one call."""
    spec_fn, _ = models.ARCHITECTURES[config["architecture"]["family"]]
    spec = spec_fn(config["architecture"])
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed_of(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, pos = {}, 0
    for (name, shape, init), n in zip(spec, sizes):
        leaf = flat[pos:pos + n].view(shape)
        pos += n
        if init == "normal02":
            leaf = leaf * 0.02
        elif init == "fan_in":
            leaf = leaf * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif init == "one":
            leaf = torch.ones_like(leaf)
        else:
            leaf = torch.zeros_like(leaf)
        out[name] = leaf
    return out
