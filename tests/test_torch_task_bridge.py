"""The port's task bridge: every input form builds the same runner, every
configs/*.json builds and runs one tiny round on the CPU (cut by editing
the loaded JSON only; the mp-2 config on two gloo ranks, and refused at a
world of one as JAX's mesh refuses one device), an unknown engine-params
block is refused, a selection_url, a dataPath, external operator code and
every model transfer type do what the JAX bridge does with them, the
checkpoint and model blocks build and run, the JAX control plane drives a
port runner through its runner_factory, and the repaired
FedCoreConfig.from_dict agrees with the JAX package's."""

import json
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from olearning_sim_tpu_torch.engine import fedcore as tfc
from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig, cost_family
from olearning_sim_tpu_torch.taskmgr.codecs import json2taskconfig
from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo

import torch_threads  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
SUPPORTED = ["fedavg_mnist_mlp", "fedavg_cifar10_cnn", "scaffold_mnist_mlp",
             "fedadam_sent140_distilbert", "fedavg_mnist_mlp_convergence",
             "fedavg_mnist_mlp_deadline", "fedavg_mnist_mlp_defense",
             "fedprox_femnist_resnet18", "ditto_cifar100_vit", "fedavg_mnist_mlp_trace",
             "fedavg_mnist_mlp_async", "fedavg_mnist_mlp_bf16",
             "fedadam_sent140_distilbert_mp2"]
# Configs the bridge refuses at a world of one, as JAX's make_mesh_plan
# refuses them over one device: the mp-2 config needs two ranks.
REFUSED = {"fedadam_sent140_distilbert_mp2": {"mp": 2}}
# Narrow widths per family for the CPU (the configs' own shapes otherwise).
SHRINK = {
    "mlp2": ({"hidden": [16]}, None),
    "cnn4": ({"features": [4, 8]}, [8, 8, 3]),
    "distilbert": ({"depth": 1, "width": 16, "heads": 2, "mlp_dim": 32,
                    "vocab_size": 97, "max_len": 8}, [8]),
    "resnet18": ({"stage_features": [8, 8, 16, 16], "blocks_per_stage": [1, 1, 1, 1],
                  "groups": 4}, None),
    "vit_tiny": ({"width": 16, "depth": 2, "heads": 2, "mlp_dim": 32}, None),
}


def load(name):
    return json.loads((REPO / "configs" / f"{name}.json").read_text())


def engine_params(task):
    return json.loads(task["operatorflow"]["operators"][0]["logical_simulation"]
                      ["operator_params"])


def set_engine_params(task, params):
    task["operatorflow"]["operators"][0]["logical_simulation"]["operator_params"] = \
        json.dumps(params)
    return task


def shrink(task, clients=8, rounds=1):
    """The config cut to a CPU-sized task: clients, rounds, local work and
    the model's widths, all by editing the loaded JSON. A deadline's target
    cohort shrinks with the clients, a stream block to two blocks of
    clients."""
    params = engine_params(task)
    deadline = params.get("deadline") or {}
    if deadline.get("target_cohort"):
        total = sum(sum(td["total_simulation"]["nums"]) for td in task["target"]["data"])
        deadline["target_cohort"] = max(1, deadline["target_cohort"] * clients // total)
    if (params.get("scenario") or {}).get("stream_block_rows"):
        params["scenario"]["stream_block_rows"] = 8
    overrides, shape = SHRINK[params["model"]["name"]]
    params["model"]["overrides"].update(overrides)
    if shape:
        params["model"]["input_shape"] = shape
    params["fedcore"].update(batch_size=4, max_local_steps=2, block_clients=4)
    params["data"]["synthetic"]["n_local"] = 6
    params["data"]["eval_n"] = 32
    for td in task["target"]["data"]:
        per = [clients // len(td["total_simulation"]["nums"])] * len(td["total_simulation"]["nums"])
        td["total_simulation"]["nums"] = per
        td["allocation"]["logical_simulation"] = per
    task["operatorflow"]["flow_setting"]["round"] = rounds
    return set_engine_params(task, params)


def _mp2_tiny_round(task, tmp_path):
    """The mp-2 config on two gloo ranks (tests/test_torch_tp.py's job):
    both ranks keep the same history and params."""
    from test_torch_dp import run_ranks

    ranks = run_ranks("test_torch_tp", "_bridge_job", 2, {"task": np.array(json.dumps(task))},
                      tmp_path)
    for r in ranks:
        assert r["plan"].tolist() == [1, 2]  # dp 1 x mp 2
        assert str(r["history"]) == str(ranks[0]["history"])
        assert all(np.array_equal(r[k], ranks[0][k]) for k in ranks[0] if k.startswith("p/"))
    assert int(ranks[0]["logical_round"]) == 1
    return json.loads(str(ranks[0]["history"]))


@pytest.mark.parametrize("name", SUPPORTED)
def test_supported_config_runs_a_tiny_round(name, tmp_path):
    task = shrink(load(name))
    if name == "fedadam_sent140_distilbert_mp2":
        history = _mp2_tiny_round(task, tmp_path)
        rec = history[0]["train"]["data_0"]
        assert np.isfinite(rec["mean_loss"]) and rec["clients_trained"] > 0
        assert np.isfinite(history[0]["evaluate"]["data_0"]["eval_loss"])
        return
    repo = TaskTableRepo()
    runner = build_runner_from_taskconfig(task, task_repo=repo, device="cpu")
    history = runner.run()
    rec = history[0]["train"]["data_0"]
    assert np.isfinite(rec["mean_loss"]) and rec["clients_trained"] > 0
    assert np.isfinite(history[0]["evaluate"]["data_0"]["eval_loss"])
    assert repo.get_item_value(task["task_id"], "logical_round") == 1
    if name == "fedadam_sent140_distilbert":
        assert runner.operators[0].use_deviceflow  # its flow_dispatch strategy is live
        assert rec["released"] + rec["dropped"] <= 8
    if name == "scaffold_mnist_mlp":
        assert "data_0" in runner.control_states
    if name == "fedavg_mnist_mlp_convergence":
        record = runner.convergence_record()
        assert record["target_accuracy"] == 0.9 and record["rounds_observed"] == 1
        assert [e["round"] for e in record["evals"]] == [0]  # the final round
    if name == "fedavg_mnist_mlp_deadline":
        # 8 clients, target cohort 4 with over-selection 0.25: 5 selected.
        assert rec["selected"] == 5 and rec["on_time"] >= 2
        assert runner.deadline.adaptive and history[0]["pacing"]["ema"] is not None
    if name == "fedavg_mnist_mlp_defense":
        assert rec["clients_trained"] == 6  # the preseeded clients 1 and 3 sit out
        assert rec["clipped"] == 0 and "flagged" in rec
        assert runner.defense.aggregator == "trimmed_mean"
    if name == "ditto_cifar100_vit":
        personal = runner.personal_states["data_0"].params
        assert all(v.dtype == torch.bfloat16 and v.shape[0] == 8 for v in personal.values())
        # Two clients per class at 8, 5 and 2 steps, padding in class 0.
        assert runner.populations[0].num_steps.tolist() == [8, 8, 5, 5, 2, 2, 8, 8]
    if name == "fedavg_mnist_mlp_trace":
        # Streamed from the host store in one block of 8; the scenario's
        # counts ride the record.
        assert runner.populations[0].store is not None
        assert isinstance(runner.populations[0].dataset.x, np.ndarray)
        assert rec["stream"]["blocks"] == 1 and rec["stream"]["rows"] == 8
        assert rec["scenario"]["available"] == rec["released"]
    if name == "fedavg_mnist_mlp_async":
        # 8 clients in buffers of 25: one window, committed.
        assert runner.async_config.buffer_size == 25 and runner.async_config.max_staleness == 8
        assert rec["windows"] == 1 and rec["commits"] == 1 and rec["committed"] == 8
        assert history[0]["async_clock"] == 1
    if name == "fedavg_mnist_mlp_bf16":
        assert runner.core.config.shard_server_update
        assert runner.core.config.carry_dtype == torch.bfloat16


# The larger families' configs against the JAX runner (bf16 compute, as
# the configs ask): the host side exactly, the global params by how far
# one round moved them from the same start, relative L2 against JAX's move
# (tests/test_torch_resnet.py and tests/test_torch_vit.py hold the rounds
# in f32 tightly and measure bf16's noise). Measured here: 0.102 (resnet18,
# whose bf16 gradients are 5-13% from f32 ones) and 0.0127 (vit_tiny); a
# port with GroupNorm's statistics in bf16 reads 0.189 (resnet18), one
# with LayerNorm's in bf16 0.0240 (vit_tiny). Each limit lies between.
LARGE_MOVED_RTOL = {"fedprox_femnist_resnet18": 0.14, "ditto_cifar100_vit": 0.018}


@pytest.mark.parametrize("name", sorted(LARGE_MOVED_RTOL))
def test_large_family_config_matches_jax_runner(name):
    from test_torch_runner import _run_jax, _run_port
    from test_torch_fedcore_families import _moved_gap

    from olearning_sim_tpu.telemetry import MetricsRegistry
    from olearning_sim_tpu_torch.weights import params_from_jax

    registry = MetricsRegistry()
    jtask, ttask = shrink(load(name)), shrink(load(name))
    jtask["task_id"], ttask["task_id"] = f"{name}_jax", f"{name}_port"
    jrunner, jrepo, jhist, init = _run_jax(jtask, registry)
    trunner, trepo, thist = _run_port(ttask, registry, init)
    for col in ("logical_target", "logical_result", "logical_round"):
        assert trepo.get_item_value(ttask["task_id"], col) == \
            jrepo.get_item_value(jtask["task_id"], col), col
    j, t = jhist[0]["train"]["data_0"], thist[0]["train"]["data_0"]
    for k in ("released", "dropped", "clients_trained"):
        assert t[k] == j[k], k
    assert abs(t["mean_loss"] - j["mean_loss"]) <= 5e-2
    je, te = jhist[0]["evaluate"]["data_0"], thist[0]["evaluate"]["data_0"]
    assert abs(te["eval_loss"] - je["eval_loss"]) <= 5e-2
    jparams = params_from_jax(jax.tree.map(np.asarray, jrunner.states["data_0"].params))
    gap = _moved_gap(trunner.states["data_0"].params, init[0], jparams, init[0])
    print(f"{name}: moved gap {gap:.3e}; mean_loss {t['mean_loss']:.6f} {j['mean_loss']:.6f}")
    assert gap <= LARGE_MOVED_RTOL[name]
    if name == "ditto_cifar100_vit":
        jper = jrunner.personal_states["data_0"].params
        tper = trunner.personal_states["data_0"].params
        assert jax.tree.leaves(jper)[0].dtype == jnp.bfloat16
        assert all(v.dtype == torch.bfloat16 for v in tper.values())


def test_async_config_matches_jax_runner():
    """fedavg_mnist_mlp_async cut to 8 clients in buffers of 3 (three
    windows, the third past a max_staleness of 1) for 3 rounds, through
    both bridges: the host outputs exactly (dispatch, the async accounting,
    the commit clock, the task row), the params within mlp2's bounds."""
    from test_torch_fedcore_families import PARAM_ATOL, _compare_tree
    from test_torch_runner import LOSS_ATOL, _run_jax, _run_port

    from olearning_sim_tpu.telemetry import MetricsRegistry

    registry = MetricsRegistry()
    tasks = []
    for tid in ("async_jax", "async_port"):
        task = shrink(load("fedavg_mnist_mlp_async"), rounds=3)
        params = engine_params(task)
        params["async"].update(buffer_size=3, max_staleness=1)
        task["task_id"] = tid
        tasks.append(set_engine_params(task, params))
    jrunner, jrepo, jhist, init = _run_jax(tasks[0], registry)
    trunner, trepo, thist = _run_port(tasks[1], registry, init)
    for col in ("logical_target", "logical_result", "logical_round"):
        assert trepo.get_item_value("async_port", col) == \
            jrepo.get_item_value("async_jax", col), col
    for jr, tr in zip(jhist, thist):
        assert tr["async_clock"] == jr["async_clock"]
        j, t = jr["train"]["data_0"], tr["train"]["data_0"]
        assert sorted(t) == sorted(j)
        for k in ("released", "dropped", "clients_trained", "sim_duration_s", "commits",
                  "committed", "stale_dropped", "buffer_size", "windows", "idle_s",
                  "commit_clock", "round_close_s"):
            assert t[k] == j[k], (jr["round"], k)
        assert abs(t["mean_loss"] - j["mean_loss"]) <= LOSS_ATOL
        assert t["windows"] == 3 and t["stale_dropped"] == 2
    _compare_tree(trunner.states["data_0"].params, jrunner.states["data_0"].params,
                  PARAM_ATOL)


def test_trace_config_matches_jax_runner():
    """fedavg_mnist_mlp_trace, cut to 8 clients, 3 rounds and stream blocks
    of 8, through the port's bridge and the JAX bridge: the host outputs
    exactly (scenario counts, dispatch, clients trained, the stream walk,
    the task row), the params within mlp2's bounds (the port from JAX's
    init and draws)."""
    from test_torch_fedcore_families import PARAM_ATOL, _compare_tree
    from test_torch_runner import LOSS_ATOL, _run_jax
    from test_torch_streaming import _run_port_streamed

    from olearning_sim_tpu.telemetry import MetricsRegistry

    registry = MetricsRegistry()
    jtask = shrink(load("fedavg_mnist_mlp_trace"), rounds=3)
    ttask = shrink(load("fedavg_mnist_mlp_trace"), rounds=3)
    jtask["task_id"], ttask["task_id"] = "trace_jax", "trace_port"
    jrunner, jrepo, jhist, init = _run_jax(jtask, registry)
    trunner, trepo, thist = _run_port_streamed(ttask, registry, init)
    for col in ("logical_target", "logical_result", "logical_round"):
        assert trepo.get_item_value("trace_port", col) == \
            jrepo.get_item_value("trace_jax", col), col
    for jr, tr in zip(jhist, thist):
        j, t = jr["train"]["data_0"], tr["train"]["data_0"]
        for k in ("released", "dropped", "clients_trained", "sim_duration_s", "scenario"):
            assert t[k] == j[k], (jr["round"], k)
        for k in ("blocks", "cursor", "block_rows", "rows"):
            assert t["stream"][k] == j["stream"][k], (jr["round"], k)
        assert abs(t["mean_loss"] - j["mean_loss"]) <= LOSS_ATOL
    _compare_tree(trunner.states["data_0"].params, jrunner.states["data_0"].params,
                  PARAM_ATOL)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unsupported_config_names_its_roadmap_item(name):
    # Since the port runs model parallelism, the mp-2 config is refused only
    # where it cannot run: at a world of one, with the words of JAX's
    # make_mesh_plan over one device. The name stays from when the bridge
    # refused it naming ROADMAP.md A10.
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan

    with pytest.raises(ValueError) as want:
        make_mesh_plan(devices=jax.devices()[:1], **REFUSED[name])
    with pytest.raises(ValueError) as got:
        build_runner_from_taskconfig(load(name), device="cpu")
    assert str(got.value) == str(want.value)


def _with_params(**blocks):
    task = shrink(load("fedavg_mnist_mlp"))
    return set_engine_params(task, dict(engine_params(task), **blocks))


@pytest.mark.parametrize("block,bad", [
    ("deadline", "tight"),
    ("deadline", {"quorum_fracton": 0.5}),
    ("deadline", {"quorum_fraction": 2.0}),
    ("deadline", {"speed_profiles": {"high": "fast"}}),
    ("defense", "tight"),
    ("defense", {"aggregator": "krum"}),
    ("defense", {"clip_nrom": 1.0}),
    ("defense", {"trim_fraction": 0.7}),
    ("defense", {"anomaly_threshold": -1.0}),
    ("scenario", "diurnal"),
    ("scenario", {"online_bias": 0.5}),
    ("scenario", {"online_base": 1.5}),
    ("scenario", {"leave_rate": 1.0}),
    ("scenario", {"stream_block_rows": 0}),
    ("scenario", {"spikes": [{"boost": 2.0}]}),
    ("scenario", {"class_phase_hours": [6.0]}),
    ("async", "buffered"),
    ("async", {"bufer_size": 8}),
    ("async", {"buffer_size": 0}),
    ("async", {"schedule": "exponential"}),
    ("async", {"max_staleness": -1}),
])
def test_malformed_robust_blocks_are_refused_with_jax_messages(block, bad):
    """A malformed deadline, defense, scenario or async block fails at
    build time, before any data is made, with the error the JAX package's
    parser raises."""
    from olearning_sim_tpu.engine.async_rounds import AsyncConfig as JAsync
    from olearning_sim_tpu.engine.defense import DefenseConfig as JDefense
    from olearning_sim_tpu.engine.pacing import DeadlineConfig as JDeadline
    from olearning_sim_tpu.engine.scenario import ScenarioConfig as JScenario

    parse = {"deadline": JDeadline, "defense": JDefense, "scenario": JScenario,
             "async": JAsync}[block].from_dict
    with pytest.raises((TypeError, ValueError)) as want:
        parse(bad)
    with pytest.raises(want.type) as got:
        build_runner_from_taskconfig(_with_params(**{block: bad}), device="cpu")
    assert str(got.value) == str(want.value)


def test_unknown_model_raises_key_error():
    """An unregistered model name lets the registry's KeyError through, as
    the JAX bridge does (its get_model raises it)."""
    from olearning_sim_tpu.models import get_model as jget_model

    with pytest.raises(KeyError) as want:
        jget_model("no_such_model")
    with pytest.raises(KeyError) as got:
        build_runner_from_taskconfig(_with_params(model={"name": "no_such_model"}),
                                     device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("blocks,item", [
    # dp is the world size, not a key: JAX's ParallelConfig rejects it.
    pytest.param({"parallel": {"dp": 2}}, r"unknown parallel config keys: \['dp'\]",
                 id="blocks0-unknown parallel config keys: \\['dp'\\]"),
    # The websocket round provider (item A16) builds as the JAX bridge's.
    pytest.param({"operator_flow": {"selection_url": "ws://localhost:9"}}, None,
                 id="blocks1-ROADMAP.md A16"),
    pytest.param({"streaming": {"x": 1}}, "unknown engine params",
                 id="blocks2-unknown engine params"),
])
def test_left_out_blocks_are_refused(blocks, item):
    if item is not None:
        with pytest.raises(ValueError, match=item):
            build_runner_from_taskconfig(_with_params(**blocks), device="cpu")
        return
    from olearning_sim_tpu.taskmgr import operator_flow as jflow
    from olearning_sim_tpu_torch.taskmgr import operator_flow as tflow

    runner = build_runner_from_taskconfig(_with_params(**blocks), device="cpu")
    kwargs = runner.operator_flow.strategy_kwargs
    assert kwargs == blocks["operator_flow"]
    jbarrier, tbarrier = jflow._polling_barrier(**kwargs), tflow._polling_barrier(**kwargs)
    for attr in ("url", "query", "round_key", "timeout"):
        assert getattr(tbarrier.round_provider, attr) == getattr(jbarrier.round_provider, attr)
    assert type(tbarrier.round_provider).__name__ == "WebsocketRoundProvider"


# Each case was a refusal naming its ROADMAP.md item (the ids keep the
# items); each now does what the JAX package does with the same input.
@pytest.mark.parametrize("field,value,item", [
    ("model", {"model_update_style": "{task_id}_{round}", "model_transfer_type": "S3"},
     "A19"),
    ("model", {"use_model": True, "model_path": "m.msgpack",
               "model_transfer_type": "MINIO"}, "A19"),
    ("model", {"use_model": True, "model_path": "http://host/m.msgpack",
               "model_transfer_type": "HTTP"}, "A19"),
    ("model", {"model_update_style": "{task_id}_{round}", "model_transfer_type": ""},
     "A19"),
    ("data_path", "s3://bucket/mnist", "A14"),
    ("operator_code_path", "ops/train.zip", "A15"),
])
def test_left_out_task_fields_are_refused(field, value, item, monkeypatch, tmp_path):
    from olearning_sim_tpu import storage as jst
    from olearning_sim_tpu.data import fetch_dataset_dir as jfetch_data

    for key in ("OLS_STORAGE_ENDPOINT", "OLS_STORAGE_ACCESS_KEY", "OLS_STORAGE_SECRET_KEY",
                "OLS_STORAGE_BUCKET", "OLS_STORAGE_SECURE"):
        monkeypatch.delenv(key, raising=False)
    task = shrink(load("fedavg_mnist_mlp"))
    op = task["operatorflow"]["operators"][1]
    if field == "model":
        op["model"].update(value)
        kind = jst.FileTransferType[value["model_transfer_type"] or "S3"]
        try:
            want = type(jst.make_file_repo(kind)).__name__
        except ValueError as e:
            want = e
    elif field == "data_path":
        task["target"]["data"][0]["data_path"] = value
        with pytest.raises(FileNotFoundError) as e:
            jfetch_data(value, 0)  # the config's FILE transfer type
        want = e.value
    else:
        op["logical_simulation"]["operator_code_path"] = value
        with pytest.raises(FileNotFoundError) as e:
            jst.fetch_operator_code(jst.LocalFileRepo(root="/"), value, str(tmp_path))
        want = e.value
    if isinstance(want, Exception):
        with pytest.raises(type(want)) as got:
            build_runner_from_taskconfig(task, device="cpu")
        # The port's bridge names the task and operator before the message.
        assert str(want) in str(got.value)
        return
    runner = build_runner_from_taskconfig(task, device="cpu")
    assert type(runner.model_io.repo).__name__ == want == "HttpFileRepo"
    assert runner.warm_start_path == value["model_path"]



def _model_blocks(tmp_path):
    """The blocks this slice landed: each builds a runner and runs."""
    from olearning_sim_tpu_torch.checkpoint import export_model_bytes
    from olearning_sim_tpu_torch.weights import params_to_jax

    # The donor's model after one trained round: not the init a fresh
    # runner of the same task draws.
    donor = build_runner_from_taskconfig(shrink(load("fedavg_mnist_mlp")), device="cpu")
    donor.run()
    (tmp_path / "warm.msgpack").write_bytes(export_model_bytes(
        params_to_jax(donor.states["data_0"].params)))
    storage = {"storage": {"root": str(tmp_path)}}
    return {
        "checkpoint": ({"checkpoint": {"directory": str(tmp_path / "ck" / "{task_id}"),
                                       "every": 1}}, None),
        "use_model": (storage, {"use_model": True, "model_path": "warm.msgpack",
                                "model_transfer_type": "FILE"}),
        "model_update_style": (storage, {"model_update_style": "{task_id}_{round}.msgpack",
                                         "model_transfer_type": "FILE"}),
    }, donor


@pytest.mark.parametrize("case", ["checkpoint", "use_model", "model_update_style"])
def test_landed_blocks_build_and_run(case, tmp_path):
    cases, donor = _model_blocks(tmp_path)
    blocks, model = cases[case]
    task = _with_params(**blocks)
    if model is not None:
        task["operatorflow"]["operators"][1]["model"].update(model)
    runner = build_runner_from_taskconfig(task, device="cpu")
    runner.begin()
    entry = dict(runner.states["data_0"].params)
    while runner.step():
        pass
    assert len(runner.finish()) == 1
    if case == "checkpoint":
        assert runner.checkpointer.latest_round() == 0
        assert runner.checkpointer.directory == str(tmp_path / "ck" / task["task_id"])
    elif case == "use_model":
        # Round 0 starts from the file's params, not from a fresh init.
        assert runner.warm_start_path == "warm.msgpack"
        fresh = build_runner_from_taskconfig(shrink(load("fedavg_mnist_mlp")), device="cpu")
        fresh.begin()
        init = fresh.states["data_0"].params
        for k, v in donor.states["data_0"].params.items():
            assert torch.equal(entry[k], v)
            assert not torch.equal(entry[k], init[k])
    else:
        assert (tmp_path / f"{task['task_id']}_0.msgpack").is_file()


def test_relative_checkpoint_directory_is_anchored(monkeypatch, tmp_path):
    import tempfile

    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    task = _with_params(checkpoint={"directory": "ck/{task_id}", "max_to_keep": 2})
    runner = build_runner_from_taskconfig(task, device="cpu")
    assert runner.checkpointer.directory == str(tmp_path / "ck" / task["task_id"])
    assert runner.checkpointer.max_to_keep == 2
    default = build_runner_from_taskconfig(_with_params(checkpoint={"every": 2}), device="cpu")
    assert default.checkpointer.directory == str(tmp_path / "ols_checkpoints" / task["task_id"])
    assert default.checkpoint_every == 2


def _runner_view(runner):
    pop = runner.populations[0]
    state = runner.core.init_state(seed=1, device="cpu")
    return (runner.task_id, runner.rounds, repr(runner.core.config), runner.core.algorithm,
            [(o.name, o.kind, o.use_deviceflow, o.deviceflow_strategy, o.inputs)
             for o in runner.operators],
            pop.name, pop.device_classes, pop.nums, pop.dynamic_nums,
            pop.class_of_client.tolist(), None if pop.num_steps is None else pop.num_steps.tolist(),
            pop.dataset.x.tolist(), pop.dataset.weight.tolist(), pop.eval_data[1].tolist(),
            {k: v.tolist() for k, v in state.params.items()},
            runner.operator_flow.start_params, runner.operator_flow.stop_params)


def test_every_input_form_builds_the_same_runner():
    from olearning_sim_tpu.taskmgr.codecs import json2taskconfig as jax_json2taskconfig

    task = shrink(load("fedadam_sent140_distilbert"))
    text = json.dumps(task)
    views = [_runner_view(build_runner_from_taskconfig(form, device="cpu"))
             for form in (task, text, json2taskconfig(text), jax_json2taskconfig(text))]
    for view in views[1:]:
        assert view == views[0]


def test_compute_profiles_and_device_classes():
    task = shrink(load("fedavg_mnist_mlp"))
    td = task["target"]["data"][0]
    td["total_simulation"].update(devices=["high", "low"], nums=[5, 3], dynamic_nums=[1, 0])
    td["allocation"]["logical_simulation"] = [5, 3]
    params = engine_params(task)
    params["data"]["compute_profiles"] = {"low": 1}
    runner = build_runner_from_taskconfig(set_engine_params(task, params), device="cpu")
    pop = runner.populations[0]
    assert pop.class_of_client.tolist() == [0] * 5 + [1] * 3
    assert pop.num_steps.tolist() == [2] * 5 + [1] * 3
    assert pop.nums == [5, 3] and pop.dynamic_nums == [1, 0]
    assert cost_family(json2taskconfig(task)) == "fedavg_mlp2"


def test_bridge_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_runner_from_taskconfig(shrink(load("fedavg_mnist_mlp")))


# ------------------------------------------------ the JAX control plane
def _wait_for(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _manager(repo):
    from olearning_sim_tpu.taskmgr.task_manager import TaskManager

    return TaskManager(
        task_repo=repo, schedule_interval=3600,
        runner_factory=lambda tc, ev: build_runner_from_taskconfig(
            tc, task_repo=repo, stop_event=ev, device="cpu"))


def test_task_manager_runs_a_port_runner_to_succeeded():
    from olearning_sim_tpu.taskmgr.codecs import json2taskconfig as jax_json2taskconfig
    from olearning_sim_tpu.taskmgr.status import TaskStatus
    from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo as JaxRepo

    repo = JaxRepo()
    mgr = _manager(repo)
    task = shrink(load("fedavg_mnist_mlp"), rounds=2)
    task["task_id"] = "port_succeeds"
    try:
        assert mgr.submit_task(jax_json2taskconfig(task))
        assert mgr.schedule_once() == "port_succeeds"
        assert _wait_for(lambda: mgr._launcher.get_job_status("job-port_succeeds")
                         == TaskStatus.SUCCEEDED)
        mgr.release_once()
        assert mgr.get_task_status("port_succeeds") == TaskStatus.SUCCEEDED
        assert repo.get_item_value("port_succeeds", "logical_round") == 2
    finally:
        mgr.stop()


def test_task_manager_stops_a_port_runner():
    from olearning_sim_tpu.taskmgr.codecs import json2taskconfig as jax_json2taskconfig
    from olearning_sim_tpu.taskmgr.status import TaskStatus
    from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo as JaxRepo

    repo = JaxRepo()
    mgr = _manager(repo)
    task = shrink(load("fedavg_mnist_mlp"), rounds=10000)
    task["task_id"] = "port_stops"
    try:
        assert mgr.submit_task(jax_json2taskconfig(task))
        assert mgr.schedule_once() == "port_stops"
        assert _wait_for(lambda: (repo.get_item_value("port_stops", "logical_round") or 0) >= 1)
        assert mgr.stop_task("port_stops")
        assert _wait_for(lambda: mgr.get_task_status("port_stops") == TaskStatus.STOPPED)
        assert repo.get_item_value("port_stops", "logical_round") < 10000
    finally:
        mgr.stop()


# ------------------------------------------- FedCoreConfig.from_dict repair
@pytest.mark.parametrize("obj", [
    {"step_unroll": 4, "block_unroll": 2},
    {"aux_loss_weight": 0.5},
    {"aux_loss_weight": None, "step_unroll": None},
    {"shard_server_update": False, "batch_size": 8},
    {"shard_server_update": None},
])
def test_fedcore_config_accepts_jax_keys(obj):
    # Both accept the input; the port drops the JAX-only unroll hints (it
    # has no field for them), keeps aux_loss_weight as JAX's from_dict does
    # (a float, 0.01 when absent or null; read by moe_text) and
    # shard_server_update (False when absent or null), and keeps every field
    # the two share equal.
    from olearning_sim_tpu.engine import fedcore as jfc

    a, b = jfc.FedCoreConfig.from_dict(obj), tfc.FedCoreConfig.from_dict(obj)
    for k in ("step_unroll", "block_unroll"):
        assert not hasattr(b, k), k
    for k in ("batch_size", "max_local_steps", "block_clients", "eval_batch_size",
              "sample_mode", "aux_loss_weight", "shard_server_update"):
        assert getattr(a, k) == getattr(b, k), k
    assert type(b.aux_loss_weight) is float and type(b.shard_server_update) is bool


@pytest.mark.parametrize("obj", [{"step_unroll": 0}, {"block_unroll": -1},
                                 {"step_unroll": "x"}, {"block_unroll": 0.5},
                                 {"aux_loss_weight": "heavy"},
                                 {"step_unroll": 2, "unroll": 2}])
def test_fedcore_config_rejects_as_jax(obj):
    from olearning_sim_tpu.engine import fedcore as jfc

    for cls in (jfc.FedCoreConfig, tfc.FedCoreConfig):
        with pytest.raises(ValueError):
            cls.from_dict(obj)


def test_fedcore_config_refuses_sharded_server_update():
    # Since the port runs the sharded server update at a world of one
    # (tests/test_torch_shard_update.py), the key is accepted and kept as
    # JAX keeps it; the name stays from when the port refused it.
    from olearning_sim_tpu.engine import fedcore as jfc

    for value in (True, 1, "yes"):
        a = jfc.FedCoreConfig.from_dict({"shard_server_update": value})
        b = tfc.FedCoreConfig.from_dict({"shard_server_update": value})
        assert a.shard_server_update is b.shard_server_update is True
