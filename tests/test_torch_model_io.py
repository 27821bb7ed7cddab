"""Model files between the JAX package and the port, after
tests/test_model_io.py: the port's msgpack bytes equal flax's
``to_bytes`` for the families' trees (and a bf16 leaf, and flax's chunked
form), a JAX runner's round file warm-starts a port runner and the
reverse with params equal exactly, a port runner exports every round under
the reference's update style, and a FedAvg run resumed from its exported
round model equals the uninterrupted run bitwise."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_runner import task_json

from olearning_sim_tpu_torch.checkpoint import (
    ModelUpdateExporter,
    export_model_bytes,
    import_model_bytes,
    msgpack_wire,
)
from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
from olearning_sim_tpu_torch.storage import LocalFileRepo, ResilientFileRepo, make_file_repo
from olearning_sim_tpu_torch.weights import params_from_jax, params_to_jax

FAMILIES = {
    "mlp2": ({"hidden": (16,), "num_classes": 4}, (12,), jnp.float32),
    "cnn4": ({"features": (4, 8)}, (8, 8, 3), jnp.float32),
    "distilbert": ({"depth": 2, "width": 16, "heads": 2, "mlp_dim": 32, "vocab_size": 97,
                    "max_len": 8}, (8,), jnp.int32),
    "distilbert_flash": ({"depth": 1, "width": 16, "heads": 2, "mlp_dim": 32,
                          "vocab_size": 97, "max_len": 8, "attention_impl": "flash"},
                         (8,), jnp.int32),
    "resnet18": ({"stage_features": (8, 8, 16, 16), "blocks_per_stage": (1, 1, 1, 1),
                  "groups": 4}, (28, 28, 1), jnp.float32),
    "vit_tiny": ({"width": 16, "depth": 2, "heads": 2, "mlp_dim": 32}, (32, 32, 3),
                 jnp.float32),
    "moe_text": ({"vocab_size": 97, "max_len": 8, "width": 16, "depth": 2, "heads": 2,
                  "mlp_dim": 32, "num_experts": 4}, (8,), jnp.int32),
}


def _flax_params(family):
    from olearning_sim_tpu.models import get_model

    overrides, shape, dtype = FAMILIES[family]
    model = get_model(family.removesuffix("_flash")).build(**overrides)
    return jax.device_get(model.init(jax.random.key(0), jnp.zeros((1,) + shape, dtype))["params"])


def _keys(tree):
    return [(k, _keys(v)) for k, v in tree.items()] if isinstance(tree, dict) else None


def _assert_tree_equal(a, b):
    assert _keys(a) == _keys(b) or sorted(a) == sorted(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_model_bytes_equal_flax(family):
    """The flax tree the port builds from its params has flax init's key
    order once sorted, as jax.device_get returns it, and its bytes are
    flax's to the byte; each package reads the other's."""
    from flax import serialization

    jparams = _flax_params(family)
    port = params_from_jax(jparams)
    tree = params_to_jax(port, heads=FAMILIES[family][0].get("heads"))
    assert _keys(msgpack_wire.sorted_tree(tree)) == _keys(jparams)
    data = export_model_bytes(tree)
    assert data == serialization.to_bytes(jparams)
    _assert_tree_equal(serialization.from_bytes(jparams, data), jparams)
    back = import_model_bytes(tree, serialization.to_bytes(jparams))
    for k, v in params_from_jax(back).items():
        assert torch.equal(v, port[k]), k


def test_scalars_lists_and_bf16_equal_flax():
    from flax import serialization

    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b16": jnp.linspace(-2, 2, 7, dtype=jnp.bfloat16),
            "i": np.int32(-5), "f": 0.25, "n": None, "t": True, "s": "x" * 40,
            "l": [1, -40, 300, 70000, 2**40, -2**40], "raw": b"\x00" * 300,
            "empty": {}, "nest": {"k": np.zeros((0, 4), np.int64)}}
    port_tree = dict(tree, b16=torch.from_numpy(np.asarray(tree["b16"], np.float32)).to(
        torch.bfloat16))
    # msgpack_serialize copies the tree with jax.tree.map, which sorts maps.
    ref = serialization.msgpack_serialize(tree)
    assert msgpack_wire.to_bytes(msgpack_wire.sorted_tree(port_tree)) == ref
    got = msgpack_wire.msgpack_restore(ref)
    assert got["b16"].dtype == torch.bfloat16
    assert torch.equal(got["b16"], port_tree["b16"])
    assert got["i"] == np.int32(-5) and got["l"] == tree["l"] and got["raw"] == tree["raw"]
    restored = serialization.msgpack_restore(msgpack_wire.to_bytes(port_tree))
    np.testing.assert_array_equal(np.asarray(restored["b16"], np.float32),
                                  np.asarray(tree["b16"], np.float32))
    assert restored["nest"]["k"].shape == (0, 4)


def test_chunked_form_both_ways(monkeypatch):
    """With the chunk limit lowered in both packages, oversized arrays are
    written as flax's chunked maps, byte for byte, and read back by each."""
    from flax import serialization

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 96)
    monkeypatch.setattr(msgpack_wire, "MAX_CHUNK_SIZE", 96)
    jparams = _flax_params("mlp2")
    ref = serialization.to_bytes(jparams)
    assert b"__msgpack_chunked_array__" in ref
    assert export_model_bytes(params_to_jax(params_from_jax(jparams))) == ref
    _assert_tree_equal(import_model_bytes(jparams, ref), jparams)
    big = torch.arange(100, dtype=torch.bfloat16).reshape(10, 10)
    data = msgpack_wire.to_bytes({"b": big})
    assert torch.equal(msgpack_wire.msgpack_restore(data)["b"], big)
    np.testing.assert_array_equal(
        np.asarray(serialization.msgpack_restore(data)["b"], np.float32), big.float().numpy())


def test_import_refuses_another_tree():
    jparams = _flax_params("mlp2")
    data = export_model_bytes({"Dense_0": jparams["Dense_0"]})
    with pytest.raises(ValueError, match="Dense_1"):
        import_model_bytes(jparams, data)
    with pytest.raises(ValueError):
        msgpack_wire.msgpack_restore(data[:-3])


# ------------------------------------------------------------ the runners
def _task(task_id, rounds, update_style="", use_model=False, model_path="", root=""):
    task = task_json(task_id, rounds=rounds)
    for op in task["operatorflow"]["operators"][:1]:
        op["model"].update(model_update_style=update_style, use_model=use_model,
                           model_path=model_path)
    info = task["operatorflow"]["operators"][0]["logical_simulation"]
    params = json.loads(info["operator_params"])
    params["storage"] = {"root": root}
    info["operator_params"] = json.dumps(params)
    return task


def _port(task):
    return build_runner_from_taskconfig(task, device="cpu")


def _jax(task):
    from olearning_sim_tpu.engine.task_bridge import build_runner_from_taskconfig as jbuild
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan

    return jbuild(task, plan=make_mesh_plan(devices=jax.devices()[:1]))


def test_port_exports_each_round_with_reference_style(tmp_path):
    runner = _port(_task("exp", 3, "{task_id}_{current_round}_result_model.msgpack",
                         root=str(tmp_path)))
    runner.run()
    for r in range(3):
        assert (tmp_path / f"exp_{r}_result_model.msgpack").is_file()
    last = import_model_bytes(
        params_to_jax(runner.states["data_0"].params),
        (tmp_path / "exp_2_result_model.msgpack").read_bytes())
    for k, v in params_from_jax(last).items():
        assert torch.equal(v, runner.states["data_0"].params[k]), k


def test_jax_round_file_warm_starts_a_port_runner(tmp_path):
    from olearning_sim_tpu.checkpoint import ModelUpdateExporter as JExporter
    from olearning_sim_tpu.storage import LocalFileRepo as JRepo

    jrunner = _jax(_task("jax_donor", 2))
    jrunner.model_io = JExporter(JRepo(root=str(tmp_path)), "jax_donor")
    jrunner.run()
    jparams = jax.device_get(jrunner.states["data_0"].params)
    task = _task("port_warm", 1, use_model=True,
                 model_path="jax_donor_1_result_model.msgpack", root=str(tmp_path))
    runner = _port(task)
    runner.begin()
    assert runner._loop["round_idx"] == 0
    for k, v in params_from_jax(jparams).items():
        assert torch.equal(runner.states["data_0"].params[k], v), k


def test_port_round_file_warm_starts_a_jax_runner(tmp_path):
    from olearning_sim_tpu.checkpoint import ModelUpdateExporter as JExporter
    from olearning_sim_tpu.storage import LocalFileRepo as JRepo

    runner = _port(_task("port_donor", 2, "{task_id}_{round}_result_model.msgpack",
                         root=str(tmp_path)))
    runner.run()
    jrunner = _jax(_task("jax_warm", 1))
    jrunner.model_io = JExporter(JRepo(root=str(tmp_path)), "jax_warm")
    jrunner.warm_start_path = "port_donor_1_result_model.msgpack"
    jrunner.states["data_0"] = jrunner.core.init_state(jax.random.key(5))
    jrunner._warm_start()
    _assert_tree_equal(jax.device_get(jrunner.states["data_0"].params),
                       params_to_jax(runner.states["data_0"].params))


def test_port_resumes_from_jax_round_files(tmp_path):
    """A JAX runner's round files, under the port task's name, are what a
    port runner resumes from: it picks up after the newest one with those
    params and the round counter moved."""
    from olearning_sim_tpu.checkpoint import ModelUpdateExporter as JExporter
    from olearning_sim_tpu.storage import LocalFileRepo as JRepo

    jrunner = _jax(_task("shared", 2))
    jrunner.model_io = JExporter(JRepo(root=str(tmp_path)), "shared")
    jrunner.run()
    runner = _port(_task("shared", 4, "{task_id}_{round}_result_model.msgpack",
                         root=str(tmp_path)))
    runner.begin()
    assert runner._loop["round_idx"] == 2 and runner.states["data_0"].round_idx == 2
    for k, v in params_from_jax(jax.device_get(jrunner.states["data_0"].params)).items():
        assert torch.equal(runner.states["data_0"].params[k], v), k
    while runner.step():
        pass
    assert [h["round"] for h in runner.finish()] == [2, 3]
    assert (tmp_path / "shared_3_result_model.msgpack").is_file()


@pytest.mark.parametrize("algorithm", ["fedavg", "fedadam"])
def test_export_resume(algorithm, tmp_path):
    """Resumed from its round-1 model file, a run picks up at round 2 with
    the round counter moved (the minibatch draws are seeded from it). FedAvg's
    server optimizer is stateless, so the run equals the uninterrupted one
    bitwise; FedAdam's moments restart cold, as in the JAX package."""
    style = "{task_id}_{round}_result_model.msgpack"

    def task(rounds, root):
        t = _task("exp_resume", rounds, style, root=str(root))
        info = t["operatorflow"]["operators"][0]["logical_simulation"]
        params = json.loads(info["operator_params"])
        if algorithm == "fedadam":
            params["algorithm"] = {"name": "fedadam", "local_lr": 0.1, "server_lr": 0.01}
        info["operator_params"] = json.dumps(params)
        return t

    straight = _port(task(4, tmp_path / "a"))
    straight.run()
    _port(task(2, tmp_path / "b")).run()
    resumed = _port(task(4, tmp_path / "b"))
    history = resumed.run()
    assert [h["round"] for h in history] == [2, 3]
    assert resumed.states["data_0"].round_idx == 4
    same = [torch.equal(resumed.states["data_0"].params[k], v)
            for k, v in straight.states["data_0"].params.items()]
    if algorithm == "fedavg":
        assert all(same)
        assert history == straight.history[2:]
    else:
        assert not all(same)
        assert resumed.states["data_0"].opt_state["count"] == 2


def test_warm_start_requires_repo():
    from olearning_sim_tpu_torch.engine.runner import SimulationRunner

    r = _port(task_json("wsr", rounds=1))
    with pytest.raises(ValueError, match="model_io"):
        SimulationRunner(task_id="t", core=r.core, populations=r.populations,
                         operators=r.operators, rounds=1, warm_start_path="x.msgpack")


def test_exporter_round_files_and_missing(tmp_path):
    repo = LocalFileRepo(root=str(tmp_path / "store"))
    exporter = ModelUpdateExporter(repo, task_id="t9", scratch_dir=str(tmp_path / "scratch"))
    params = params_to_jax(_port(task_json("t9", rounds=1)).core.init_state(
        seed=3, device="cpu").params)
    name = exporter.export(2, params)
    assert name == "t9_2_result_model.msgpack" and repo.exists(name)
    _assert_tree_equal(exporter.load(2, params), params)
    with pytest.raises(FileNotFoundError):
        exporter.load(5, params)
    assert list((tmp_path / "scratch").iterdir()) == []


# ----------------------------------------------------------- file repos
def test_local_file_repo_matches_jax(tmp_path):
    from olearning_sim_tpu.storage import LocalFileRepo as JRepo

    src = tmp_path / "src.bin"
    src.write_bytes(b"model")
    results = []
    for cls, root in ((LocalFileRepo, tmp_path / "port"), (JRepo, tmp_path / "jax")):
        repo = cls(root=str(root))
        out = [repo.upload_file(str(src), "a/b.bin"), repo.exists("a/b.bin"),
               repo.list_files("a"), repo.download_file("a/b.bin", str(root / "dl.bin")),
               (root / "dl.bin").read_bytes(), repo.delete_file("a/b.bin"),
               repo.exists("a/b.bin"), repo.download_file("a/b.bin", str(root / "x")),
               repo.upload_file(str(tmp_path / "missing"), "c")]
        results.append(out)
    assert results[0] == results[1]
    with pytest.raises(ValueError, match="whole filesystem"):
        LocalFileRepo(root="/").list_files("")


def test_resilient_repo_retries_storage_faults(tmp_path):
    from olearning_sim_tpu_torch.resilience import RetryPolicy
    from olearning_sim_tpu_torch.resilience import faults as tfaults

    src = tmp_path / "m.bin"
    src.write_bytes(b"x")
    policy = RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0, sleep=lambda _s: None)
    repo = make_file_repo("FILE", root=str(tmp_path / "store"), retry_policy=policy)
    assert isinstance(repo, ResilientFileRepo)
    plan = {"seed": 0, "specs": [{"point": "storage.upload", "error": "false", "times": 2}]}
    with tfaults.chaos(tfaults.FaultPlan.from_dict(plan)):
        assert repo.upload_file(str(src), "m.bin")
    assert repo.exists("m.bin")
    plan = {"seed": 0, "specs": [{"point": "storage.download", "times": 3}]}
    with tfaults.chaos(tfaults.FaultPlan.from_dict(plan)):
        with pytest.raises(Exception):
            repo.download_file("m.bin", str(tmp_path / "d"))


@pytest.mark.parametrize("kind", ["HTTP", "S3", "MINIO", 1, 2, 3])
def test_remote_transfer_types_name_a19(kind, monkeypatch):
    """Each remote transfer type (item A19) does what the JAX factory does:
    HTTP builds its repo, S3 and MinIO without object-store settings raise
    the JAX factory's ValueError."""
    from olearning_sim_tpu.storage import FileTransferType
    from olearning_sim_tpu.storage import make_file_repo as jmake

    for key in ("OLS_STORAGE_ENDPOINT", "OLS_STORAGE_ACCESS_KEY", "OLS_STORAGE_SECRET_KEY",
                "OLS_STORAGE_BUCKET", "OLS_STORAGE_SECURE"):
        monkeypatch.delenv(key, raising=False)
    jkind = FileTransferType(kind) if isinstance(kind, int) else FileTransferType[kind]
    try:
        want = type(jmake(jkind)).__name__
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_file_repo(kind)
        assert str(got.value) == str(e) and "OLS_STORAGE_ENDPOINT" in str(e)
    else:
        assert type(make_file_repo(kind)).__name__ == want == "HttpFileRepo"
    assert isinstance(make_file_repo(0, root="store"), LocalFileRepo)
    with pytest.raises(ValueError, match="unknown file transfer type"):
        make_file_repo("FTP")
