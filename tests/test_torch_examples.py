"""The port's examples 1-4 (``olearning_sim_tpu_torch/examples/``) on the
CPU at the JAX examples' sizes, each holding its own checks, against the
same work run through the JAX package in the same test:

- ``library_quickstart``: the 10 rounds' losses and clients, the final
  parameters and the central eval from JAX's initial parameters and JAX's
  minibatch draws, within the bf16 tolerances of mlp2's round parity
  (``tests/test_torch_fedcore_families.py``; ``tests/test_torch_fedcore.py``'s
  are for f32 compute, and mlp2 computes its hidden layer in bf16 in both
  packages, JAX's with no dtype override), the accuracy within
  ``tests/test_torch_fedcore.py``'s 1e-6;
- ``custom_operator``: the user operator's accounting and reports equal to
  the JAX runner's with the same operator script;
- ``queue_submit`` and ``platform_submit``: the task's statuses and final
  row equal to the JAX platform's for the same task and config (the JAX
  side submits over its gRPC service, the port's through the manager call
  that service makes).

The JAX side is built from the JAX modules directly: the JAX examples'
``_bootstrap`` pins the JAX platform for the whole process."""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from olearning_sim_tpu.engine import algorithms as jalg
from olearning_sim_tpu.engine import client_data as jcd
from olearning_sim_tpu.engine import fedcore as jfc
from olearning_sim_tpu.parallel.mesh import make_mesh_plan
from olearning_sim_tpu_torch.engine import fedcore as tfc
from olearning_sim_tpu_torch.examples import (
    custom_operator,
    library_quickstart,
    platform_submit,
    queue_submit,
)
from olearning_sim_tpu_torch.weights import params_from_jax

import torch_threads  # noqa: F401
from test_torch_runner import _jax_indices
# Task-row columns that differ by run: times, lease owners, the port's
# extra column.
from test_torch_taskmgr import UNCOMPARED

# tests/test_torch_fedcore_families.py's bf16 tolerances and
# tests/test_torch_fedcore.py's accuracy tolerance. Measured over the
# quickstart's 10 rounds: round losses 2.8e-6 apart, final parameters
# 1.7e-5, the eval loss 3.1e-5, the accuracy equal.
PARAM_ATOL = 1e-3
LOSS_ATOL = 2e-3
ACC_ATOL = 1e-6

# ------------------------------------------------------ library_quickstart
def test_library_quickstart_matches_jax(monkeypatch):
    plan = make_mesh_plan(devices=jax.devices()[:1])
    cfg = jfc.FedCoreConfig(batch_size=8, max_local_steps=5, block_clients=8)
    jcore = jfc.build_fedcore("mlp2", jalg.fedavg(0.1), plan, cfg,
                              model_overrides={"hidden": (64,), "num_classes": 4},
                              input_shape=(16,))
    jds = jcd.make_synthetic_dataset(
        seed=0, num_clients=256, n_local=16, input_shape=(16,), num_classes=4,
        class_sep=3.0, dirichlet_alpha=0.5).pad_for(plan, 8).place(plan)
    jstate = jcore.init_state(jax.random.key(0))
    init = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    want = []
    for _ in range(10):
        jstate, jm = jcore.round_step(jstate, jds)
        want.append((float(jm.mean_loss), int(jm.clients_trained)))
    x, y = jcd.make_central_eval_set(0, 512, (16,), 4, class_sep=3.0)
    jl, ja = jcore.evaluate(jstate.params, x, y)

    # The port example from JAX's initial parameters, handed JAX's draws.
    init_state, round_step = tfc.FedCore.init_state, tfc.FedCore.round_step
    finals = []

    def from_jax(self, seed=0, device="cuda", params=None):
        return init_state(self, seed, device, params=init)

    def with_jax_draws(self, state, ds, **kw):
        kw["indices"] = _jax_indices(key_data, ds.client_uid.numpy(), ds.num_samples.numpy(),
                                     state.round_idx, 5, 8)
        out = round_step(self, state, ds, **kw)
        finals[:] = [out[0]]
        return out

    monkeypatch.setattr(tfc.FedCore, "init_state", from_jax)
    monkeypatch.setattr(tfc.FedCore, "round_step", with_jax_draws)
    got = library_quickstart.run("cpu")

    assert [r["clients"] for r in got["rounds"]] == [c for _, c in want] == [256] * 10
    np.testing.assert_allclose([r["loss"] for r in got["rounds"]], [l for l, _ in want],
                               atol=LOSS_ATOL, rtol=0)
    for k, v in params_from_jax(jax.tree.map(np.asarray, jstate.params)).items():
        np.testing.assert_allclose(finals[0].params[k].numpy(), v.numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)
    assert abs(got["eval_loss"] - jl) < LOSS_ATOL and abs(got["eval_acc"] - ja) < ACC_ATOL
    lines = library_quickstart.report(got)
    assert len(lines) == 11 and lines[-1].startswith("central eval: ")


# --------------------------------------------------------- custom_operator
def _jax_custom_operator(tmp_path):
    """The JAX example's flow, with the port example's operator script
    importing the JAX package's ABC."""
    from olearning_sim_tpu.engine.runner import DataPopulation, OperatorSpec, SimulationRunner
    from olearning_sim_tpu.operators import external_operator_spec

    plan = make_mesh_plan(devices=jax.devices()[:1])
    cfg = jfc.FedCoreConfig(batch_size=8, max_local_steps=3, block_clients=4)
    core = jfc.build_fedcore("mlp2", jalg.fedavg(0.1), plan, cfg,
                             model_overrides={"hidden": (32,), "num_classes": 4},
                             input_shape=(12,))
    ds = jcd.make_synthetic_dataset(seed=1, num_clients=16, n_local=8, input_shape=(12,),
                                    num_classes=4).pad_for(plan, 4).place(plan)
    pop = DataPopulation(name="data_0", dataset=ds, device_classes=["hpc"],
                         class_of_client=np.zeros(ds.num_clients, int), nums=[16],
                         dynamic_nums=[4])
    outdir, code_dir = tmp_path / "reports", tmp_path / "opcode"
    outdir.mkdir()
    code_dir.mkdir()
    script = custom_operator.USER_OPERATOR.format(
        repo_root=custom_operator.REPO_ROOT, outdir=str(outdir))
    (code_dir / "entry.py").write_text(
        script.replace("olearning_sim_tpu_torch.operators", "olearning_sim_tpu.operators"))
    operators = [OperatorSpec(name="train", kind="train"), OperatorSpec(name="eval", kind="eval"),
                 external_operator_spec("contribution_report", str(code_dir), "entry.py",
                                        operator_params=json.dumps({"report_weight": 0.5}),
                                        batch_size=4)]
    history = SimulationRunner(task_id="custom-op-demo", core=core, populations=[pop],
                               operators=operators, rounds=2).run()
    acct = [{k: h["contribution_report"]["data_0"][k] for k in ("success", "failed")}
            for h in history]
    reports = sorted(os.listdir(outdir))
    return acct, reports, json.loads((outdir / reports[0]).read_text())


def test_custom_operator_accounting_equals_jax(tmp_path):
    got = custom_operator.run("cpu")
    acct, reports, sample = _jax_custom_operator(tmp_path)
    assert [{k: r[k] for k in ("success", "failed")} for r in got["rounds"]] == acct == \
        [{"success": 16, "failed": 0}] * 2
    assert got["reports"] == reports and len(reports) == 8
    assert got["sample"] == sample == {"round": 0, "clients": [0, 1, 2, 3], "weight": 0.5}
    assert all(np.isfinite(r["loss"]) for r in got["rounds"])
    assert custom_operator.report(got)[2].startswith("user operator wrote 8 batch reports")


# ---------------------------------------------- queue_submit, platform_submit
def _jax_wait_released(session, rows, task_id, timeout=120.0):
    from olearning_sim_tpu.taskmgr.status import TaskStatus

    end = time.monotonic() + timeout
    seen = []
    while time.monotonic() < end:
        st = session.task_manager.get_task_status(task_id)
        if not seen or seen[-1] != st.name:
            seen.append(st.name)
        if st in (TaskStatus.SUCCEEDED, TaskStatus.FAILED) and \
                str(rows.get_item_value(task_id, "resource_occupied")) == "0":
            break
        time.sleep(0.2)
    return seen


def _jax_platform(tmp_path, queued):
    """The same task through the JAX platform: pushed onto its SQLite
    intake queue (``queued``) or submitted over its gRPC service."""
    import grpc

    from olearning_sim_tpu.config import build_session
    from olearning_sim_tpu.taskmgr.codecs import json2taskconfig
    from olearning_sim_tpu.taskmgr.grpc_service import TaskMgrClient
    from olearning_sim_tpu.taskmgr.queue_repo import SqliteQueueRepo
    from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo

    if queued:
        cfg, task_id = queue_submit.queue_config(str(tmp_path)), queue_submit.TASK_ID
        producer = SqliteQueueRepo(cfg["repos"]["intake_queue_path"])
        producer.push(json.dumps(platform_submit.make_task(task_id)))
        producer.close()
    else:
        cfg, task_id = platform_submit.session_config(str(tmp_path)), platform_submit.TASK_ID
    cfg["session"]["address"] = "127.0.0.1:0"
    session = build_session(cfg)
    rows = TaskTableRepo(sqlite_path=cfg["repos"]["sqlite_path"])
    with session:
        if not queued:
            with grpc.insecure_channel(f"127.0.0.1:{session.port}") as ch:
                tc = json2taskconfig(json.dumps(platform_submit.make_task(task_id)))
                assert TaskMgrClient(ch).submitTask(tc).is_success
        statuses = _jax_wait_released(session, rows, task_id)
    row = next(r for r in rows.query_all() if r["task_id"] == task_id)
    return statuses, {k: v for k, v in row.items() if k not in UNCOMPARED}


@pytest.mark.parametrize("example", ["queue_submit", "platform_submit"])
def test_submitted_task_row_equals_jax(example, tmp_path, monkeypatch):
    for name in ("OLS_SQLITE_PATH", "OLS_INTAKE_QUEUE_PATH"):
        monkeypatch.delenv(name, raising=False)
    module = queue_submit if example == "queue_submit" else platform_submit
    got = module.run("cpu")
    statuses, row = _jax_platform(tmp_path, queued=example == "queue_submit")
    assert got["statuses"][-1] == statuses[-1] == "SUCCEEDED"
    assert {k: v for k, v in got["row"].items() if k not in UNCOMPARED} == row
    assert row["task_status"] == "SUCCEEDED" and str(row["logical_round"]) == "3"
    if example == "platform_submit":
        assert got["submitted"] is True
    assert module.report(got)[-1].endswith("completed successfully: logical_round 3")


def test_examples_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples run on it")
    for module in (library_quickstart, custom_operator, queue_submit, platform_submit):
        with pytest.raises(RuntimeError, match="cuda"):
            module.run()
