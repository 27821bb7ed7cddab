"""The port's SimulationRunner: counterparts of tests/test_runner.py (round
loop and accounting, status fusion, train -> eval chain, custom operator,
deviceflow lifecycle with the JAX package's DeviceFlowService, the barriers,
final-round stop tolerance, DAG inputs), and a small task run through the
JAX bridge and runner and through the port's, on the CPU.

In the task comparison the port starts from the JAX runner's initial
parameters (installed in ``runner.states`` before ``run()``) and trains on
the JAX engine's minibatch indices: the test wraps the port's round_step and
hands it JAX's per-client draw (fold_in(fold_in(fold_in(base_key, uid),
round), step) -> randint) for the state's round counter, which rollback
restores in both. Host-side outputs must then agree exactly; numbers
within the mlp2 bounds of tests/test_torch_fedcore_families.py."""

import copy
import dataclasses
import json
import time
import zlib
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from olearning_sim_tpu_torch.engine import build_fedcore, fedavg, make_synthetic_dataset
from olearning_sim_tpu_torch.engine.client_data import make_central_eval_set
from olearning_sim_tpu_torch.engine.fedcore import FedCoreConfig
from olearning_sim_tpu_torch.engine.runner import DataPopulation, OperatorSpec, SimulationRunner
from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
from olearning_sim_tpu_torch.resilience import faults as tfaults
from olearning_sim_tpu_torch.taskmgr.operator_flow import OperatorFlowController
from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo
from olearning_sim_tpu_torch.weights import params_from_jax

import torch_threads  # noqa: F401

INPUT_SHAPE = (12,)
NUM_CLASSES = 3
# mlp2 computes in bf16 on both sides (tests/test_torch_fedcore_families.py).
PARAM_ATOL = 1e-3
LOSS_ATOL = 2e-3
EVAL_N = 128
# Eval accuracy: a row whose two top bf16 logits lie within a rounding step
# may be classified differently; two such rows of EVAL_N.
ACC_ATOL = 2 / EVAL_N
# A retried port run against a clean one: same device, same kernels, same
# draws, so only a wrong restore can move the result.
RETRY_REL = 1e-6


def build_runner(num_clients=32, rounds=3, operators=None, deviceflow=None, repo=None):
    cfg = FedCoreConfig(batch_size=4, max_local_steps=3, block_clients=2)
    core = build_fedcore("mlp2", fedavg(0.1), cfg,
                         model_overrides={"hidden": (16,), "num_classes": NUM_CLASSES},
                         input_shape=INPUT_SHAPE, device="cpu")
    ds = make_synthetic_dataset(3, num_clients, 10, INPUT_SHAPE, NUM_CLASSES,
                                class_sep=4.0).pad_for(2).to("cpu")
    cls = (np.arange(ds.num_clients) >= num_clients // 2).astype(int)
    pop = DataPopulation(
        name="data_0", dataset=ds, device_classes=["high", "low"], class_of_client=cls,
        nums=[num_clients // 2, num_clients - num_clients // 2], dynamic_nums=[0, 0],
        eval_data=make_central_eval_set(3, 256, INPUT_SHAPE, NUM_CLASSES, class_sep=4.0),
    )
    return SimulationRunner(task_id="task_e2e", core=core, populations=[pop],
                            operators=operators or [OperatorSpec(name="train")],
                            rounds=rounds, task_repo=repo, deviceflow=deviceflow)


def test_round_loop_trains_and_accounts():
    repo = TaskTableRepo()
    runner = build_runner(rounds=3, repo=repo)
    history = runner.run()
    assert len(history) == 3
    losses = [h["train"]["data_0"]["mean_loss"] for h in history]
    assert losses[-1] < losses[0]
    assert repo.get_item_value("task_e2e", "logical_round") == 3
    assert repo.get_item_value("task_e2e", "logical_operator") == "train"
    sim = json.loads(repo.get_item_value("task_e2e", "logical_result"))[
        "logical_result"][0]["simulation_target"]
    assert sim["devices"] == ["high", "low"]
    assert sum(sim["success_num"]) == 32
    assert sum(sim["failed_num"]) == 0


def test_status_fusion_from_runner_output():
    """Runner accounting -> the JAX control plane's calculate_conditions ->
    combine_task_status == SUCCEEDED."""
    from olearning_sim_tpu.taskmgr.status import (
        SimHalfState,
        TaskStatus,
        calculate_conditions,
        combine_task_status,
    )

    repo = TaskTableRepo()
    build_runner(rounds=2, repo=repo).run()
    logical = SimHalfState(
        present=True,
        target=json.loads(repo.get_item_value("task_e2e", "logical_target"))["logical_target"],
        result=json.loads(repo.get_item_value("task_e2e", "logical_result"))["logical_result"],
        current_round=repo.get_item_value("task_e2e", "logical_round"),
        operator_name=repo.get_item_value("task_e2e", "logical_operator"),
    )
    tp = {"max_round": 2, "operator_name_list": ["train"], "data_name_list": ["data_0"],
          "total_simulation": [{"simulation_target": {
              "devices": ["high", "low"], "nums": [16, 16], "dynamic_nums": [0, 0]}}]}
    c = calculate_conditions(tp, logical, SimHalfState(present=False))
    assert c.logical_success
    assert combine_task_status(c, TaskStatus.SUCCEEDED, True) == TaskStatus.SUCCEEDED


def test_multi_operator_chain_with_eval():
    ops = [OperatorSpec(name="train"), OperatorSpec(name="evaluate", kind="eval")]
    runner = build_runner(rounds=2, operators=ops)
    history = runner.run()
    assert history[-1]["evaluate"]["data_0"]["eval_acc"] > 0.5
    assert runner.task_repo.get_item_value("task_e2e", "logical_operator") == "evaluate"


def test_custom_operator_escape_hatch():
    calls = []

    def my_op(runner, round_idx, op):
        calls.append(round_idx)
        return {"note": "external"}

    ops = [OperatorSpec(name="train"), OperatorSpec(name="ext", kind="custom", custom_fn=my_op)]
    history = build_runner(rounds=2, operators=ops).run()
    assert calls == [0, 1]
    assert history[0]["ext"]["data_0"]["note"] == "external"


def test_runner_with_deviceflow_lifecycle():
    """The JAX package's DeviceFlowService drives a port runner: flows walk
    NotifyStart/NotifyComplete and the trace modulates participation."""
    from olearning_sim_tpu.deviceflow import DeviceFlowService

    svc = DeviceFlowService(poll_interval=0.01)
    svc.start()
    try:
        svc.register_task("task_e2e", ["logical_simulation"])
        strategy = json.dumps({"flow_dispatch": {
            "use_strategy": True, "total_dispatch_amount": 20,
            "specific_timing": {"use": True, "time_type": "relative",
                                "timings": [0], "amounts": [20]}}})
        ops = [OperatorSpec(name="train", use_deviceflow=True, deviceflow_strategy=strategy)]
        history = build_runner(rounds=2, operators=ops, deviceflow=svc).run()
        assert history[0]["train"]["data_0"]["released"] == 20
        assert history[0]["train"]["data_0"]["clients_trained"] == 20
        deadline = time.monotonic() + 5
        while not svc.check_dispatch_finished("task_e2e") and time.monotonic() < deadline:
            time.sleep(0.02)
        assert svc.check_dispatch_finished("task_e2e")
    finally:
        svc.stop()


def test_operator_flow_flag_file_barrier(tmp_path):
    flag = tmp_path / "aggregation_finished.txt"
    flag.write_text("done")
    flow = OperatorFlowController(
        "t", 1, start_params={"strategy": "sample_and_aggregation"},
        stop_params={"strategy": "sample_and_aggregation",
                     "wait_interval": 0.01, "total_timeout": 1},
        strategy_kwargs={"flag_path": str(flag)})
    assert flow.start()
    assert flow.stop()
    assert not flag.exists()
    flow.stop_params["total_timeout"] = 0.05
    assert not flow.stop()


def test_operator_flow_polling_round_barrier():
    rounds = iter([5, 5, 6])
    flow = OperatorFlowController(
        "t", 1,
        start_params={"strategy": "waiting_for_global_aggregation",
                      "wait_interval": 0.01, "total_timeout": 1},
        stop_params={"strategy": "waiting_for_global_aggregation",
                     "wait_interval": 0.01, "total_timeout": 1},
        strategy_kwargs={"round_provider": lambda: next(rounds)})
    assert flow.start()
    assert flow.current_round == 5
    assert flow.stop()
    assert flow.current_round == 6


def test_final_round_stop_tolerance():
    def failing_stop(rounds):
        return OperatorFlowController(
            "t", rounds, stop_params={"strategy": "sample_and_aggregation",
                                      "wait_interval": 0.01, "total_timeout": 0.05},
            strategy_kwargs={"flag_path": "/nonexistent/flag.txt"})

    runner = build_runner(rounds=2)
    runner.operator_flow = failing_stop(2)
    with pytest.raises(RuntimeError):
        runner.run()  # a stop failure before the final round raises
    runner2 = build_runner(rounds=1)
    runner2.operator_flow = failing_stop(1)
    assert len(runner2.run()) == 1  # the final round's is tolerated


def test_operator_dag_inputs_compose():
    seen = []

    def aggregate(runner, round_idx, operator, population):
        ins = runner.operator_inputs(operator)
        assert set(ins) == {"train"}
        train_rec = ins["train"][population.name]
        seen.append((round_idx, float(train_rec["mean_loss"])))
        return {"consumed_loss": float(train_rec["mean_loss"])}

    ops = [OperatorSpec(name="train", kind="train"),
           OperatorSpec(name="evaluate", kind="eval", inputs=["train"]),
           OperatorSpec(name="agg", kind="custom", inputs=["train"], custom_fn=aggregate)]
    history = build_runner(rounds=2, operators=ops).run()
    assert len(seen) == 2
    for h, (r, loss) in zip(history, seen):
        assert h["agg"]["data_0"]["consumed_loss"] == loss
        assert loss == h["train"]["data_0"]["mean_loss"]


# ------------------------------------------------ the task, JAX vs the port
STRATEGY = {"flow_dispatch": {"use_strategy": True, "total_dispatch_amount": 10,
                              "specific_timing": {
                                  "use": True, "time_type": "relative",
                                  "timings": [0, 2], "amounts": [6, 4],
                                  "drop_simulation": {"drop_probability": [0.2, 0.3]}}}}


def task_json(task_id, rounds=3, resilience=None, strategy=STRATEGY, evaluate=True):
    """mlp2 at hidden [16], 12 clients in two device classes with compute
    profiles, block 4, a flow_dispatch strategy with drops, train + eval."""
    params = {
        "model": {"name": "mlp2", "overrides": {"hidden": [16], "num_classes": 4},
                  "input_shape": [10]},
        "algorithm": {"name": "fedavg", "local_lr": 0.1},
        "fedcore": {"batch_size": 4, "max_local_steps": 3, "block_clients": 4},
        "data": {"synthetic": {"seed": 2, "n_local": 8, "num_classes": 4,
                               "class_sep": 3.0}, "eval_n": EVAL_N,
                 "compute_profiles": {"high": 3, "low": 1}},
    }
    if resilience is not None:
        params["resilience"] = resilience
    cond = {"logical_simulation": {"strategy": "", "wait_interval": 0, "total_timeout": 0}}

    def op(name, path, inputs, strategy=None):
        return {"name": name, "input": inputs,
                "operation_behavior_controller": {
                    "use_gradient_house": strategy is not None,
                    "strategy_gradient_house": json.dumps(strategy) if strategy else "",
                    "outbound_service": ""},
                "model": {"use_model": False, "model_transfer_type": "FILE"},
                "logical_simulation": {"operator_transfer_type": "FILE",
                                       "operator_code_path": path,
                                       "operator_params": json.dumps(params)
                                       if path == "builtin:train" else ""}}

    return {
        "user_id": "u", "task_id": task_id,
        "target": {"data": [{"name": "data_0", "data_transfer_type": "FILE",
                             "total_simulation": {"devices": ["high", "low"],
                                                  "nums": [6, 6], "dynamic_nums": [1, 1]},
                             "allocation": {"logical_simulation": [6, 6]}}]},
        "operatorflow": {"flow_setting": {"round": rounds, "start": cond, "stop": cond},
                         "operators": [op("train", "builtin:train", [], strategy)]
                         + ([op("evaluate", "builtin:eval", ["train"])] if evaluate else [])},
    }


# JAX salts the key of Ditto's personal branch with this constant.
PERSONAL_SALT = 0x0D1770


def _jax_indices(key_data, uids, num_samples, round_idx, steps, batch, salt=None):
    base_key = jax.random.wrap_key_data(key_data)

    def one(uid, n):
        key = jax.random.fold_in(jax.random.fold_in(base_key, uid), jnp.int32(round_idx))
        if salt is not None:
            key = jax.random.fold_in(key, salt)
        return jax.vmap(lambda i: jax.random.randint(
            jax.random.fold_in(key, i), (batch,), 0, jnp.maximum(n, 1)))(jnp.arange(steps))

    return torch.from_numpy(np.array(jax.vmap(one)(jnp.asarray(uids, jnp.int32),
                                                   jnp.asarray(num_samples, jnp.int32))))


def _run_jax(task, registry, chaos=None):
    from olearning_sim_tpu.engine.task_bridge import build_runner_from_taskconfig as jbuild
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu.resilience import faults as jfaults
    from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo as JRepo

    repo = JRepo()
    runner = jbuild(task, plan=make_mesh_plan(devices=jax.devices()[:1]),
                    task_repo=repo, registry=registry)
    task_id = task["task_id"]
    state = runner.core.init_state(jax.random.key(zlib.crc32(task_id.encode()) & 0x7FFFFFFF))
    runner.states["data_0"] = state
    init = (params_from_jax(jax.tree.map(np.asarray, state.params)),
            np.asarray(jax.random.key_data(state.base_key)))
    with jfaults.chaos(jfaults.FaultPlan.from_dict(chaos)) if chaos else nullcontext():
        history = runner.run()
    return runner, repo, history, init


def _run_port(task, registry, init=None, chaos=None):
    repo = TaskTableRepo()
    runner = build_runner_from_taskconfig(task, task_repo=repo, registry=registry,
                                          device="cpu")
    if init is not None:
        params, key_data = init
        core = runner.core
        runner.states["data_0"] = core.init_state(device="cpu", params=params)
        step = core.round_step

        def round_step_with_jax_draws(state, ds, **kw):
            args = (key_data, ds.client_uid, ds.num_samples, state.round_idx,
                    core.config.max_local_steps, core.config.batch_size)
            kw["indices"] = _jax_indices(*args)
            if core.algorithm.personalized:
                kw["personal_indices"] = _jax_indices(*args, salt=PERSONAL_SALT)
            return step(state, ds, **kw)

        core.round_step = round_step_with_jax_draws
    with tfaults.chaos(tfaults.FaultPlan.from_dict(chaos)) if chaos else nullcontext():
        history = runner.run()
    return runner, repo, history


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(v) for v in tree]
    return None


def _series(registry, task_id):
    """Counter and gauge series of one task (the compile gauge is a time)."""
    out = {}
    for m in registry.metrics():
        if m.kind == "histogram" or m.name == "ols_engine_compile_duration_seconds":
            continue
        for key, child in m.children():
            labels = dict(zip(m.label_names, key))
            if labels.get("task_id") == task_id:
                labels.pop("task_id")
                out[(m.name, tuple(sorted(labels.items())))] = child.value
    return out


def _phase_counts(registry, task_id):
    m = registry.get("ols_engine_round_phase_duration_seconds")
    return {key[1:]: child.count for key, child in m.children() if key[0] == task_id}


ROUND_BEGIN_ONCE = {"seed": 0, "specs": [{"point": "runner.round_begin", "rounds": [1]}]}
POISON = {"seed": 0, "specs": [{"point": "runner.poison_clients", "rounds": [0],
                                "error": "nan", "payload": {"clients": [1, 5, 8]}}]}
CASES = {
    "clean": (None, None),
    "retry": ({"failure_policy": "retry"}, ROUND_BEGIN_ONCE),
    "skip_round": ({"failure_policy": "skip_round"}, ROUND_BEGIN_ONCE),
    "poison_quarantine": ({"failure_policy": "retry", "quarantine_after": 1,
                           "readmit_after": 2}, POISON),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_task_matches_jax(case):
    from olearning_sim_tpu.telemetry import MetricsRegistry

    resilience, chaos = CASES[case]
    registry = MetricsRegistry()
    jtask = task_json(f"parity_{case}_jax", resilience=resilience)
    ttask = task_json(f"parity_{case}_port", resilience=resilience)
    jrunner, jrepo, jhist, init = _run_jax(jtask, registry, chaos)
    trunner, trepo, thist = _run_port(ttask, registry, init, chaos)

    jid, tid = jtask["task_id"], ttask["task_id"]
    for col in ("logical_target", "logical_result", "logical_round", "logical_operator"):
        assert trepo.get_item_value(tid, col) == jrepo.get_item_value(jid, col), col
    assert _keys(thist) == _keys(jhist)
    jres = json.loads(jrepo.get_item_value(jid, "resilience") or '{"counters": {}}')
    tres = json.loads(trepo.get_item_value(tid, "resilience") or '{"counters": {}}')
    assert tres["counters"] == jres["counters"]
    assert ([e["kind"] for e in tres.get("recent_events", [])]
            == [e["kind"] for e in jres.get("recent_events", [])])
    assert _series(registry, tid) == _series(registry, jid)
    assert _phase_counts(registry, tid) == _phase_counts(registry, jid)
    for jr, tr in zip(jhist, thist):
        assert tr.get("quarantine_state") == jr.get("quarantine_state")
        if jr.get("skipped"):
            assert tr["error"] == jr["error"]
            continue
        j, t = jr["train"]["data_0"], tr["train"]["data_0"]
        for k in ("released", "dropped", "clients_trained", "sim_duration_s"):
            assert t[k] == j[k], (jr["round"], k)
        assert abs(t["mean_loss"] - j["mean_loss"]) <= LOSS_ATOL
        je, te = jr["evaluate"]["data_0"], tr["evaluate"]["data_0"]
        assert abs(te["eval_loss"] - je["eval_loss"]) <= LOSS_ATOL
        assert abs(te["eval_acc"] - je["eval_acc"]) <= ACC_ATOL
    assert 0 < thist[0]["train"]["data_0"]["dropped"]
    jparams = params_from_jax(jax.tree.map(np.asarray, jrunner.states["data_0"].params))
    for k, v in jparams.items():
        np.testing.assert_allclose(trunner.states["data_0"].params[k].numpy(), v.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
    if case == "retry":
        assert tres["counters"]["rollback"] == 1
    if case == "poison_quarantine":
        quarantined = {int(c) for c in thist[-1]["quarantine_state"]["data_0"]["total"]}
        assert quarantined and quarantined <= {1, 5, 8}
        assert all(torch.isfinite(v).all() for v in trunner.states["data_0"].params.values())


def test_poisoned_clients_fail_in_accounting():
    """Every client released: the three poisoned ones come back non-finite in
    round 0, are quarantined, and the train operator's accounting reports
    them failed while the global params stay finite."""
    task = task_json("poison_accounting", resilience={"failure_policy": "retry"},
                     strategy=None, evaluate=False)
    runner, repo, history = _run_port(task, registry=None, chaos=POISON)
    assert [h["train"]["data_0"]["clients_trained"] for h in history] == [9, 9, 9]
    sim = json.loads(repo.get_item_value("poison_accounting", "logical_result"))[
        "logical_result"][0]["simulation_target"]
    assert sim["failed_num"] == [2, 1] and sim["success_num"] == [4, 5]
    assert all(torch.isfinite(v).all() for v in runner.states["data_0"].params.values())


def _rel_l2(a, b):
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in a)
    den = sum(float((b[k] ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def test_retried_round_equals_clean_run():
    """The snapshot clones the state's tensors and restores the round
    counter the minibatch draws are seeded from: a retried round replays the
    clean run's minibatches."""
    runs = []
    for chaos in (None, ROUND_BEGIN_ONCE, {"seed": 0, "specs": [
            {"point": "runner.pre_checkpoint", "rounds": [1], "error": "preempt"}]}):
        task = task_json("retry_generator", resilience={"failure_policy": "retry"})
        runner, _, history = _run_port(task, registry=None, chaos=chaos)
        runs.append((runner.states["data_0"].params, history))
    clean = runs[0][0]
    for params, history in runs[1:]:
        assert len(history) == 3
        assert _rel_l2(params, clean) <= RETRY_REL
    # The check has teeth: a run whose round 1 draws other minibatches
    # (what a round counter left one ahead gives) lands far from the clean
    # run.
    task = task_json("retry_generator", resilience={"failure_policy": "retry"})
    runner = build_runner_from_taskconfig(task, device="cpu")
    runner.begin()
    runner.step()
    state = runner.states["data_0"]
    runner.states["data_0"] = dataclasses.replace(state, round_idx=state.round_idx + 1)
    while runner.step():
        pass
    assert _rel_l2(runner.states["data_0"].params, clean) > 100 * RETRY_REL


def test_copy_tree_is_deep():
    from olearning_sim_tpu_torch.engine.fedcore import ServerState
    from olearning_sim_tpu_torch.engine.runner import _copy_tree

    state = ServerState(params={"w": torch.ones(3)}, opt_state={"mu": {"w": torch.zeros(3)}},
                        round_idx=2, seed=7)
    tree = {"s": state, "b": [torch.zeros(2), 4]}
    snap = _copy_tree(tree)
    state.params["w"].add_(1)
    state.opt_state["mu"]["w"].add_(1)
    tree["b"][0].add_(1)
    assert torch.equal(snap["s"].params["w"], torch.ones(3))
    assert torch.equal(snap["s"].opt_state["mu"]["w"], torch.zeros(3))
    assert torch.equal(snap["b"][0], torch.zeros(2)) and snap["b"][1] == 4
    assert (snap["s"].round_idx, snap["s"].seed) == (2, 7)


def test_draws_are_a_function_of_seed_and_round():
    """The state hands no generator on: a round's minibatch indices come
    from (seed, round_idx, stream) alone, so a state rebuilt from a
    checkpoint or a model file draws what the original drew."""
    task = task_json("draws")
    core = build_runner_from_taskconfig(task, device="cpu").core
    ns = torch.tensor([5, 8, 1, 3])
    state = core.init_state(seed=11, device="cpu")

    def draw(st, stream=0):
        return core.draw_indices(core.round_generator(st, stream), ns)

    again = dataclasses.replace(state, params={})
    assert torch.equal(draw(state), draw(again))
    later = dataclasses.replace(state, round_idx=1)
    assert not torch.equal(draw(state), draw(later))
    assert not torch.equal(draw(state), draw(state, stream=1))
    assert not torch.equal(draw(state), draw(dataclasses.replace(state, seed=12)))


@pytest.mark.parametrize("mode", ["label_flip", "sign_flip"])
def test_attack_is_scoped_to_its_round(mode):
    """An attack armed for round 1 changes that round's training only: the
    train launch of round 1 sees flipped labels (label_flip) or a delta
    multiplier (sign_flip) for the drawn clients; rounds 0 and 2, every
    round's eval operator and the population's dataset see clean labels;
    and round 0 equals a clean run's."""
    seen, evals = [], []

    def run(task_id, chaos):
        runner = build_runner_from_taskconfig(task_json(task_id, strategy=None),
                                              device="cpu")
        step = runner.core.round_step

        def spy(state, ds, **kw):
            seen.append((ds.y.clone(), kw.get("attack_scale")))
            return step(state, ds, **kw)

        runner.core.round_step = spy
        run_eval = runner._run_eval

        def eval_spy(p):
            evals.append(p.dataset.y.clone())
            return run_eval(p)

        runner._run_eval = eval_spy
        with tfaults.chaos(tfaults.FaultPlan.from_dict(chaos)):
            return runner, runner.run()

    attack = {"seed": 5, "specs": [{"point": "runner.attack_clients", "rounds": [1],
                                    "payload": {"mode": mode, "fraction": 0.25}}]}
    runner, history = run("scoped", attack)
    launches, seen[:] = list(seen), []
    _, clean = run("scoped", {"seed": 5, "specs": []})
    clean_y = runner.populations[0].dataset.y
    assert torch.equal(clean_y, seen[0][0])
    assert [h["train"]["data_0"].get("attacked") for h in history] == [None, 3, None]
    # ceil(0.25 * 12) clients drawn from (plan seed, round, population).
    drawn = sorted(np.random.default_rng([5, 1, zlib.crc32(b"data_0")]).choice(
        12, size=3, replace=False).tolist())
    for r, (y, scale) in enumerate(launches):
        attacked = r == 1
        changed = torch.nonzero((y != clean_y).any(dim=1)).flatten().tolist()
        if mode == "label_flip":
            assert changed == (drawn if attacked else [])
            assert scale is None
        else:
            assert changed == [] and (scale is not None) == attacked
            if attacked:
                assert torch.nonzero(scale == -1).flatten().tolist() == drawn
    losses = [h["train"]["data_0"]["mean_loss"] for h in history]
    clean_losses = [h["train"]["data_0"]["mean_loss"] for h in clean]
    # Round 1 trained on other labels (label_flip) or shipped other deltas
    # (sign_flip, whose local losses are the clean ones): the model round 2
    # starts from is not the clean run's.
    assert losses[0] == clean_losses[0] and losses[2] != clean_losses[2]
    assert (losses[1] != clean_losses[1]) == (mode == "label_flip")
    # The eval operator of every round, the attacked one included, ran with
    # the population's clean labels in place.
    assert len(evals) == 6 and all(torch.equal(y, clean_y) for y in evals)


def test_poison_leaves_token_features_alone():
    ds = make_synthetic_dataset(0, 4, 3, (5,), 3).pad_for(4).to("cpu")
    tokens = copy.copy(ds)
    tokens.x = torch.zeros(4, 3, 5, dtype=torch.int32)
    cfg = FedCoreConfig(batch_size=2, max_local_steps=1, block_clients=4)
    core = build_fedcore("mlp2", fedavg(0.1), cfg, model_overrides={"hidden": (4,),
                         "num_classes": 3}, input_shape=(5,), device="cpu")
    pops = [DataPopulation("f", ds, ["hpc"], np.zeros(4, int), [4], [0]),
            DataPopulation("i", tokens, ["hpc"], np.zeros(4, int), [4], [0])]
    runner = SimulationRunner("poison", core, pops, [OperatorSpec("train")], 1)
    plan = tfaults.FaultPlan([tfaults.FaultSpec(point="runner.poison_clients",
                                                payload={"clients": [2]})])
    with tfaults.chaos(plan):
        runner._maybe_poison(0)
    assert torch.isnan(pops[0].dataset.x[2].float()).all()
    assert not torch.isnan(pops[0].dataset.x[[0, 1, 3]].float()).any()
    assert not torch.isnan(ds.x.float()).any()  # a clone was written
    assert pops[1].dataset is tokens
