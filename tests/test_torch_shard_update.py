"""The sharded server update (FedCoreConfig.shard_server_update) at the
port's world of one, against the port's replicated update and against the
JAX engine's sharded update at dp 1:

- FedAvg, FedAvgM, FedAdam and FedYogi rounds: params and optimizer state
  bitwise the replicated update's (every server optimizer is elementwise),
  and within mlp2's bounds of JAX's; the optimizer state's flat padded
  layout and its sharded/whole split (Adam's count whole) equal JAX's;
- the composition with a trimmed-mean defense and with async rounds
  (tests/test_async.py's sharded async case);
- a preempted FedAdam task with the sharded update resumes bitwise, and
  equals the replicated task's params;
- a streamed population refuses it with JAX's message."""

import json

import jax
import numpy as np
import pytest
import torch

from olearning_sim_tpu.engine import algorithms as jalg
from olearning_sim_tpu.engine import async_rounds as jasync
from olearning_sim_tpu.engine import defense as jdef
from olearning_sim_tpu_torch.engine import algorithms as talg
from olearning_sim_tpu_torch.engine import async_rounds as tasync
from olearning_sim_tpu_torch.engine import defense as tdef
from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
from olearning_sim_tpu_torch.resilience import HostPreemption
from olearning_sim_tpu_torch.resilience import faults as tfaults
from olearning_sim_tpu_torch.weights import params_from_jax

import torch_threads  # noqa: F401
from test_torch_fedcore_families import (
    PARAM_ATOL,
    _compare_tree,
    _cores,
    _jax_indices,
    _plan,
    _populations,
    _put,
    _tcore,
)

ALGORITHMS = ("fedavg", "fedavgm", "fedadam", "fedyogi")
STEPS = np.array([3, 2, 0, 3, 1, 3, 3, 3], np.int32)
PART = np.array([1, 1, 1, 1, 0, 1, 1, 1], np.float32)
# The optimizer state's moments against JAX's, relative L2 per moment: they
# follow the rounds' pseudo-gradients, which carry both engines' bf16
# noise. Measured over these two rounds: 1.5e-5 to 1.2e-4 (FedAvgM's
# trace, Adam's and Yogi's mu and nu, alone, under async and under the
# trimmed mean).
MOMENT_RTOL = 1e-3


def _unflat_jax(flat_tree, jparams):
    """JAX's flat moment leaves in the port's parameter layout."""
    return params_from_jax(jax.tree.map(
        lambda f, p: np.asarray(f)[:np.asarray(p).size].reshape(np.asarray(p).shape),
        flat_tree, jparams))


def _rel(a, b):
    num = sum(float((a[k].double() - b[k].double()).pow(2).sum()) for k in b)
    den = sum(float(b[k].double().pow(2).sum()) for k in b)
    return (num / den) ** 0.5 if den else num ** 0.5


def _moment_fields(jopt):
    """The first state of JAX's optax chain (TraceState or ScaleByAdamState)
    as a dict of its fields; {} for plain SGD."""
    first = jopt[0]
    return first._asdict() if hasattr(first, "_asdict") else {}


def _same_tree(a, b, what):
    if isinstance(b, dict):
        assert set(a) == set(b), what
        for k in b:
            _same_tree(a[k], b[k], f"{what}/{k}")
    elif isinstance(b, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def _rounds(name, rounds=2, async_plan=None, defense=None):
    """``rounds`` rounds of the sharded update on both engines and of the
    port's replicated update, from JAX's init params and draws."""
    jcore, tcore, jstate, tstate = _cores("mlp2", getattr(jalg, name)(0.05),
                                          getattr(talg, name)(0.05),
                                          shard_server_update=True)
    rcore = _tcore("mlp2", getattr(talg, name)(0.05))
    rstate = rcore.init_state(device="cpu", params={k: v.clone()
                                                    for k, v in tstate.params.items()})
    jds, tds = _populations("mlp2")
    plan = _plan()
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    kw_j = {"num_steps": _put(plan, STEPS), "participate": _put(plan, PART)}
    kw_t = {"num_steps": torch.from_numpy(STEPS), "participate": torch.from_numpy(PART)}
    if defense is not None:
        kw_j["defense"] = jdef.DefenseConfig(**defense)
        kw_t["defense"] = tdef.DefenseConfig(**defense)
    jplan = tplan = None
    if async_plan is not None:
        arrival = np.linspace(2.0, 0.5, 7).astype(np.float32)
        jplan = jasync.plan_async_round(jasync.AsyncConfig(**async_plan), arrival,
                                        PART[:7] > 0, 8)
        tplan = tasync.plan_async_round(tasync.AsyncConfig(**async_plan), arrival,
                                        PART[:7] > 0, 8)
        kw_j["async_plan"], kw_t["async_plan"] = jplan, tplan
    for r in range(rounds):
        idx = _jax_indices(key_data, tds.client_uid.numpy(), tds.num_samples.numpy(), r)
        jstate = jcore.round_step(jstate, jds, **kw_j)[0]
        tstate = tcore.round_step(tstate, tds, indices=idx, **kw_t)[0]
        rstate = rcore.round_step(rstate, tds, indices=idx, **kw_t)[0]
    return jcore, tcore, jstate, tstate, rstate


def _check(jstate, tstate, rstate):
    # Bitwise the replicated update: the params, and the optimizer state
    # once reshaped to the params' layout.
    _same_tree(tstate.params, rstate.params, "params")
    for field, value in tstate.opt_state.items():
        if isinstance(value, dict):
            flat_r = {k: v.reshape(-1) for k, v in rstate.opt_state[field].items()}
            _same_tree(value, flat_r, field)
        else:
            assert int(value) == int(rstate.opt_state[field]), field
    # Within mlp2's bounds of JAX's sharded update.
    _compare_tree(tstate.params, jstate.params, PARAM_ATOL)
    jparams = jax.tree.map(np.asarray, jstate.params)
    for field, value in _moment_fields(jstate.opt_state).items():
        if field == "count":
            assert int(tstate.opt_state["count"]) == int(value)
            continue
        want = _unflat_jax(value, jparams)
        got = {k: tstate.opt_state[field][k].reshape(tstate.params[k].shape)
               for k in tstate.params}
        gap = _rel(got, want)
        assert gap <= MOMENT_RTOL, (field, gap)


@pytest.mark.parametrize("name", ALGORITHMS)
def test_sharded_update_matches_replicated_and_jax(name):
    _check(*_rounds(name)[2:])


@pytest.mark.parametrize("name", ALGORITHMS)
def test_flat_layout_and_split_match_jax(name):
    """The flat padded leaves (padding multiple dp * mp = 1) and which of
    them a world above one shards: every per-coordinate leaf, not Adam's
    step count."""
    jcore, tcore, jstate, tstate = _cores("mlp2", getattr(jalg, name)(0.05),
                                          getattr(talg, name)(0.05),
                                          shard_server_update=True)
    assert tcore._shard_pad == jcore._shard_pad == 1
    jfields = _moment_fields(jstate.opt_state)
    jsplit = _moment_fields(jcore._opt_sharded)
    assert set(tstate.opt_state) == set(jfields) == set(tcore.opt_sharded)
    n = {k: v.numel() for k, v in tstate.params.items()}
    for field, value in jfields.items():
        if field == "count":
            assert jsplit[field] is tcore.opt_sharded[field] is False
            assert tstate.opt_state[field] == int(value) == 0
            continue
        jshapes = sorted(np.asarray(v).shape for v in jax.tree.leaves(value))
        tshapes = sorted(tuple(v.shape) for v in tstate.opt_state[field].values())
        assert tshapes == jshapes == sorted((v,) for v in n.values())
        assert all(jax.tree.leaves(jsplit[field]))
        assert all(tcore.opt_sharded[field].values())
        # Initial values as JAX's (zeros, or Yogi's 1e-6).
        want = _unflat_jax(value, jax.tree.map(np.asarray, jstate.params))
        for k, v in tstate.opt_state[field].items():
            assert torch.equal(v, want[k].reshape(-1)), (field, k)
    # The replicated state keeps the params' shapes.
    rstate = _tcore("mlp2", getattr(talg, name)(0.05)).init_state(device="cpu")
    for field, value in rstate.opt_state.items():
        if isinstance(value, dict):
            assert all(v.shape == rstate.params[k].shape for k, v in value.items())


@pytest.mark.parametrize("case", ["trimmed_mean", "async", "async_median"])
def test_sharded_update_composes(case):
    kw = {
        "trimmed_mean": dict(defense={"aggregator": "trimmed_mean", "trim_fraction": 0.2}),
        "async": dict(async_plan={"buffer_size": 3, "staleness_alpha": 0.5}),
        "async_median": dict(async_plan={"buffer_size": 3, "max_staleness": 1},
                             defense={"aggregator": "median"}),
    }[case]
    _check(*_rounds("fedadam", **kw)[2:])


# ------------------------------------------------------------ the task path
def _task(task_id, shard=True, **blocks):
    from test_torch_deadline import robust_task

    task = robust_task(task_id, 4, evaluate=False, **blocks)
    op = task["operatorflow"]["operators"][0]["logical_simulation"]
    params = json.loads(op["operator_params"])
    params["algorithm"] = {"name": "fedadam", "local_lr": 0.1, "server_lr": 0.01}
    params["fedcore"]["shard_server_update"] = shard
    op["operator_params"] = json.dumps(params)
    return task


def test_sharded_task_resumes_bitwise(tmp_path):
    from test_torch_checkpoint import _assert_same_state

    straight = build_runner_from_taskconfig(_task("shard_resume"), device="cpu")
    straight.run()
    replicated = build_runner_from_taskconfig(_task("shard_resume", shard=False), device="cpu")
    replicated.run()
    _same_tree(straight.states["data_0"].params, replicated.states["data_0"].params,
               "params")
    assert all(v.dim() == 1 for v in straight.states["data_0"].opt_state["mu"].values())
    ckpt = {"directory": str(tmp_path / "{task_id}"), "every": 1}
    first = build_runner_from_taskconfig(_task("shard_resume", checkpoint=ckpt), device="cpu")
    preempt = {"point": "runner.round_begin", "rounds": [2], "error": "preempt"}
    with tfaults.chaos(tfaults.FaultPlan.from_dict({"seed": 1, "specs": [preempt]})):
        with pytest.raises(HostPreemption):
            first.run()
    first.checkpointer.wait()
    resumed = build_runner_from_taskconfig(_task("shard_resume", checkpoint=ckpt),
                                           device="cpu")
    resumed.begin()
    assert resumed._loop["round_idx"] == 2
    while resumed.step():
        pass
    resumed.finish()
    _assert_same_state(resumed, straight)


def test_streamed_sharded_task_fails_as_jax():
    from olearning_sim_tpu.engine.task_bridge import build_runner_from_taskconfig as jbuild
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan

    task = _task("shard_streamed", scenario={"stream_block_rows": 4})
    jrunner = jbuild(task, plan=make_mesh_plan(devices=jax.devices()[:1]))
    trunner = build_runner_from_taskconfig(task, device="cpu")
    with pytest.raises(ValueError) as want:
        jrunner.run()
    with pytest.raises(ValueError) as got:
        trunner.run()
    assert str(got.value) == str(want.value)
    assert "shard_server_update=true does not compose" in str(got.value)
