"""The port's runner, task bridge and resume at dp 2 over two gloo ranks,
against the JAX runner and bridge at dp 2 (two of conftest's virtual CPU
devices):

- the bridge builds its plan over every rank (dp = the world size) and
  runs one round of ``fedavg_mnist_mlp`` and ``fedavg_mnist_mlp_bf16``
  (cut as tests/test_torch_task_bridge.py cuts them) as JAX's bridge does
  at dp 2; over the same two ranks it runs ``fedadam_sent140_distilbert_mp2``
  at dp 1 x mp 2 (bf16, as the config computes), held by its distance from
  JAX's bridge at mp 2 in f32 against the distance of JAX's own bf16 run,
  at most BF16_NOISE_RATIO times it (tests/test_torch_vit.py's rule), and
  rejects ``{"parallel": {"dp": 2}}`` with JAX's message;
- a runner with a dispatch strategy and eval, a deadline runner under
  ``skip_round``, and an attacked runner under the defense and its
  quarantine loop: both ranks keep the same host records, and those equal
  the JAX runner's at dp 2 on its host outputs (the numbers within
  tests/test_torch_runner.py's tolerances);
- a runner with an external fail-odd operator (tests/test_torch_operators.py's):
  each client's code runs once a round over the two ranks, as under the
  JAX runner, and both ranks count what JAX counts;
- a preempted sharded FedAdam task and a preempted Ditto task resume at dp
  2 bitwise to the uninterrupted dp-2 run; the checkpoint holds the
  optimizer state in its full flat padded layout and the personal state
  over the whole population, as JAX's does at dp 2;
- a sharded checkpoint written at dp 1 whose padding differs at dp 2 (a
  leaf of 15 coordinates) is unreadable there: every step falls back and
  the task starts at round 0, as the JAX checkpointer's restore does.

The port is handed the JAX runner's init params and its minibatch draws
(tests/test_torch_runner.py's wrapper of ``core.round_step``); the ranks
run once for the module through tests/test_torch_dp.py's harness, and
this module imports no JAX at its top, so the children never do."""

import collections
import contextlib
import json
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_dp import DP, run_ranks

ROUNDS = {"clean": 2, "deadline": 3, "attack": 3, "bridge_mlp": 1, "bridge_bf16": 1,
          "external": 2, "resume_sharded": 4, "resume_ditto": 3}
PREEMPT_AT = 2
PERSONAL_SALT = 0x0D1770
BF16_NOISE_RATIO = 1.3


# ------------------------------------------------------------ tasks (parent)
def _tasks(tmp):
    """Every case's task JSON and chaos plan, made by the existing tests'
    task functions (the children receive them as JSON: they import no
    JAX)."""
    from test_torch_deadline import DEADLINE, robust_task
    from test_torch_defense import ATTACKS
    from test_torch_operators import _code_dir, _with_external
    from test_torch_runner import task_json
    from test_torch_task_bridge import load, shrink

    def algorithm(task, alg, shard=False):
        op = task["operatorflow"]["operators"][0]["logical_simulation"]
        params = json.loads(op["operator_params"])
        params["algorithm"] = alg
        params["fedcore"]["shard_server_update"] = shard
        op["operator_params"] = json.dumps(params)
        return task

    payload, defense = ATTACKS["scale"]
    ckpt = {"directory": str(tmp / "{task_id}"), "every": 1}
    fedadam = {"name": "fedadam", "local_lr": 0.1, "server_lr": 0.01}
    ditto = {"name": "ditto", "local_lr": 0.1, "lam": 0.3}
    external = _with_external(task_json("dp_external", rounds=ROUNDS["external"]),
                              _code_dir(tmp, "olearning_sim_tpu_torch"))
    (tmp / "marks").mkdir()
    external["operatorflow"]["operators"][1]["logical_simulation"]["operator_params"] = \
        json.dumps({"mark": str(tmp / "marks")})
    return {
        "clean": (task_json("dp_clean", rounds=ROUNDS["clean"]), None),
        "deadline": (robust_task("dp_deadline", ROUNDS["deadline"],
                                 {"failure_policy": "skip_round"}, deadline=DEADLINE), None),
        "attack": (robust_task("dp_attack", ROUNDS["attack"], {"failure_policy": "retry"},
                               defense=defense),
                   {"seed": 3, "specs": [{"point": "runner.attack_clients", "times": -1,
                                          "payload": payload}]}),
        "bridge_mlp": (shrink(load("fedavg_mnist_mlp")), None),
        "bridge_bf16": (shrink(load("fedavg_mnist_mlp_bf16")), None),
        "external": (external, None),
        "resume_sharded": (algorithm(robust_task("dp_resume_sharded", ROUNDS["resume_sharded"],
                                                 evaluate=False, checkpoint=ckpt),
                                     fedadam, shard=True), None),
        "resume_ditto": (algorithm(robust_task("dp_resume_ditto", ROUNDS["resume_ditto"],
                                               evaluate=False, checkpoint=ckpt), ditto),
                         None),
    }


def _jax_run(task, chaos, mp=1):
    """The JAX runner (or bridge) on two devices, at dp 2 (or dp 1 x mp 2);
    its init params and key, and the minibatch draws of every round for the
    whole padded population."""
    import zlib

    import jax

    from olearning_sim_tpu.engine.task_bridge import build_runner_from_taskconfig as jbuild
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu.resilience import faults as jfaults
    from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo as JRepo
    from olearning_sim_tpu_torch.weights import params_from_jax
    from test_torch_runner import _jax_indices

    task = json.loads(json.dumps(task))
    params = json.loads(task["operatorflow"]["operators"][0]["logical_simulation"]
                        ["operator_params"])
    params.pop("checkpoint", None)
    task["operatorflow"]["operators"][0]["logical_simulation"]["operator_params"] = \
        json.dumps(params)
    repo = JRepo()
    runner = jbuild(task, plan=make_mesh_plan(devices=jax.devices()[:DP], mp=mp),
                    task_repo=repo)
    state = runner.core.init_state(
        jax.random.key(zlib.crc32(task["task_id"].encode()) & 0x7FFFFFFF))
    runner.states["data_0"] = state
    key_data = np.asarray(jax.random.key_data(state.base_key))
    ds = runner.populations[0].dataset
    uids, ns = np.asarray(ds.client_uid), np.asarray(ds.num_samples)
    cfg = runner.core.config
    out = {"p0": {k: v.numpy() for k, v in
                  params_from_jax(jax.tree.map(np.asarray, state.params)).items()}}
    out["idx"] = [_jax_indices(key_data, uids, ns, r, cfg.max_local_steps,
                               cfg.batch_size).numpy() for r in range(int(runner.rounds))]
    out["pidx"] = [_jax_indices(key_data, uids, ns, r, cfg.max_local_steps, cfg.batch_size,
                                salt=PERSONAL_SALT).numpy() for r in range(int(runner.rounds))]
    with jfaults.chaos(jfaults.FaultPlan.from_dict(chaos)) if chaos else \
            contextlib.nullcontext():
        out["history"] = runner.run()
    out["repo"], out["runner"] = repo, runner
    return out


# --------------------------------------------------------- the ranks (child)
def _port_runner(task, inp, case, repo=None):
    """The port's runner of ``task`` on this rank, from the JAX runner's
    init params and with its draws."""
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig

    runner = build_runner_from_taskconfig(task, task_repo=repo, device="cpu")
    core = runner.core
    params = {k[len(case) + 4:]: torch.from_numpy(v) for k, v in inp.items()
              if k.startswith(f"{case}/p0/")}
    runner.states["data_0"] = core.init_state(device="cpu", params=params)
    step = core.round_step

    def round_step_with_jax_draws(state, ds, **kw):
        kw["indices"] = torch.from_numpy(inp[f"{case}/idx/{state.round_idx}"])
        if core.algorithm.personalized:
            kw["personal_indices"] = torch.from_numpy(inp[f"{case}/pidx/{state.round_idx}"])
        return step(state, ds, **kw)

    core.round_step = round_step_with_jax_draws
    return runner


def _dump(runner, prefix, history):
    out = {f"{prefix}/history": np.array(json.dumps(history, sort_keys=True, default=float))}
    for k, v in runner.states["data_0"].params.items():
        out[f"{prefix}/p/{k}"] = v.numpy()
    repo = runner.task_repo
    for col in ("logical_target", "logical_result", "logical_round", "logical_operator",
                "resilience"):
        out[f"{prefix}/repo/{col}"] = np.array(json.dumps(repo.get_item_value(
            runner.task_id, col)))
    return out


def _state_leaves(runner):
    """Every tensor of the runner's full state (the gathered per-client
    state and optimizer state included), as numpy."""
    out = {}
    st = runner._full_states()["data_0"]
    for k, v in st.params.items():
        out[f"params/{k}"] = v.numpy()
    for f, v in st.opt_state.items():
        if isinstance(v, dict):
            out.update({f"opt/{f}/{k}": t.numpy() for k, t in v.items()})
        else:
            out[f"opt/{f}"] = np.asarray(int(v))
    for cs in runner._full_client_states().values():
        out.update({f"personal/{k}": t.float().numpy() for k, t in cs.params.items()})
    return out


def _rescale_task(tmp, task_id):
    """A sharded FedAdam task whose hidden bias has 15 coordinates: its
    flat padded length is 15 at dp 1 and 16 at dp 2."""
    from test_torch_deadline import robust_task

    task = robust_task(task_id, 2, evaluate=False,
                       checkpoint={"directory": str(tmp / "{task_id}"), "every": 1})
    op = task["operatorflow"]["operators"][0]["logical_simulation"]
    params = json.loads(op["operator_params"])
    params["model"]["overrides"]["hidden"] = [15]
    params["algorithm"] = {"name": "fedadam", "local_lr": 0.1, "server_lr": 0.01}
    params["fedcore"]["shard_server_update"] = True
    op["operator_params"] = json.dumps(params)
    return task


def _begin_round(runner, fallback_kind, log):
    """The round ``begin()`` resumes at, and the checkpoint fallbacks it
    logged."""
    before = log.count(fallback_kind, runner.task_id)
    runner.begin()
    return runner._loop["round_idx"], log.count(fallback_kind, runner.task_id) - before


def _runner_job(rank, world, inp):
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.resilience import CHECKPOINT_FALLBACK, HostPreemption
    from olearning_sim_tpu_torch.resilience import faults as tfaults
    from olearning_sim_tpu_torch.resilience.events import global_log
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo

    out = {}
    for case in ROUNDS:
        task = json.loads(str(inp[f"{case}/task"]))
        chaos = json.loads(str(inp[f"{case}/chaos"]))
        if case.startswith("resume"):
            straight_task = json.loads(json.dumps(task))
            straight_task["task_id"] += "_straight"
            straight = _port_runner(straight_task, inp, case)
            straight.run()
            out.update({f"{case}/straight/{k}": v for k, v in _state_leaves(straight).items()})
            first = _port_runner(task, inp, case)
            preempt = {"point": "runner.round_begin", "rounds": [PREEMPT_AT],
                       "error": "preempt"}
            with tfaults.chaos(tfaults.FaultPlan.from_dict({"seed": 1, "specs": [preempt]})):
                with contextlib.suppress(HostPreemption):
                    first.run()
            first.checkpointer.wait()
            resumed = _port_runner(task, inp, case)
            resumed.begin()
            out[f"{case}/resumed_at"] = np.asarray(resumed._loop["round_idx"])
            while resumed.step():
                pass
            resumed.finish()
            out.update({f"{case}/resumed/{k}": v for k, v in _state_leaves(resumed).items()})
            out[f"{case}/history"] = np.array(json.dumps(resumed.history, sort_keys=True,
                                                         default=float))
            out[f"{case}/straight_history"] = np.array(json.dumps(
                straight.history, sort_keys=True, default=float))
            continue
        runner = _port_runner(task, inp, case, repo=TaskTableRepo())
        assert runner.core.dp == world and runner.core.dp_rank == rank
        with tfaults.chaos(tfaults.FaultPlan.from_dict(chaos)) if chaos else \
                contextlib.nullcontext():
            history = runner.run()
        out.update(_dump(runner, case, history))
    runner = build_runner_from_taskconfig(json.loads(str(inp["rescale/task"])), device="cpu")
    out["rescale/begin"] = np.array(_begin_round(runner, CHECKPOINT_FALLBACK, global_log()))
    mp2 = _port_runner(json.loads(str(inp["mp2/task"])), inp, "mp2")
    out["mp2/plan"] = np.array([mp2.core.dp, mp2.core.mp, mp2.core.mp_rank])
    out["mp2/history"] = np.array(json.dumps(mp2.run(), sort_keys=True, default=float))
    out.update({f"mp2/p/{k}": v.numpy() for k, v in mp2.states["data_0"].params.items()})
    try:
        build_runner_from_taskconfig(json.loads(str(inp["refuse/dp_key"])), device="cpu")
        out["refuse/dp_key"] = np.array("")
    except ValueError as e:
        out["refuse/dp_key"] = np.array(str(e))
    return out


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from test_torch_task_bridge import _with_params, engine_params, load, set_engine_params, shrink

    tmp = tmp_path_factory.mktemp("dp_ckpt")
    tasks = _tasks(tmp)
    inp, ref = {}, {}
    # A checkpoint of the port and one of JAX, each written at dp 1.
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig

    rescale = tmp_path_factory.mktemp("dp_rescale")
    build_runner_from_taskconfig(_rescale_task(rescale, "dp_rescale"), device="cpu").run()
    inp["rescale/task"] = np.array(json.dumps(_rescale_task(rescale, "dp_rescale")))
    ref["rescale"] = _jax_rescale(tmp_path_factory.mktemp("dp_rescale_jax"))
    for case, (task, chaos) in tasks.items():
        ref[case] = r = _jax_run(task, chaos)
        inp[f"{case}/task"] = np.array(json.dumps(task))
        inp[f"{case}/chaos"] = np.array(json.dumps(chaos))
        inp.update({f"{case}/p0/{k}": v for k, v in r["p0"].items()})
        for i, (a, b) in enumerate(zip(r["idx"], r["pidx"])):
            inp[f"{case}/idx/{i}"], inp[f"{case}/pidx/{i}"] = a, b
    # The JAX runner's operator marks apart from the ranks'.
    (tmp / "marks").rename(tmp / "marks_jax")
    (tmp / "marks").mkdir()
    ref["marks"] = tmp
    # The mp-2 config as it computes (bf16) and in f32, both on JAX's bridge
    # at mp 2 from the same init; the port runs the bf16 one.
    mp2 = shrink(load("fedadam_sent140_distilbert_mp2"))
    f32 = json.loads(json.dumps(mp2))
    params = engine_params(f32)
    params["model"]["overrides"]["dtype"] = "float32"
    ref["mp2"], ref["mp2_f32"] = _jax_run(mp2, None, mp=2), _jax_run(
        set_engine_params(f32, params), None, mp=2)
    inp["mp2/task"] = np.array(json.dumps(mp2))
    inp.update({f"mp2/p0/{k}": v for k, v in ref["mp2"]["p0"].items()})
    for i, a in enumerate(ref["mp2"]["idx"]):
        inp[f"mp2/idx/{i}"] = a
    inp["refuse/dp_key"] = np.array(json.dumps(_with_params(parallel={"dp": 2})))
    ranks = run_ranks("test_torch_dp_runner", "_runner_job", DP, inp,
                      tmp_path_factory.mktemp("dp_runner"))
    return ranks, ref


def _jax_rescale(tmp):
    """The JAX runner's answer: a dp-1 checkpoint of the same task, then a
    dp-2 runner's begin()."""
    import jax

    from olearning_sim_tpu.engine.task_bridge import build_runner_from_taskconfig as jbuild
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu.resilience import CHECKPOINT_FALLBACK
    from olearning_sim_tpu.resilience.events import global_log

    task = _rescale_task(tmp, "dp_rescale_jax")
    jbuild(task, plan=make_mesh_plan(devices=jax.devices()[:1])).run()
    runner = jbuild(task, plan=make_mesh_plan(devices=jax.devices()[:DP]))
    return _begin_round(runner, CHECKPOINT_FALLBACK, global_log())


# ------------------------------------------------------------------- checks
HOST_CASES = ("clean", "deadline", "attack", "bridge_mlp", "bridge_bf16", "external")


@pytest.mark.parametrize("case", HOST_CASES)
def test_runner_at_dp2_matches_jax_runner_at_dp2(case, setup):
    """Both ranks keep the same host records; rank 0's records, task row
    and resilience events equal the JAX runner's on its host outputs, and
    the numbers are within the runner tests' tolerances."""
    import jax

    from olearning_sim_tpu_torch.weights import params_from_jax
    from test_torch_deadline import HOST_KEYS
    from test_torch_runner import ACC_ATOL, LOSS_ATOL, PARAM_ATOL

    ranks, ref = setup
    hist = [json.loads(str(r[f"{case}/history"])) for r in ranks]
    assert hist[0] == hist[1]
    for k in [k for k in ranks[0] if k.startswith(f"{case}/p/")]:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    jhist = json.loads(json.dumps(ref[case]["history"], default=float))
    thist = hist[0]
    jrepo, jid = ref[case]["repo"], ref[case]["runner"].task_id
    for col in ("logical_target", "logical_result", "logical_round", "logical_operator"):
        assert json.loads(str(ranks[0][f"{case}/repo/{col}"])) == \
            jrepo.get_item_value(jid, col), col
    tres = json.loads(json.loads(str(ranks[0][f"{case}/repo/resilience"])) or
                      '{"counters": {}}')
    jres = json.loads(jrepo.get_item_value(jid, "resilience") or '{"counters": {}}')
    assert tres["counters"] == jres["counters"]
    assert [e["kind"] for e in tres.get("recent_events", [])] == \
        [e["kind"] for e in jres.get("recent_events", [])]
    assert [sorted(h) for h in thist] == [sorted(h) for h in jhist]
    for jr, tr in zip(jhist, thist):
        for k in ("quarantine_state", "pacing", "skipped", "error"):
            assert tr.get(k) == jr.get(k), (jr["round"], k)
        if jr.get("skipped"):
            continue
        j, t = jr["train"]["data_0"], tr["train"]["data_0"]
        assert sorted(t) == sorted(j)
        for k in HOST_KEYS:
            assert t.get(k) == j.get(k), (jr["round"], k)
        assert abs(t["mean_loss"] - j["mean_loss"]) <= LOSS_ATOL
        if "evaluate" in jr:
            je, te = jr["evaluate"]["data_0"], tr["evaluate"]["data_0"]
            assert abs(te["eval_loss"] - je["eval_loss"]) <= LOSS_ATOL
            assert abs(te["eval_acc"] - je["eval_acc"]) <= ACC_ATOL
    jparams = params_from_jax(jax.tree.map(np.asarray, ref[case]["runner"].states["data_0"]
                                           .params))
    for k, v in jparams.items():
        np.testing.assert_allclose(ranks[0][f"{case}/p/{k}"], v.numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)
    if case == "attack":
        assert set(thist[-1]["quarantine_state"]["data_0"]["total"]) == {"0", "5", "8"}
    if case == "deadline":
        assert sum(h["train"]["data_0"]["stragglers"] for h in thist if "train" in h) > 0


def test_external_operator_at_dp2_runs_each_client_once(setup):
    """An external fail-odd operator over two ranks: each rank runs every
    other client, so each client's code runs once a round (one mark per
    round and client), as under the JAX runner at dp 2; both ranks count
    JAX's 6 successes and 6 failures a round."""
    ranks, ref = setup
    jext = [h["ext"] for h in json.loads(json.dumps(ref["external"]["history"],
                                                    default=float))]
    assert jext == [{"data_0": {"success": 6, "failed": 6}}] * ROUNDS["external"]
    for r in ranks:
        assert [h["ext"] for h in json.loads(str(r["external/history"]))] == jext
    once = {f"{r}_{c}": 1 for r in range(ROUNDS["external"]) for c in range(12)}
    for marks in ("marks", "marks_jax"):
        names = os.listdir(ref["marks"] / marks)
        assert collections.Counter(n.rsplit("_", 1)[0] for n in names) == once, marks


@pytest.mark.parametrize("case", ["resume_sharded", "resume_ditto"])
def test_dp2_resume_equals_uninterrupted_dp2_bitwise(case, setup):
    """A task preempted at round 2 resumes from the round-1 step on both
    ranks and ends with the uninterrupted dp-2 run's state (the gathered
    optimizer and per-client state included) and history, bit for bit;
    that run is within the runner tests' tolerance of JAX's at dp 2."""
    import jax

    from olearning_sim_tpu_torch.weights import params_from_jax
    from test_torch_runner import PARAM_ATOL

    ranks, ref = setup
    for res in ranks:
        assert int(res[f"{case}/resumed_at"]) == PREEMPT_AT
        straight = {k[len(case) + 10:]: v for k, v in res.items()
                    if k.startswith(f"{case}/straight/")}
        resumed = {k[len(case) + 9:]: v for k, v in res.items()
                   if k.startswith(f"{case}/resumed/")}
        assert set(straight) == set(resumed) and straight
        for k in straight:
            assert np.array_equal(straight[k], resumed[k]), k
        assert json.loads(str(res[f"{case}/history"])) == \
            json.loads(str(res[f"{case}/straight_history"]))
    for k in ranks[0]:
        if k.startswith(f"{case}/resumed/"):
            assert np.array_equal(ranks[0][k], ranks[1][k]), k
    jstate = ref[case]["runner"].states["data_0"]
    for k, v in params_from_jax(jax.tree.map(np.asarray, jstate.params)).items():
        np.testing.assert_allclose(ranks[0][f"{case}/resumed/params/{k}"], v.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_checkpoint_at_dp2_holds_what_jax_holds(setup):
    """The step a dp-2 run wrote: the sharded optimizer state in its full
    flat padded layout (the shapes of JAX's state at dp 2), Adam's count
    whole, and Ditto's personal state over the whole padded population (JAX's
    PersonalState's shapes at dp 2)."""
    import jax

    ranks, ref = setup
    res = ranks[0]
    jopt = ref["resume_sharded"]["runner"].states["data_0"].opt_state[0]
    jshapes = sorted(tuple(np.shape(v)) for v in jax.tree.leaves(jopt.mu))
    tshapes = sorted(v.shape for k, v in res.items()
                     if k.startswith("resume_sharded/resumed/opt/mu/"))
    assert tshapes == jshapes and all(s[0] % DP == 0 for s in tshapes)
    assert int(res["resume_sharded/resumed/opt/count"]) == int(jopt.count)
    jper = ref["resume_ditto"]["runner"].personal_states["data_0"]
    jp = sorted(tuple(np.shape(v)) for v in jax.tree.leaves(jper.params))
    tp = sorted(tuple(v.shape[:1]) + tuple(sorted(v.shape[1:])) for k, v in res.items()
                if k.startswith("resume_ditto/resumed/personal/"))
    assert [s[0] for s in tp] == [s[0] for s in jp] and tp[0][0] % DP == 0


def test_checkpoint_from_another_dp_falls_back_as_jax(setup):
    """Both ranks find every step of the dp-1 checkpoint unreadable at dp
    2 (the sharded optimizer state's padded length differs), log one
    fallback per retained step and start at round 0, as the JAX runner does
    over its own dp-1 checkpoint."""
    ranks, ref = setup
    want = ref["rescale"]
    assert want[0] == 0 and want[1] > 0
    for res in ranks:
        assert tuple(int(v) for v in res["rescale/begin"]) == tuple(want)


def test_bridge_refusals_at_dp2(setup):
    """At two ranks the bridge runs the mp-2 config over them (dp 1 x mp 2:
    one rank per half of the model, the same history and params on both),
    and rejects a dp key with the JAX package's ParallelConfig message. The
    name stays from when the bridge refused the mp-2 config."""
    from olearning_sim_tpu.parallel.mesh import ParallelConfig as JParallel

    ranks, _ = setup
    with pytest.raises(ValueError) as want:
        JParallel.from_dict({"dp": 2})
    for rank, res in enumerate(ranks):
        assert res["mp2/plan"].tolist() == [1, 2, rank]
        assert str(res["mp2/history"]) == str(ranks[0]["mp2/history"])
        for k in ranks[0]:
            if k.startswith("mp2/p/"):
                assert np.array_equal(res[k], ranks[0][k]), k
        rec = json.loads(str(res["mp2/history"]))[0]["train"]["data_0"]
        assert np.isfinite(rec["mean_loss"]) and rec["clients_trained"] > 0
        assert str(res["refuse/dp_key"]) == str(want.value)


def test_mp2_bridge_bf16_within_jax_bf16_noise(setup):
    """The mp-2 config through the bridge at dp 1 x mp 2, from JAX's init and
    with its draws: its records' host fields equal JAX's bridge run at mp 2,
    and its params' distance from JAX's f32 run at most BF16_NOISE_RATIO
    times that of JAX's own bf16 run, each relative to JAX's f32 move."""
    import jax

    from olearning_sim_tpu_torch.weights import params_from_jax
    from test_torch_fedcore_families import _moved_gap

    ranks, ref = setup
    init = {k: torch.from_numpy(v) for k, v in ref["mp2"]["p0"].items()}
    j16, j32 = (params_from_jax(jax.tree.map(np.asarray, ref[c]["runner"].states["data_0"]
                                             .params)) for c in ("mp2", "mp2_f32"))
    t16 = {k[len("mp2/p/"):]: torch.from_numpy(v) for k, v in ranks[0].items()
           if k.startswith("mp2/p/")}
    g_jax, g_port = _moved_gap(j16, init, j32, init), _moved_gap(t16, init, j32, init)
    print(f"mp2 bridge bf16 gap to JAX f32: jax {g_jax:.3e} port {g_port:.3e} "
          f"ratio {g_port / g_jax:.3f}")
    assert 0 < g_port <= BF16_NOISE_RATIO * g_jax, (g_port, g_jax)
    t = json.loads(str(ranks[0]["mp2/history"]))[0]["train"]["data_0"]
    j = json.loads(json.dumps(ref["mp2"]["history"], default=float))[0]["train"]["data_0"]
    for k in ("released", "dropped", "clients_trained"):
        assert t[k] == j[k], k
