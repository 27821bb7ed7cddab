"""The port's tensor-parallel round over gloo ranks, against the JAX engine at
mp 2 (four of conftest's eight virtual CPU devices, dp 2 x mp 2) on the same
inputs:

- the sync round at mp 2, at dp 1 (two ranks) and dp 2 (four ranks):
  FedAvg, FedAdam, FedProx, SCAFFOLD (client and server controls), Ditto
  (personal params and ``evaluate_personal``), deadline + attack + clip,
  and the sharded server update over dp * mp coordinates;
- a flash ``evaluate`` at mp 2 (the attention whole on every rank, the FFN
  split) against JAX's flash evaluate of the same parameters in interpret
  mode at mp 2;
- ``sharded_fraction`` of every registry family at mp 2 and 4 against
  JAX's; the plan and the round's refusals against JAX's;
- a resume of an mp-2 task bitwise its uninterrupted run.

f32 compute on both sides (``dtype`` overridden, as
tests/test_torch_fedcore.py holds its DistilBERT rounds): each path holds
JAX to that file's tolerances, because only the order of summation differs
(the split products, the sums over mp, the psum over dp). FedAdam also runs
in bf16, as ``fedadam_sent140_distilbert_mp2`` computes (the partial sums
that the mp reduction adds are bf16): the port's bf16 round at mp 2 is held
by its distance from JAX's f32 round at mp 2 against JAX's own bf16
distance, at most BF16_NOISE_RATIO times it (tests/test_torch_vit.py's
rule). Within the port,
mp 2 equals mp 1 up to summation order, and every rank returns the same
values. JAX's result at mp 2 is the same function at any dp; one JAX run
at dp 2 x mp 2 per case is the reference for both port runs.

The ranks run once per world size for the module (tests/test_torch_dp.py's
:func:`run_ranks`); this module imports torch and numpy only at its top,
so the children never import JAX. Every population is 14 clients padded to
16 (blocks of 4), alike at dp 1 and dp 2."""

import contextlib
import json

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_dp import one_thread, run_ranks

MP = 2
TEXT = dict(vocab_size=128, max_len=8, width=32, depth=2, heads=4, mlp_dim=64,
            num_classes=2)
SEQ = 8
N_LOCAL, BATCH, K, BLOCK = 6, 4, 2, 4
NUM, PADDED = 14, 16
ROUNDS = 2
STEPS = np.array([2, 1, 0, 2, 2, 2, 1, 2, 2, 2, 2, 1, 2, 2, 2, 2], np.int32)
PART = np.array([1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 0, 1, 1, 0, 0], np.float32)
COMPLETION = np.array([0.4, 2.5, 0.1, 1.9, 0.3, 0.2, 3.0, 0.9, 1.1, 0.5, 2.2, np.inf,
                       0.7, 2.4, np.inf, np.inf], np.float32)
DEADLINE = 2.0
ATTACK = np.array([1, -1, 1, 1, 1, 8, 1, 1, -3, 1, 1, 1, 1, 1, 1, 1], np.float32)
SALT = 0x0D1770
EVAL_N = 12

CASES = {
    "fedavg": {},
    "fedadam": {"algorithm": "fedadam"},
    "fedprox": {"algorithm": "fedprox"},
    "scaffold": {"algorithm": "scaffold"},
    "ditto": {"algorithm": "ditto"},
    "clip": {"deadline": True, "attack": True, "clip": True},
    "sharded": {"algorithm": "fedadam", "shard": True},
}
# f32 on both sides (tests/test_torch_fedcore.py's DistilBERT tolerances).
PARAM_ATOL, PARAM_RTOL = 2e-6, 1e-5
LOSS_ATOL = 1e-5
LR = 0.05
# SCAFFOLD's client control is -c - delta / (steps * lr): a delta's error
# reaches it multiplied by 1 / (steps * lr), at most 1 / LR (one step).
CONTROL_ATOL = PARAM_ATOL / LR
# bf16 compute, held against the f32 case of the same algorithm.
BF16_CASES = {"fedadam_bf16": {"algorithm": "fedadam", "dtype": "bf16", "f32": "fedadam"}}
ALL_CASES = {**CASES, **BF16_CASES}
BF16_NOISE_RATIO = 1.3


# --------------------------------------------------------------- the port
def _algorithm(mod, name):
    if name == "ditto":
        return mod.ditto(LR, lam=0.3)
    if name == "fedprox":
        return mod.fedprox(LR, mu=0.5)
    return getattr(mod, name)(LR)


def _population():
    from olearning_sim_tpu_torch.engine.client_data import make_synthetic_text_dataset

    return make_synthetic_text_dataset(5, NUM, N_LOCAL, SEQ, vocab_size=TEXT["vocab_size"],
                                       dirichlet_alpha=0.5, num_samples_range=(3, N_LOCAL))


def _tcore(spec, plan, microbatches=None, **over):
    from olearning_sim_tpu_torch.engine import algorithms as talg
    from olearning_sim_tpu_torch.engine import fedcore as tfc

    return tfc.build_fedcore(
        "distilbert", _algorithm(talg, spec.get("algorithm", "fedavg")),
        tfc.FedCoreConfig(batch_size=spec.get("batch", BATCH), max_local_steps=K,
                          block_clients=BLOCK,
                          shard_server_update=spec.get("shard", False)),
        model_overrides={**TEXT, "dtype": {"bf16": torch.bfloat16}.get(
            spec.get("dtype"), torch.float32), **over}, input_shape=(SEQ,),
        device="cpu", plan=plan, microbatches=microbatches)


def _kwargs(spec, inp, case):
    from olearning_sim_tpu_torch.engine import defense as tdef

    kw = {"num_steps": torch.from_numpy(STEPS), "participate": torch.from_numpy(PART)}
    if spec.get("deadline"):
        kw.update(completion_time=torch.from_numpy(COMPLETION), deadline=DEADLINE)
    if spec.get("attack"):
        kw["attack_scale"] = torch.from_numpy(ATTACK)
    if spec.get("clip"):
        kw["defense"] = tdef.DefenseConfig(clip_norm=float(inp[f"clip/{case}"]))
    return kw


def _params(inp, prefix="p/"):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in inp.items() if k.startswith(prefix)}


def run_case(case, inp, plan):
    """Two rounds of ``case`` on this rank of ``plan`` from JAX's init
    params and draws; every result as numpy, whole."""
    spec = ALL_CASES[case]
    core = _tcore(spec, plan)
    ds = _population().pad_for(plan.dp * BLOCK).shard(plan).to("cpu")
    state = core.init_state(device="cpu", params=_params(inp))
    kw = _kwargs(spec, inp, case)
    alg = spec.get("algorithm", "fedavg")
    personal = core.init_personal(state, ds.num_clients) if alg == "ditto" else None
    control = core.init_control(state, ds.num_clients) if alg == "scaffold" else None
    out = {}
    for r in range(ROUNDS):
        idx = torch.from_numpy(inp[f"idx/{r}"])
        if personal is not None:
            state, m, personal = core.round_step(state, ds, personal=personal, indices=idx,
                                                 personal_indices=torch.from_numpy(
                                                     inp[f"pidx/{r}"]), **kw)
        elif control is not None:
            state, m, control = core.round_step(state, ds, control=control, indices=idx, **kw)
        else:
            state, m = core.round_step(state, ds, indices=idx, **kw)
        for k, v in state.params.items():
            out[f"{r}/p/{k}"] = v.numpy()
        for f in ("mean_loss", "weight_sum", "clients_trained", "client_loss",
                  "personal_loss", "stragglers", "clipped"):
            out[f"{r}/m/{f}"] = getattr(m, f).numpy()
    for f, v in core.full_opt_state(state.opt_state).items():
        if isinstance(v, dict):
            out.update({f"opt/{f}/{k}": t.numpy() for k, t in v.items()})
    if personal is not None:
        for k, v in core.gather_clients(personal).params.items():
            out[f"personal/{k}"] = v.float().numpy()
        out["personal_eval"] = np.array(core.evaluate_personal(personal, ds))
    if control is not None:
        ctl = core.gather_clients(control)
        out.update({f"ci/{k}": v.numpy() for k, v in ctl.client_controls.items()})
        out.update({f"c/{k}": v.numpy() for k, v in ctl.server_control.items()})
    return out


def run_flash_eval(inp, plan):
    """The flash model's evaluate at ``plan`` from JAX's flash params."""
    from olearning_sim_tpu_torch.engine.client_data import make_central_text_eval_set

    core = _tcore({}, plan, attention_impl="flash")
    x, y = make_central_text_eval_set(4, EVAL_N, SEQ, vocab_size=TEXT["vocab_size"])
    x[3, 5:] = 0
    return np.array(core.evaluate(_params(inp, "flash/"), x, y))


def run_resume(inp):
    """An mp-2 task preempted at round 2 and resumed, and the same task run
    straight: every tensor of the final state, whole, and the histories."""
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.resilience import HostPreemption
    from olearning_sim_tpu_torch.resilience import faults as tfaults

    task = json.loads(str(inp["resume_task"]))
    # The same task (its id seeds the dispatch draws) in its own directory.
    straight_task = json.loads(str(inp["resume_task"]).replace("/resumed/", "/straight/"))
    straight = build_runner_from_taskconfig(straight_task, device="cpu")
    straight.run()
    first = build_runner_from_taskconfig(task, device="cpu")
    preempt = {"point": "runner.round_begin", "rounds": [2], "error": "preempt"}
    with tfaults.chaos(tfaults.FaultPlan.from_dict({"seed": 1, "specs": [preempt]})):
        with contextlib.suppress(HostPreemption):
            first.run()
    first.checkpointer.wait()
    resumed = build_runner_from_taskconfig(task, device="cpu")
    resumed.begin()
    out = {"resumed_at": np.asarray(resumed._loop["round_idx"]),
           "mp": np.asarray(resumed.core.mp)}
    while resumed.step():
        pass
    resumed.finish()
    for name, run in (("straight", straight), ("resumed", resumed)):
        st = run._full_states()["data_0"]
        out.update({f"{name}/p/{k}": v.numpy() for k, v in st.params.items()})
        out.update({f"{name}/opt/{f}/{k}": t.numpy() for f, v in st.opt_state.items()
                    if isinstance(v, dict) for k, t in v.items()})
        out[f"{name}/history"] = np.array(json.dumps(run.history, sort_keys=True,
                                                     default=float))
    return out


def _tp_job(rank, world, inp):
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    plan = make_mesh_plan(mp=MP)
    assert plan.mp == MP and plan.dp == world // MP and plan.mp_group is not None
    out = {}
    for case in ALL_CASES:
        out.update({f"{case}/{k}": v for k, v in run_case(case, inp, plan).items()})
    out["flash"] = run_flash_eval(inp, plan)
    if world == MP:
        out.update({f"resume/{k}": v for k, v in run_resume(inp).items()})
    return out


def _bridge_job(rank, world, inp):
    """``fedadam_sent140_distilbert_mp2``, cut to a CPU-sized task, through
    the bridge at two ranks (tests/test_torch_task_bridge.py)."""
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo

    repo = TaskTableRepo()
    runner = build_runner_from_taskconfig(json.loads(str(inp["task"])), task_repo=repo,
                                          device="cpu")
    history = runner.run()
    task_id = json.loads(str(inp["task"]))["task_id"]
    return {"history": np.array(json.dumps(history, sort_keys=True, default=float)),
            "plan": np.array([runner.core.dp, runner.core.mp]),
            "logical_round": np.asarray(repo.get_item_value(task_id, "logical_round") or -1),
            **{f"p/{k}": v.numpy() for k, v in runner.states["data_0"].params.items()}}


# ------------------------------------------------------------------ inputs
def _jax_indices(key_data, uids, num_samples, round_idx, salt=None, batch=BATCH):
    """The JAX engine's per-client minibatch draw, recomputed."""
    import jax
    import jax.numpy as jnp

    base_key = jax.random.wrap_key_data(key_data)

    def one(uid, n):
        key = jax.random.fold_in(jax.random.fold_in(base_key, uid), jnp.int32(round_idx))
        if salt is not None:
            key = jax.random.fold_in(key, salt)

        def step(i):
            return jax.random.randint(jax.random.fold_in(key, i), (batch,), 0,
                                      jnp.maximum(n, 1))

        return jax.vmap(step)(jnp.arange(K))

    return np.array(jax.vmap(one)(jnp.asarray(uids, jnp.int32),
                                  jnp.asarray(num_samples, jnp.int32)))


def _jax_core(spec, plan, microbatches=None, **over):
    import jax.numpy as jnp

    from olearning_sim_tpu.engine import algorithms as jalg
    from olearning_sim_tpu.engine import fedcore as jfc

    return jfc.build_fedcore(
        "distilbert", _algorithm(jalg, spec.get("algorithm", "fedavg")), plan,
        jfc.FedCoreConfig(batch_size=spec.get("batch", BATCH), max_local_steps=K,
                          block_clients=BLOCK,
                          shard_server_update=spec.get("shard", False)),
        model_overrides={**TEXT, "dtype": {"bf16": jnp.bfloat16}.get(
            spec.get("dtype"), jnp.float32), **over}, input_shape=(SEQ,),
        microbatches=microbatches)


def _inputs(tmp):
    import jax

    from olearning_sim_tpu.parallel.mesh import make_mesh_plan as jplan
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu_torch.weights import params_from_jax

    from test_torch_defense import _clip_between, _norms

    jcore = _jax_core({}, jplan(devices=jax.devices()[:1]))
    jstate = jcore.init_state(jax.random.key(3))
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    ds = _population().pad_for(BLOCK)
    assert ds.padded_clients == PADDED
    uids, ns = np.asarray(ds.client_uid), np.asarray(ds.num_samples)
    inp = {f"p/{k}": v.numpy() for k, v in params.items()}
    for r in range(ROUNDS):
        inp[f"idx/{r}"] = _jax_indices(key_data, uids, ns, r)
        inp[f"pidx/{r}"] = _jax_indices(key_data, uids, ns, r, salt=SALT)
    fcore = _jax_core({}, jplan(devices=jax.devices()[:1]), attention_impl="flash")
    fparams = params_from_jax(jax.tree.map(np.asarray, fcore.init_state(jax.random.key(5)).params))
    inp.update({f"flash/{k}": v.numpy() for k, v in fparams.items()})
    plan = make_mesh_plan()
    spec = dict(CASES["clip"], clip=False)
    core = _tcore(spec, plan)
    kw = _kwargs(spec, inp, "clip")
    with one_thread():
        norms = _norms(core, core.init_state(device="cpu", params=params), ds.to("cpu"),
                       torch.from_numpy(inp["idx/0"]), **kw)
    inp["clip/clip"] = np.float32(_clip_between(
        norms, PART * (COMPLETION <= DEADLINE) * (STEPS > 0)))
    inp["resume_task"] = np.array(json.dumps(resume_task(tmp)))
    return inp


def resume_task(tmp, rounds=3):
    """``fedadam_sent140_distilbert_mp2`` cut as tests/test_torch_task_bridge.py
    cuts it, with a checkpoint directory."""
    from test_torch_task_bridge import engine_params, load, set_engine_params, shrink

    task = shrink(load("fedadam_sent140_distilbert_mp2"), rounds=rounds)
    params = engine_params(task)
    params["checkpoint"] = {"directory": str(tmp / "resumed" / "{task_id}"), "max_to_keep": 5}
    return set_engine_params(task, params)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return _inputs(tmp_path_factory.mktemp("tp_resume"))


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Rank results at dp 1 x mp 2 and dp 2 x mp 2."""
    return {world: run_ranks(__name__, "_tp_job", world, inputs,
                             tmp_path_factory.mktemp(f"tp_{world}"))
            for world in (MP, 2 * MP)}


@pytest.fixture(scope="module")
def mp1(inputs):
    """Every case at mp 1 with no group, in this process, on one thread."""
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    with one_thread():
        return {case: run_case(case, inputs, make_mesh_plan()) for case in CASES}


_JAX = {}


def _jax_case(case, inputs):
    """Two rounds of ``case`` on the JAX engine at dp 2 x mp 2 (cached)."""
    if case in _JAX:
        return _JAX[case]
    import jax

    from olearning_sim_tpu.engine import client_data as jcd
    from olearning_sim_tpu.engine import defense as jdef
    from olearning_sim_tpu.parallel.mesh import global_put, make_mesh_plan
    from olearning_sim_tpu_torch.weights import params_from_jax

    spec = ALL_CASES[case]
    plan = make_mesh_plan(devices=jax.devices()[:2 * MP], mp=MP)
    jcore = _jax_core(spec, plan)
    jstate = jcore.init_state(jax.random.key(3))
    got = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    assert all(np.array_equal(v.numpy(), inputs[f"p/{k}"]) for k, v in got.items())
    host = jcd.make_synthetic_text_dataset(5, NUM, N_LOCAL, SEQ,
                                           vocab_size=TEXT["vocab_size"],
                                           dirichlet_alpha=0.5,
                                           num_samples_range=(3, N_LOCAL))

    def put(a):
        return global_put(np.asarray(a), plan.client_sharding())

    kw = {"num_steps": put(STEPS), "participate": put(PART)}
    if spec.get("deadline"):
        kw.update(completion_time=put(COMPLETION), deadline=DEADLINE)
    if spec.get("attack"):
        kw["attack_scale"] = put(ATTACK)
    if spec.get("clip"):
        kw["defense"] = jdef.DefenseConfig(clip_norm=float(inputs["clip/clip"]))
    jds = host.pad_for(plan, BLOCK).place(plan)
    name = spec.get("algorithm", "fedavg")
    per = jcore.init_personal(jstate, jds.num_clients) if name == "ditto" else None
    ctl = jcore.init_control(jstate, jds.num_clients) if name == "scaffold" else None
    out = {"state": [], "metrics": []}
    for _ in range(ROUNDS):
        if per is not None:
            jstate, jm, per = jcore.round_step(jstate, jds, personal=per, **kw)
        elif ctl is not None:
            jstate, jm, ctl = jcore.round_step(jstate, jds, control=ctl, **kw)
        else:
            jstate, jm = jcore.round_step(jstate, jds, **kw)
        out["state"].append(jax.tree.map(np.array, jstate.params))
        out["metrics"].append(jax.tree.map(np.asarray, jm))
    if per is not None:
        out["personal"] = jax.tree.map(np.asarray, per.params)
        out["personal_eval"] = jcore.evaluate_personal(per, jds)
    if ctl is not None:
        out["ci"] = jax.tree.map(np.asarray, ctl.client_controls)
        out["c"] = jax.tree.map(np.asarray, ctl.server_control)
    _JAX[case] = out
    return out


# ------------------------------------------------------------------- checks
def _tree(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _close(a, b, what, atol=PARAM_ATOL, rtol=PARAM_RTOL):
    assert set(a) == set(b), what
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k], np.float32), np.asarray(b[k], np.float32),
                                   atol=atol, rtol=rtol, err_msg=f"{what} {k}")


def _jax_flat(tree):
    import jax

    from olearning_sim_tpu_torch.weights import params_from_jax

    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _jax_per_client(tree):
    """A flax per-client tree ``[C, ...]`` in the port's names ``[C, ...]``."""
    import jax

    from olearning_sim_tpu_torch.weights import params_from_jax

    leaves = jax.tree.map(np.asarray, tree)
    n = jax.tree.leaves(leaves)[0].shape[0]
    rows = [params_from_jax(jax.tree.map(lambda a: a[c], leaves)) for c in range(n)]
    return {k: np.stack([r[k].numpy() for r in rows]) for k in rows[0]}


def _case_of(res, case):
    return {k[len(case) + 1:]: v for k, v in res.items() if k.startswith(case + "/")}


@pytest.mark.parametrize("world", [MP, 2 * MP])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mp2_round_matches_jax_mp2(case, world, ranks, inputs):
    """Every rank returns the same values, within tests/test_torch_fedcore.py's
    f32 tolerances of JAX's round at mp 2."""
    results = [_case_of(r, case) for r in ranks[world]]
    for other in results[1:]:
        assert set(other) == set(results[0])
        for k in results[0]:
            assert np.array_equal(other[k], results[0][k], equal_nan=True), k
    mine = results[0]
    ref = _jax_case(case, inputs)
    for r in range(ROUNDS):
        _close(_tree(mine, f"{r}/p/"), _jax_flat(ref["state"][r]), f"round {r} params")
        jm = ref["metrics"][r]
        tl, jl = mine[f"{r}/m/client_loss"], np.asarray(jm.client_loss)
        np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
        np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL, rtol=0)
        for f in ("mean_loss", "personal_loss"):
            np.testing.assert_allclose(mine[f"{r}/m/{f}"], np.asarray(getattr(jm, f)),
                                       atol=LOSS_ATOL, rtol=0, err_msg=f)
        for f in ("weight_sum", "clients_trained", "stragglers", "clipped"):
            assert float(mine[f"{r}/m/{f}"]) == float(getattr(jm, f)), f
    if CASES[case].get("clip"):
        assert 0 < float(mine["0/m/clipped"]) < float(mine["0/m/clients_trained"])
    if "personal" in ref:
        _close(_tree(mine, "personal/"), _jax_per_client(ref["personal"]), "personal")
        np.testing.assert_allclose(mine["personal_eval"], np.asarray(ref["personal_eval"]),
                                   atol=LOSS_ATOL, rtol=0)
    if "ci" in ref:
        _close(_tree(mine, "ci/"), _jax_per_client(ref["ci"]), "client controls",
               atol=CONTROL_ATOL)
        _close(_tree(mine, "c/"), _jax_flat(ref["c"]), "server control")


@pytest.mark.parametrize("world", [MP, 2 * MP])
@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_mp2_bf16_round_within_jax_bf16_noise(case, world, ranks, inputs):
    """The bf16 round at mp 2: every rank the same, and after each round the
    port's distance from JAX's f32 round at mp 2 at most BF16_NOISE_RATIO
    times JAX's own bf16 round's distance, each relative to JAX's f32 move
    from the shared init."""
    from test_torch_fedcore_families import _moved_gap

    results = [_case_of(r, case) for r in ranks[world]]
    for other in results[1:]:
        for k in results[0]:
            assert np.array_equal(other[k], results[0][k], equal_nan=True), k
    mine = results[0]
    bf16, f32 = _jax_case(case, inputs), _jax_case(BF16_CASES[case]["f32"], inputs)
    init = {k: torch.from_numpy(v) for k, v in _tree(inputs, "p/").items()}
    for r in range(ROUNDS):
        j32 = {k: torch.from_numpy(v) for k, v in _jax_flat(f32["state"][r]).items()}
        j16 = {k: torch.from_numpy(v) for k, v in _jax_flat(bf16["state"][r]).items()}
        t16 = {k: torch.from_numpy(v) for k, v in _tree(mine, f"{r}/p/").items()}
        g_jax, g_port = _moved_gap(j16, init, j32, init), _moved_gap(t16, init, j32, init)
        print(f"{case} world {world} round {r}: bf16 gap to JAX f32 jax {g_jax:.3e} "
              f"port {g_port:.3e} ratio {g_port / g_jax:.3f}")
        assert 0 < g_port <= BF16_NOISE_RATIO * g_jax, (r, g_port, g_jax)
        tl = mine[f"{r}/m/client_loss"]
        np.testing.assert_array_equal(np.isnan(tl),
                                      np.isnan(np.asarray(bf16["metrics"][r].client_loss)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_mp2_equals_mp1_to_summation_order(case, ranks, mp1):
    """Within the port, the round at dp 1 x mp 2 lands where the round at mp 1
    does, up to the order of summation; the sharded update's optimizer state
    too."""
    mine, ref = _case_of(ranks[MP][0], case), mp1[case]
    assert set(mine) == set(ref)
    for k in ref:
        if "client_loss" in k:
            np.testing.assert_array_equal(np.isnan(mine[k]), np.isnan(ref[k]))
        np.testing.assert_allclose(np.asarray(mine[k], np.float32),
                                   np.asarray(ref[k], np.float32),
                                   atol=CONTROL_ATOL if k.startswith("ci/") else PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)


@pytest.mark.parametrize("world", [MP, 2 * MP])
def test_flash_evaluate_at_mp2_matches_jax(world, ranks, inputs):
    """The flash model's evaluate at mp 2 (attention whole on every rank
    through the kernel's plain version on the CPU, FFN split) against JAX's
    flash evaluate of the same parameters at mp 2, in interpret mode."""
    import jax

    from olearning_sim_tpu.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu_torch.engine.client_data import make_central_text_eval_set
    from olearning_sim_tpu_torch.weights import params_to_jax

    jcore = _jax_core({}, make_mesh_plan(devices=jax.devices()[:2 * MP], mp=MP),
                      attention_impl="flash")
    x, y = make_central_text_eval_set(4, EVAL_N, SEQ, vocab_size=TEXT["vocab_size"])
    x[3, 5:] = 0
    jparams = params_to_jax(_params(inputs, "flash/"), heads=TEXT["heads"])
    jl, ja = jcore.evaluate(jparams, x, y)
    for res in ranks[world]:
        tl, ta = res["flash"]
        assert abs(tl - jl) < LOSS_ATOL and abs(ta - ja) < 1e-6


def test_mp2_resume_is_bitwise_its_uninterrupted_run(ranks):
    """An mp-2 task preempted at round 2 resumes there and lands bitwise on
    the uninterrupted run: params, the server optimizer state and the
    history, on both ranks."""
    for res in ranks[MP]:
        res = _tree(res, "resume/")
        assert int(res["resumed_at"]) == 2 and int(res["mp"]) == MP
        straight, resumed = _tree(res, "straight/"), _tree(res, "resumed/")
        assert set(straight) == set(resumed)
        for k in straight:
            if k == "history":
                assert str(straight[k]) == str(resumed[k])
            else:
                assert np.array_equal(straight[k], resumed[k]), k


# ---------------------------------------------------------- specs, refusals
FAMILIES = ["mlp2", "cnn4", "cnn4_pool", "distilbert", "resnet18", "vit_tiny", "moe_text"]


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_fraction_matches_jax(family, mp):
    """The port's layout shards exactly JAX's leaves, so the fraction of
    parameter elements on sharded leaves is JAX's, at registry defaults."""
    import jax
    import jax.numpy as jnp

    from olearning_sim_tpu.models import get_model as jget
    from olearning_sim_tpu.parallel import tp as jtp
    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.parallel import tp

    jspec = jget(family)
    jmodel = jspec.build()
    shape = (1,) + tuple(jspec.example_input_shape)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros(shape, jspec.input_dtype))["params"],
        jax.random.key(0))
    want = jtp.sharded_fraction(shapes, jtp.tp_param_specs(shapes, mp))
    with torch.device("meta"):
        model = get_model(family).build()
    tshapes = {k: v.shape for k, v in model.named_parameters()}
    got = tp.sharded_fraction(tshapes, tp.tp_param_specs(tshapes, mp,
                                                         getattr(model, "heads", None)))
    assert got == pytest.approx(want, rel=0, abs=1e-12)
    assert sum(int(np.prod(s)) for s in tshapes.values()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


def test_shards_round_trip_and_distilbert_counts():
    """shard_params slices each split leaf into mp contiguous pieces that
    concatenate back to it; full-width DistilBERT shards 42,499,584 of its
    parameters at mp 2 (7,083,264 per block)."""
    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.parallel import tp

    with torch.device("meta"):
        model = get_model("distilbert").build()
    shapes = {k: v.shape for k, v in model.named_parameters()}
    specs = tp.tp_param_specs(shapes, 2, model.heads)
    split = [k for k, d in specs.items() if d is not None]
    assert sum(int(np.prod(shapes[k])) for k in split) == 42_499_584
    assert sum(int(np.prod(shapes[k])) for k in split if k.startswith("blocks.0.")) == 7_083_264
    small = get_model("distilbert").build(**TEXT)
    params = small.init_params(torch.Generator().manual_seed(0))
    sspecs = tp.tp_param_specs({k: v.shape for k, v in params.items()}, 2, TEXT["heads"])
    parts = [tp.shard_params(params, sspecs, 2, i) for i in range(2)]
    for k, d in sspecs.items():
        whole = params[k] if d is None else torch.cat([p[k] for p in parts], dim=d)
        assert torch.equal(whole, params[k]), k


def _fake_plan(**axes):
    """A plan object at a model axis, with no groups: enough for the
    refusals, which come before any collective."""
    from olearning_sim_tpu_torch.parallel.mesh import MeshPlan

    return MeshPlan(**dict(dict(dp=1, sp=1, rank=0), **axes))


def _refusal(fn):
    with pytest.raises((ValueError, TypeError)) as e:
        fn()
    return str(e.value)


def test_plan_refusals_match_jax():
    """make_mesh_plan and ParallelConfig refuse what JAX's refuse, in its
    words; the round refuses sp and ep plans."""
    import jax

    from olearning_sim_tpu.parallel import mesh as jmesh
    from olearning_sim_tpu_torch.parallel import mesh

    one = jax.devices()[:1]
    assert _refusal(lambda: mesh.make_mesh_plan(mp=2)) == \
        _refusal(lambda: jmesh.make_mesh_plan(devices=one, mp=2))
    assert _refusal(lambda: mesh.make_mesh_plan(mp=0)) == \
        _refusal(lambda: jmesh.make_mesh_plan(devices=one, mp=0))
    for block in ({"mp": 2, "pp": 2}, {"microbatches": 2}, {"mp": 0},
                  {"pp": 2, "microbatches": 0}, {"ep": 2}):
        assert _refusal(lambda: mesh.ParallelConfig.from_dict(block)) == \
            _refusal(lambda: jmesh.ParallelConfig.from_dict(block)), block
    cfg = mesh.ParallelConfig.from_dict({"pp": 2, "microbatches": 2})
    assert cfg.enabled and cfg.matches(_fake_plan(pp=2)) and not cfg.matches(_fake_plan())


def test_mp_round_refusals_match_jax():
    """At mp 2 the round refuses a gathering defense, an async round and a
    streamed round with the JAX engine's messages."""
    import jax

    from olearning_sim_tpu.engine import async_rounds as jasync
    from olearning_sim_tpu.engine import client_data as jcd
    from olearning_sim_tpu.engine import defense as jdef
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu_torch.engine import async_rounds as tasync
    from olearning_sim_tpu_torch.engine import defense as tdef
    from olearning_sim_tpu_torch.engine.client_data import HostClientStore

    plan = make_mesh_plan(devices=jax.devices()[:MP], mp=MP)
    jcore = _jax_core({}, plan)
    jstate = jcore.init_state(jax.random.key(3))
    jds = jcd.make_synthetic_text_dataset(5, NUM, N_LOCAL, SEQ, vocab_size=128).pad_for(
        plan, BLOCK).place(plan)
    core = _tcore({}, _fake_plan(mp=MP))
    state = core.init_state(device="cpu")
    ds = _population().pad_for(BLOCK).to("cpu")
    arrival = np.linspace(0.1, 2.0, NUM).astype(np.float32)
    acfg = dict(buffer_size=4)
    pairs = [
        (lambda: jcore.round_step(jstate, jds, defense=jdef.DefenseConfig(aggregator="median")),
         lambda: core.round_step(state, ds, defense=tdef.DefenseConfig(aggregator="median"))),
        (lambda: jcore.round_step(jstate, jds, async_plan=jasync.plan_async_round(
            jasync.AsyncConfig(**acfg), arrival, np.ones(NUM, bool), PADDED)),
         lambda: core.round_step(state, ds, async_plan=tasync.plan_async_round(
             tasync.AsyncConfig(**acfg), arrival, np.ones(NUM, bool), PADDED))),
        (lambda: jcore.stream_round(jstate, jcd.HostClientStore.from_dataset(
            jcd.make_synthetic_text_dataset(5, NUM, N_LOCAL, SEQ, vocab_size=128)),
            stream_rows=8),
         lambda: core.stream_round(state, HostClientStore.from_dataset(_population()),
                                   stream_rows=8)),
    ]
    for jfn, tfn in pairs:
        assert _refusal(tfn) == _refusal(jfn)
    assert _refusal(lambda: _tcore({}, _fake_plan(sp=2))).startswith("the round runs over")


def test_bridge_refuses_a_plan_that_does_not_realize_the_block():
    """A mesh plan handed to the bridge must realize the task's ``parallel``
    block: an mp-1 plan for the mp-2 config is refused in the JAX bridge's
    words."""
    import jax

    from olearning_sim_tpu.engine.task_bridge import build_runner_from_taskconfig as jbuild
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig

    from test_torch_task_bridge import load

    task = load("fedadam_sent140_distilbert_mp2")
    want = _refusal(lambda: jbuild(task, plan=make_mesh_plan(devices=jax.devices()[:1])))
    got = _refusal(lambda: build_runner_from_taskconfig(task, device="cpu", plan=_fake_plan()))
    assert got == want and "mp=2" in got
