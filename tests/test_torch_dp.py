"""The port's round data-parallel over two gloo ranks, against the JAX engine
at dp 2 (two of conftest's eight virtual CPU devices) on the same inputs:

- sync FedAvg, FedAdam, SCAFFOLD (client and server controls) and Ditto
  (personal params, personal loss, ``evaluate_personal``);
- deadline, attack and clip; the trimmed mean with anomaly scores and the
  median (the deltas re-laid by one all_to_all);
- the sharded server update (reduce-scatter onto coordinate shards), alone
  and fed by the trimmed mean;
- async rounds, replicated and sharded, and with a median; async anomaly
  scores against the numpy oracle of tests/test_torch_async.py (the JAX
  async program does not trace with scores on this jax);
- a streamed round (each rank stages its rows of each stream block).

Each port run holds the JAX engine to the tolerance of its path's dp-1
parity test (tests/test_torch_fedcore_families.py, test_torch_defense.py,
test_torch_async.py, test_torch_shard_update.py, test_torch_streaming.py).
Exact holds within the port: the trimmed mean and the median at dp 2 equal
dp 1 bitwise (same per-client deltas at the same block size; every
coordinate's client column is sorted whole); the sharded update equals the
replicated one at dp 2 bitwise (two summands commute); the streamed round
equals the resident one at dp 2 bitwise; both ranks return the same
values; and a plan over one initialised rank equals the run with no group.

The ranks run once for the module (:func:`run_ranks`: spawn, a
``FileStore`` in a temporary directory, a hard deadline), as
tests/test_torch_ring.py runs its jobs; this module imports torch and
numpy only at its top, so the spawned children never import JAX. Every
population is 14 clients padded to 16 (blocks of 4, two per rank), alike
at dp 1 and dp 2."""

import contextlib
import importlib
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

import torch_threads  # noqa: F401

DEADLINE_S = 150
DP = 2

# tests/test_torch_fedcore_families.py's mlp2 at these sizes.
SHAPE = (784,)
OVERRIDES = dict(hidden=(32,), num_classes=10)
N_LOCAL, BATCH, K, BLOCK = 10, 4, 3, 4
NUM = 14
PADDED = 16
ROUNDS = 2
STEPS = np.array([3, 2, 0, 3, 1, 3, 3, 2, 3, 1, 3, 3, 2, 3, 3, 3], np.int32)
PART = np.array([1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 0, 1, 1, 0, 0], np.float32)
COMPLETION = np.array([0.4, 2.5, 0.1, 1.9, 0.3, 0.2, 3.0, 0.9, 1.1, 0.5, 2.2, np.inf,
                       0.7, 2.4, np.inf, np.inf], np.float32)
DEADLINE = 2.0
ATTACK = np.array([1, -1, 1, 1, 1, 8, 1, 1, -3, 1, 1, 1, 1, 1, 1, 1], np.float32)
ARRIVAL = np.array([0.4, 2.5, 0.3, 1.9, 0.3, 0.3, 3.0, 0.9, 1.1, 0.9, 2.2, 1.3, 0.6, 1.7],
                   np.float32)
SALT = 0x0D1770
STREAM_ROWS = 8

CASES = {
    "fedavg": {},
    "fedadam": {"algorithm": "fedadam"},
    "scaffold": {"algorithm": "scaffold"},
    "ditto": {"algorithm": "ditto"},
    "clip": {"deadline": True, "attack": True, "clip": True},
    "trimmed": {"attack": True, "clip": True,
                "defense": {"aggregator": "trimmed_mean", "trim_fraction": 0.2,
                            "anomaly_threshold": 3.0}},
    "median": {"deadline": True, "attack": True, "defense": {"aggregator": "median"}},
    "sharded": {"algorithm": "fedadam", "shard": True},
    "sharded_trimmed": {"algorithm": "fedadam", "shard": True, "attack": True,
                        "defense": {"aggregator": "trimmed_mean", "trim_fraction": 0.2}},
    "async": {"algorithm": "fedadam", "async": {"buffer_size": 5, "staleness_alpha": 0.7}},
    "async_sharded": {"algorithm": "fedadam", "shard": True,
                      "async": {"buffer_size": 5, "staleness_alpha": 0.7}},
    "async_median": {"attack": True, "defense": {"aggregator": "median"},
                     "async": {"buffer_size": 4, "max_staleness": 1}},
    "stream": {"deadline": True, "attack": True, "clip": True, "stream": True},
}
# The cases whose clip norm sits between two participants' delta norms.
CLIPPED = [c for c, s in CASES.items() if s.get("clip")]
# The numpy oracle's setup (tests/test_torch_async.py's ``small``).
ORACLE_CLIENTS = 16
ORACLE_COMPLETION = np.linspace(0.5, 8.0, ORACLE_CLIENTS).astype(np.float32)
ORACLE_AGGREGATORS = ("trimmed_mean", "median", "mean")


# ------------------------------------------------------------------ harness
def _worker(rank, world, store_path, module, job, in_path, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        with np.load(in_path, allow_pickle=False) as f:
            inp = {k: f[k] for k in f.files}
        res = getattr(importlib.import_module(module), job)(rank, world, inp)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def run_ranks(module, job, world, inputs, workdir, deadline_s=DEADLINE_S):
    """Run ``module.job(rank, world, inputs)`` on ``world`` gloo ranks in
    spawned processes; return each rank's result dict. Fails the test if
    the ranks are not done within ``deadline_s`` (a hang at a collective
    must not hang the suite)."""
    workdir.mkdir(parents=True, exist_ok=True)
    in_path = str(workdir / "inputs.npz")
    np.savez(in_path, **inputs)
    ctx = tmp.start_processes(
        _worker, args=(world, str(workdir / "store"), module, job, in_path, str(workdir)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"{job} on {world} gloo ranks passed its {deadline_s} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
    out = []
    for r in range(world):
        with np.load(workdir / f"rank{r}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


# --------------------------------------------------------------- the port
# Runs in the spawned ranks (a plan over the world) and in the test process
# (dp 1, or one initialised rank).

def _population():
    from olearning_sim_tpu_torch.engine.client_data import make_synthetic_dataset

    return make_synthetic_dataset(1, NUM, N_LOCAL, SHAPE, 10, dirichlet_alpha=0.5,
                                  num_samples_range=(4, 10))


def _algorithm(talg, name):
    return talg.ditto(0.05, lam=0.3) if name == "ditto" else getattr(talg, name)(0.05)


def _tcore(spec, plan):
    from olearning_sim_tpu_torch.engine import algorithms as talg
    from olearning_sim_tpu_torch.engine import fedcore as tfc

    return tfc.build_fedcore(
        "mlp2", _algorithm(talg, spec.get("algorithm", "fedavg")),
        tfc.FedCoreConfig(batch_size=BATCH, max_local_steps=K, block_clients=BLOCK,
                          shard_server_update=spec.get("shard", False)),
        model_overrides=OVERRIDES, input_shape=SHAPE, device="cpu", plan=plan)


def _kwargs(spec, inp, case):
    """The round's per-client arguments over the whole padded population."""
    from olearning_sim_tpu_torch.engine import async_rounds as tasync
    from olearning_sim_tpu_torch.engine import defense as tdef

    kw = {"num_steps": torch.from_numpy(STEPS), "participate": torch.from_numpy(PART)}
    if spec.get("deadline"):
        kw.update(completion_time=torch.from_numpy(COMPLETION), deadline=DEADLINE)
    if spec.get("attack"):
        kw["attack_scale"] = torch.from_numpy(ATTACK)
    d = dict(spec.get("defense") or {})
    if spec.get("clip"):
        d["clip_norm"] = float(inp[f"clip/{case}"])
    if d:
        kw["defense"] = tdef.DefenseConfig(**d)
    if spec.get("async"):
        kw["async_plan"] = tasync.plan_async_round(tasync.AsyncConfig(**spec["async"]),
                                                   ARRIVAL, PART[:NUM] > 0, PADDED)
    return kw


def run_case(case, inp, plan):
    """Two rounds of ``case`` on this rank of ``plan`` from the inputs' init
    params and JAX's draws; every result as numpy, over the whole
    population."""
    from olearning_sim_tpu_torch.engine.client_data import HostClientStore

    spec = CASES[case]
    core = _tcore(spec, plan)
    full = _population()
    ds = full.pad_for(plan.dp * BLOCK).shard(plan).to("cpu")
    params = {k[len("p/"):]: torch.from_numpy(v) for k, v in inp.items() if k.startswith("p/")}
    state = core.init_state(device="cpu", params=params)
    kw = _kwargs(spec, inp, case)
    alg = spec.get("algorithm", "fedavg")
    personal = core.init_personal(state, ds.num_clients) if alg == "ditto" else None
    control = core.init_control(state, ds.num_clients) if alg == "scaffold" else None
    out = {}
    for r in range(ROUNDS):
        idx = torch.from_numpy(inp[f"idx/{r}"])
        if spec.get("stream"):
            skw = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
            state, m, stats = core.stream_round(state, HostClientStore.from_dataset(full),
                                                stream_rows=STREAM_ROWS, indices=idx, **skw)
            out[f"{r}/stream_rows"] = np.array([stats.rows, stats.blocks])
        elif personal is not None:
            state, m, personal = core.round_step(state, ds, personal=personal, indices=idx,
                                                 personal_indices=torch.from_numpy(
                                                     inp[f"pidx/{r}"]), **kw)
        elif control is not None:
            state, m, control = core.round_step(state, ds, control=control, indices=idx, **kw)
        elif "async_plan" in kw:
            state, m, st = core.round_step(state, ds, indices=idx, **kw)
            for f in ("commits", "committed_weight", "dropped_stale", "buffer_fill"):
                out[f"{r}/async/{f}"] = getattr(st, f).numpy()
        else:
            state, m = core.round_step(state, ds, indices=idx, **kw)
        for k, v in state.params.items():
            out[f"{r}/p/{k}"] = v.numpy()
        for f in ("mean_loss", "weight_sum", "clients_trained", "client_loss",
                  "personal_loss", "stragglers", "anomaly_score", "clipped"):
            out[f"{r}/m/{f}"] = getattr(m, f).numpy()
    opt = core.full_opt_state(state.opt_state)
    for f, v in opt.items():
        if isinstance(v, dict):
            for k, t in v.items():
                out[f"opt/{f}/{k}"] = t.numpy()
        else:
            out[f"opt/{f}"] = np.asarray(int(v))
    if personal is not None:
        for k, v in core.gather_clients(personal).params.items():
            out[f"personal/{k}"] = v.float().numpy()
        out["personal_eval"] = np.array(core.evaluate_personal(personal, ds))
    if control is not None:
        ctl = core.gather_clients(control)
        for k, v in ctl.client_controls.items():
            out[f"ci/{k}"] = v.numpy()
        for k, v in ctl.server_control.items():
            out[f"c/{k}"] = v.numpy()
    return out


def _small(plan):
    """tests/test_torch_async.py's ``small`` oracle setup on ``plan``."""
    from olearning_sim_tpu_torch.engine import algorithms as talg
    from olearning_sim_tpu_torch.engine import fedcore as tfc
    from olearning_sim_tpu_torch.engine.client_data import make_synthetic_dataset

    core = tfc.build_fedcore(
        "mlp2", talg.fedavg(0.1),
        tfc.FedCoreConfig(batch_size=4, max_local_steps=2, block_clients=2),
        model_overrides={"hidden": (8,), "num_classes": 3}, input_shape=(8,), device="cpu",
        plan=plan)
    full = make_synthetic_dataset(7, ORACLE_CLIENTS, 6, (8,), 3, class_sep=3.0)
    return core, full.pad_for(2 * plan.dp).shard(plan).to("cpu"), core.init_state(0, device="cpu")


def run_oracle_scores(plan):
    """Async rounds with anomaly scores on the oracle's setup."""
    from olearning_sim_tpu_torch.engine import async_rounds as tasync
    from olearning_sim_tpu_torch.engine import defense as tdef

    core, ds, state = _small(plan)
    ap = tasync.plan_async_round(
        tasync.AsyncConfig(buffer_size=4, schedule="polynomial", staleness_alpha=0.7),
        ORACLE_COMPLETION, np.ones(ORACLE_CLIENTS, bool), ds.padded_clients)
    out = {}
    for aggregator in ORACLE_AGGREGATORS:
        defense = tdef.DefenseConfig(aggregator=aggregator, trim_fraction=0.25,
                                     anomaly_threshold=3.0)
        s, m, st = core.round_step(state, ds, async_plan=ap, defense=defense)
        out[f"oracle/{aggregator}/score"] = m.anomaly_score.numpy()
        out[f"oracle/{aggregator}/commits"] = st.commits.numpy()
        for k, v in s.params.items():
            out[f"oracle/{aggregator}/p/{k}"] = v.numpy()
    return out


def _engine_job(rank, world, inp):
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    plan = make_mesh_plan()
    assert plan.dp == world and plan.dp_group is not None
    out = {}
    for case in CASES:
        out.update({f"{case}/{k}": v for k, v in run_case(case, inp, plan).items()})
    out.update(run_oracle_scores(plan))
    return out


# ------------------------------------------------------------------ inputs
def _inputs():
    """JAX's init params and minibatch draws (both branches), and each
    clipped case's clip norm, chosen from the port's dp-1 round-0 norms."""
    import jax

    from olearning_sim_tpu.engine import algorithms as jalg
    from olearning_sim_tpu.engine import fedcore as jfc
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan as jplan
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu_torch.weights import params_from_jax

    from test_torch_defense import _clip_between, _norms
    from test_torch_fedcore_families import _jax_indices

    jcore = jfc.build_fedcore("mlp2", jalg.fedavg(0.05), jplan(devices=jax.devices()[:1]),
                              jfc.FedCoreConfig(batch_size=BATCH, max_local_steps=K,
                                                block_clients=BLOCK),
                              model_overrides=OVERRIDES, input_shape=SHAPE)
    jstate = jcore.init_state(jax.random.key(3))
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    ds = _population().pad_for(BLOCK)
    uids, ns = np.asarray(ds.client_uid), np.asarray(ds.num_samples)
    inp = {f"p/{k}": v.numpy() for k, v in params.items()}
    for r in range(ROUNDS):
        inp[f"idx/{r}"] = _jax_indices(key_data, uids, ns, r).numpy()
        inp[f"pidx/{r}"] = _jax_indices(key_data, uids, ns, r, salt=SALT).numpy()
    plan = make_mesh_plan()
    tds = ds.to("cpu")
    for case in CLIPPED:
        spec = dict(CASES[case], clip=False, defense=None)
        core = _tcore(spec, plan)
        kw = _kwargs(spec, inp, case)
        norms = _norms(core, core.init_state(device="cpu", params=params), tds,
                       torch.from_numpy(inp["idx/0"]), **kw)
        on_time = PART * ((COMPLETION <= DEADLINE) if spec.get("deadline") else 1)
        inp[f"clip/{case}"] = np.float32(_clip_between(norms, on_time * (STEPS > 0)))
    return inp


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_ranks(__name__, "_engine_job", DP, inputs, tmp_path_factory.mktemp("dp_engine"))


@contextlib.contextmanager
def one_thread():
    """Compute on one thread, as the ranks do: a matrix product's blocking,
    and so its bits, follows the thread count."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dp1(inputs):
    """Every case at dp 1 with no group, in this process."""
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    plan = make_mesh_plan()
    assert plan.dp == 1 and plan.dp_group is None
    with one_thread():
        return {case: run_case(case, inputs, plan) for case in CASES}


# --------------------------------------------------------------- JAX at dp 2
def _jax_case(case, inputs):
    """Two rounds of ``case`` on the JAX engine at dp 2, from the same init
    params (carried back to flax's layout) and the same populations."""
    import jax

    from olearning_sim_tpu.engine import algorithms as jalg
    from olearning_sim_tpu.engine import async_rounds as jasync
    from olearning_sim_tpu.engine import client_data as jcd
    from olearning_sim_tpu.engine import defense as jdef
    from olearning_sim_tpu.engine import fedcore as jfc
    from olearning_sim_tpu.parallel.mesh import global_put, make_mesh_plan
    from olearning_sim_tpu_torch.weights import params_from_jax

    spec = CASES[case]
    plan = make_mesh_plan(devices=jax.devices()[:DP])
    name = spec.get("algorithm", "fedavg")
    algo = jalg.ditto(0.05, lam=0.3) if name == "ditto" else getattr(jalg, name)(0.05)
    jcore = jfc.build_fedcore("mlp2", algo, plan, jfc.FedCoreConfig(
        batch_size=BATCH, max_local_steps=K, block_clients=BLOCK,
        shard_server_update=spec.get("shard", False)),
        model_overrides=OVERRIDES, input_shape=SHAPE)
    jstate = jcore.init_state(jax.random.key(3))
    want = {f"p/{k}": v.numpy()
            for k, v in params_from_jax(jax.tree.map(np.asarray, jstate.params)).items()}
    assert all(np.array_equal(want[k], inputs[k]) for k in want)
    host = jcd.make_synthetic_dataset(1, NUM, N_LOCAL, SHAPE, 10, dirichlet_alpha=0.5,
                                      num_samples_range=(4, 10))

    def put(a):
        return global_put(np.asarray(a), plan.client_sharding())

    kw = {"num_steps": put(STEPS), "participate": put(PART)}
    if spec.get("deadline"):
        kw.update(completion_time=put(COMPLETION), deadline=DEADLINE)
    if spec.get("attack"):
        kw["attack_scale"] = put(ATTACK)
    d = dict(spec.get("defense") or {})
    if spec.get("clip"):
        d["clip_norm"] = float(inputs[f"clip/{case}"])
    if d:
        kw["defense"] = jdef.DefenseConfig(**d)
    if spec.get("async"):
        kw["async_plan"] = jasync.plan_async_round(jasync.AsyncConfig(**spec["async"]),
                                                   ARRIVAL, PART[:NUM] > 0, PADDED)
    out = {"state": [], "metrics": [], "stats": []}
    if spec.get("stream"):
        store = jcd.HostClientStore.from_dataset(host)
        skw = {k: (np.asarray(v) if k in ("num_steps", "participate", "completion_time",
                                          "attack_scale") else v) for k, v in kw.items()}
        for _ in range(ROUNDS):
            jstate, jm, st = jcore.stream_round(jstate, store, stream_rows=STREAM_ROWS, **skw)
            out["state"].append(jax.tree.map(np.array, jstate.params))
            out["metrics"].append(jm)
            out["stats"].append(st)
        return out
    jds = host.pad_for(plan, BLOCK).place(plan)
    per = jcore.init_personal(jstate, jds.num_clients) if name == "ditto" else None
    ctl = jcore.init_control(jstate, jds.num_clients) if name == "scaffold" else None
    for _ in range(ROUNDS):
        if per is not None:
            jstate, jm, per = jcore.round_step(jstate, jds, personal=per, **kw)
        elif ctl is not None:
            jstate, jm, ctl = jcore.round_step(jstate, jds, control=ctl, **kw)
        elif "async_plan" in kw:
            jstate, jm, st = jcore.round_step(jstate, jds, **kw)
            out["stats"].append(st)
        else:
            jstate, jm = jcore.round_step(jstate, jds, **kw)
        out["state"].append(jax.tree.map(np.array, jstate.params))
        out["metrics"].append(jm)
    out["opt"] = jstate.opt_state
    out["jparams"] = jax.tree.map(np.asarray, jstate.params)
    if per is not None:
        out["personal"] = jax.tree.map(np.asarray, per.params)
        out["personal_eval"] = jcore.evaluate_personal(per, jds)
    if ctl is not None:
        out["ci"] = jax.tree.map(np.asarray, ctl.client_controls)
        out["c"] = jax.tree.map(np.asarray, ctl.server_control)
    return out


# ------------------------------------------------------------------- checks
def _tree(res, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in res.items()
            if k.startswith(prefix)}


def _same(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), f"{what} {k}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_dp2_matches_jax_dp2(case, ranks, inputs):
    """Both ranks return the same values, within the tolerances of the
    path's dp-1 parity test of JAX's engine at dp 2."""
    import jax

    from olearning_sim_tpu_torch.weights import params_from_jax
    from test_torch_async import SCORE_RTOL, STATS_RTOL
    from test_torch_fedcore_families import (
        LOSS_ATOL,
        PARAM_ATOL,
        _compare_per_client,
        _compare_tree,
    )
    from test_torch_shard_update import MOMENT_RTOL, _moment_fields, _rel, _unflat_jax

    spec = CASES[case]
    mine = {k[len(case) + 1:]: v for k, v in ranks[0].items() if k.startswith(case + "/")}
    other = {k[len(case) + 1:]: v for k, v in ranks[1].items() if k.startswith(case + "/")}
    _same(mine, other, "rank 1 against rank 0")
    ref = _jax_case(case, inputs)
    for r in range(ROUNDS):
        _compare_tree(_tree(mine, f"{r}/p/"), ref["state"][r], PARAM_ATOL)
        jm = ref["metrics"][r]
        jloss = np.asarray(jm.client_loss)
        tloss = mine[f"{r}/m/client_loss"]
        assert tloss.shape == jloss.shape == (PADDED,)
        np.testing.assert_array_equal(np.isnan(tloss), np.isnan(jloss))
        np.testing.assert_allclose(tloss, jloss, atol=LOSS_ATOL, rtol=0)
        for f in ("mean_loss", "personal_loss"):
            np.testing.assert_allclose(mine[f"{r}/m/{f}"], float(getattr(jm, f)),
                                       atol=LOSS_ATOL)
        for f in ("weight_sum", "clients_trained", "stragglers", "clipped"):
            assert float(mine[f"{r}/m/{f}"]) == float(getattr(jm, f)), f
        jscore = np.asarray(jm.anomaly_score)
        assert mine[f"{r}/m/anomaly_score"].shape == jscore.shape
        np.testing.assert_allclose(mine[f"{r}/m/anomaly_score"], jscore, rtol=SCORE_RTOL,
                                   atol=0)
        if spec.get("async"):
            jst = ref["stats"][r]
            assert float(mine[f"{r}/async/commits"]) == float(jst.commits)
            assert float(mine[f"{r}/async/dropped_stale"]) == float(jst.dropped_stale)
            np.testing.assert_allclose(mine[f"{r}/async/buffer_fill"],
                                       np.asarray(jst.buffer_fill), rtol=STATS_RTOL, atol=0)
        if spec.get("stream"):
            jst = ref["stats"][r]
            assert tuple(mine[f"{r}/stream_rows"]) == (jst.rows, jst.blocks)
    name = spec.get("algorithm", "fedavg")
    if name == "fedadam" and not spec.get("stream"):
        jopt = _moment_fields(ref["opt"])
        assert int(mine["opt/count"]) == int(jopt["count"])
        params = _tree(mine, f"{ROUNDS - 1}/p/")
        for f in ("mu", "nu"):
            got = {k: torch.from_numpy(mine[f"opt/{f}/{k}"].reshape(-1)[:v.numel()])
                   .reshape(v.shape) for k, v in params.items()}
            want = (_unflat_jax(jopt[f], ref["jparams"]) if spec.get("shard")
                    else params_from_jax(jax.tree.map(np.asarray, jopt[f])))
            assert _rel(got, want) <= MOMENT_RTOL, f
    if name == "scaffold":
        _compare_tree(_tree(mine, "c/"), ref["c"], PARAM_ATOL / (K * 0.05), "server control")
        _compare_per_client(_tree(mine, "ci/"), ref["ci"], PADDED, PARAM_ATOL / 0.05,
                            "client control")
    if name == "ditto":
        _compare_per_client(_tree(mine, "personal/"), ref["personal"], PADDED,
                            PARAM_ATOL + 2.0 ** -11, "personal")
        jl, ja = ref["personal_eval"]
        assert abs(mine["personal_eval"][0] - jl) < LOSS_ATOL
        assert abs(mine["personal_eval"][1] - ja) < 2e-2
    # Each case exercises what it names.
    last = f"{ROUNDS - 1}/m/"
    if spec.get("deadline"):
        assert float(mine[last + "stragglers"]) > 0
    if spec.get("clip"):
        assert 0 < float(mine[last + "clipped"]) < float(mine[last + "clients_trained"])
    if (spec.get("defense") or {}).get("anomaly_threshold"):
        assert (mine[last + "anomaly_score"] > 0).sum() == float(mine[last + "clients_trained"])


@pytest.mark.parametrize("case", ["trimmed", "median", "sharded_trimmed", "async_median"])
def test_robust_aggregates_at_dp2_equal_dp1_bitwise(case, ranks, dp1):
    """The same per-client deltas at the same block size, and every
    coordinate's client column sorted whole on the rank that owns it: the
    params equal dp 1's bit for bit."""
    for r in range(ROUNDS):
        _same(_tree({k[len(case) + 1:]: v for k, v in ranks[0].items()
                     if k.startswith(case + "/")}, f"{r}/p/"),
              _tree(dp1[case], f"{r}/p/"), f"round {r}")


@pytest.mark.parametrize("sharded,replicated", [("sharded", "fedadam"),
                                                ("async_sharded", "async")])
def test_sharded_update_equals_replicated_at_dp2_bitwise(sharded, replicated, ranks):
    """The reduce-scatter's sums are the all-reduce's (two summands
    commute), and every server optimizer is elementwise; the optimizer
    state, gathered to its flat padded layout, too."""
    res = ranks[0]
    for r in range(ROUNDS):
        _same(_tree({k: v for k, v in res.items() if k.startswith(sharded + "/")},
                    f"{sharded}/{r}/p/"),
              _tree({k: v for k, v in res.items() if k.startswith(replicated + "/")},
                    f"{replicated}/{r}/p/"), f"round {r}")
    for f in ("mu", "nu"):
        for k in _tree(res, f"{replicated}/opt/{f}/"):
            got = res[f"{sharded}/opt/{f}/{k}"]
            want = res[f"{replicated}/opt/{f}/{k}"].reshape(-1)
            assert got.shape[0] % DP == 0 and got.shape[0] >= want.shape[0]
            assert np.array_equal(got[:want.shape[0]], want), (f, k)
    assert int(res[f"{sharded}/opt/count"]) == int(res[f"{replicated}/opt/count"])


def test_streamed_equals_resident_at_dp2_bitwise(ranks):
    """Each rank stages its own rows of each stream block, so its
    accumulation chain is the resident round's."""
    res = ranks[0]
    for r in range(ROUNDS):
        _same(_tree(res, f"stream/{r}/p/"), _tree(res, f"clip/{r}/p/"), f"round {r}")
        for f in ("client_loss", "weight_sum", "stragglers", "clipped"):
            assert np.array_equal(res[f"stream/{r}/m/{f}"], res[f"clip/{r}/m/{f}"],
                                  equal_nan=True), f


@pytest.fixture(scope="module")
def oracle_deltas():
    """Per-client deltas from one-client synchronous rounds at dp 1 (the
    async engine's dispatch model: every client anchors at the round-begin
    params and draws the round's indices)."""
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    core, ds, state = _small(make_mesh_plan())
    deltas = []
    for c in range(ds.num_clients):
        onehot = torch.zeros(ds.num_clients)
        onehot[c] = 1.0
        st, _ = core.round_step(state, ds, participate=onehot)
        deltas.append({k: st.params[k].double() - state.params[k].double()
                       for k in state.params})
    return ds, state, deltas


@pytest.mark.parametrize("aggregator", ORACLE_AGGREGATORS)
def test_async_scores_at_dp2_match_numpy_oracle(aggregator, ranks, oracle_deltas):
    """tests/test_torch_async.py's oracle over the dp-1 one-client deltas:
    each window's statistic over its members and each client's score from
    its window's center, against the rounds run at dp 2."""
    from olearning_sim_tpu_torch.engine import async_rounds as tasync

    ds, state, deltas = oracle_deltas
    ap = tasync.plan_async_round(
        tasync.AsyncConfig(buffer_size=4, schedule="polynomial", staleness_alpha=0.7),
        ORACLE_COMPLETION, np.ones(ORACLE_CLIENTS, bool), ds.num_clients)
    res = ranks[0]
    assert int(res[f"oracle/{aggregator}/commits"]) == ap.num_windows
    weights = ds.weight.double().numpy()
    sw = tasync.staleness_weights("polynomial", 0.7, ap.num_windows)
    cur = {k: v.double().clone() for k, v in state.params.items()}
    want_scores = np.zeros(ds.num_clients)
    trim = 0.25
    for w in range(ap.num_windows):
        members = np.flatnonzero(ap.window == w)
        n = len(members)
        center = {}
        for k in cur:
            srt = np.sort(np.stack([deltas[c][k].numpy() for c in members]), axis=0)
            t = int(np.floor(trim * n))
            med = (srt[(n - 1) // 2] + srt[n // 2]) / 2
            center[k] = srt[t:n - t].mean(axis=0) if aggregator == "trimmed_mean" else med
            agg = center[k] if aggregator != "mean" else \
                sum(weights[c] * deltas[c][k].numpy() for c in members) / weights[members].sum()
            cur[k] = cur[k] + float(sw[w]) * torch.from_numpy(agg)
        for c in members:
            want_scores[c] = np.sqrt(sum(((deltas[c][k].numpy() - center[k]) ** 2).sum()
                                         for k in cur))
    np.testing.assert_allclose(res[f"oracle/{aggregator}/score"], want_scores, rtol=1e-5,
                               atol=0)
    for k, v in cur.items():
        np.testing.assert_allclose(res[f"oracle/{aggregator}/p/{k}"], v.numpy(), rtol=2e-5,
                                   atol=1e-6, err_msg=k)


def test_group_of_one_equals_no_group_bitwise(inputs, dp1, tmp_path):
    """A plan over one initialised gloo rank launches every collective of
    the round (psum, psum_scatter, all_gather, all_to_all), with the
    results of the run with no group, bit for bit."""
    from olearning_sim_tpu_torch.parallel import collectives
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        plan = make_mesh_plan()
        assert plan.dp == 1 and plan.dp_group is not None
        collectives.reset_bytes()
        for case in ("sharded_trimmed", "async_sharded", "trimmed", "ditto", "stream"):
            with one_thread():
                got = run_case(case, inputs, plan)
            _same(got, dp1[case], case)
        assert all(collectives.BYTES[k] > 0 for k in ("psum", "psum_scatter", "all_gather",
                                                      "all_to_all"))
    finally:
        dist.destroy_process_group()


def test_shard_layout_and_refusals():
    """A shard's rows and offsets; pad_for, take and shard refuse a shard;
    a round refuses a shard that is not this rank's, and per-client
    arguments that do not cover the whole population."""
    from olearning_sim_tpu_torch.parallel.mesh import MeshPlan, make_mesh_plan

    full = _population().pad_for(DP * BLOCK)
    parts = [full.shard(MeshPlan(dp=DP, sp=1, rank=r)) for r in range(DP)]
    assert [(p.offset, p.num_clients, p.padded_clients) for p in parts] == [(0, 8, 16),
                                                                          (8, 8, 16)]
    assert np.array_equal(np.concatenate([p.x for p in parts]), full.x)
    for fn in (lambda p: p.pad_for(4), lambda p: p.take([0]),
               lambda p: p.shard(make_mesh_plan())):
        with pytest.raises(ValueError, match="whole population"):
            fn(parts[1])
    with pytest.raises(ValueError, match="13 clients do not split over dp=2"):
        _population().take(range(13)).shard(MeshPlan(dp=DP, sp=1, rank=0))
    core = _tcore({}, make_mesh_plan())
    state = core.init_state(device="cpu")
    with pytest.raises(ValueError, match="not rank 0's shard"):
        core.round_step(state, parts[1].to("cpu"))
    with pytest.raises(ValueError, match="participate must cover the 16"):
        core.round_step(state, full.to("cpu"), participate=torch.ones(8))
