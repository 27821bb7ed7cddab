"""Block-streamed rounds in the port (``HostClientStore``,
``FedCore.stream_round``, the runner's streamed scenario path), after
tests/test_streaming.py:

- the store: padding rows are inert, lazy synthetic rows equal the JAX
  package's, per-client state arrays work;
- a streamed round of two or more stream blocks equals the port's resident
  round at the same padded size bit for bit (plain; deadline + attack +
  clip; label drift against resident labels shifted beforehand), and the
  resident round at block padding equals the streamed round at stream
  padding on the real clients, because each block's minibatch indices are
  drawn in order from the round's generator (successive draws equal one
  whole draw);
- the port's ``stream_round`` against the JAX engine's, given JAX's
  indices: params within mlp2's bounds of
  tests/test_torch_fedcore_families.py, stragglers and clipped exact;
- the refusals with the JAX engine's messages, and the nested
  ``stream_stage`` / ``stream_step`` spans;
- the streamed scenario runner and the resident drifting runner against the
  JAX runner on the same task: host outputs exact;
- a preempted streamed run and a fresh runner's resume each equal the
  uninterrupted run bitwise."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from olearning_sim_tpu.engine import algorithms as jalg
from olearning_sim_tpu.engine import client_data as jcd
from olearning_sim_tpu.engine import defense as jdef
from olearning_sim_tpu_torch.engine import algorithms as talg
from olearning_sim_tpu_torch.engine import client_data as tcd
from olearning_sim_tpu_torch.engine import defense as tdef
from olearning_sim_tpu_torch.engine import fedcore as tfc
from olearning_sim_tpu_torch.engine.client_data import HostClientStore, pad_to_multiple
from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
from olearning_sim_tpu_torch.resilience import faults as tfaults
from olearning_sim_tpu_torch.telemetry import default_tracer
from olearning_sim_tpu_torch.weights import params_from_jax

import torch_threads  # noqa: F401
from test_torch_checkpoint import _assert_same_state
from test_torch_defense import ATTACK, COMPLETION, DEADLINE, PART, STEPS
from test_torch_fedcore_families import (
    BATCH,
    N_LOCAL,
    PARAM_ATOL,
    SHAPES,
    _compare_tree,
    _cores,
)
from test_torch_fedcore_families import STEPS as LOCAL_STEPS
from test_torch_fedcore_families import _jax_indices as _family_indices
from test_torch_runner import LOSS_ATOL, _jax_indices, _run_jax, _run_port, task_json
from test_torch_task_bridge import engine_params, set_engine_params

NUM_CLIENTS = 11  # resident: padded to 12 (three blocks of 4)
STREAM_ROWS = 8   # streamed: padded to 16, two stream blocks


def _host(mod):
    return mod.make_synthetic_dataset(1, NUM_CLIENTS, N_LOCAL, SHAPES["mlp2"], 10,
                                      dirichlet_alpha=0.5, num_samples_range=(4, 10))


@pytest.fixture(scope="module")
def port():
    """The port's core and state (from JAX's init), the host population and
    the resident population at the streamed padding (16)."""
    jcore, tcore, jstate, tstate = _cores("mlp2", jalg.fedavg(0.05), talg.fedavg(0.05))
    host = _host(tcd)
    return tcore, tstate, host, host.pad_for(2 * STREAM_ROWS).to("cpu")


def _same_round(a, b):
    (sa, ma), (sb, mb) = a, b
    for k in sa.params:
        assert torch.equal(sa.params[k], sb.params[k]), k
    assert sa.round_idx == sb.round_idx
    for f in ("mean_loss", "weight_sum", "clients_trained", "stragglers", "clipped"):
        assert torch.equal(getattr(ma, f), getattr(mb, f)), f
    assert torch.equal(ma.client_loss.isnan(), mb.client_loss.isnan())
    assert torch.equal(ma.client_loss.nan_to_num(), mb.client_loss.nan_to_num())


def _pad16(a, fill):
    out = np.full(2 * STREAM_ROWS, fill, np.asarray(a).dtype)
    out[: len(a)] = a
    return out


# -------------------------------------------------------------- the store
def test_store_padding_rows_are_inert_and_match_jax():
    rows = {}
    for mod in (jcd, tcd):
        store = mod.HostClientStore.from_dataset(mod.make_synthetic_dataset(0, 10, 4, (8,), 3))
        store.pad_to(16)
        rows[mod] = store.rows(8, 16)
        with pytest.raises(IndexError):
            store.rows(0, 17)
        with pytest.raises(ValueError):
            store.pad_to(4)
    got = rows[tcd]
    assert got["x"].shape == (8, 4, 8)
    np.testing.assert_array_equal(got["weight"][2:], 0.0)
    np.testing.assert_array_equal(got["num_samples"][2:], 1)
    np.testing.assert_array_equal(got["client_uid"], np.arange(8, 16))
    for k, v in rows[jcd].items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_store_synthetic_rows_equal_jax():
    kw = dict(seed=5, num_clients=100, n_local=4, input_shape=(6,), num_classes=3,
              chunk_rows=32, dirichlet_alpha=0.3)
    j, t = jcd.HostClientStore.synthetic(**kw), tcd.HostClientStore.synthetic(**kw)
    for lo, hi in ((20, 70), (20, 32), (96, 100), (0, 100)):
        a, b = j.rows(lo, hi), t.rows(lo, hi)
        for k in a:
            assert b[k].dtype == a[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"[{lo}, {hi}) {k}")
    j.pad_to(128), t.pad_to(128)
    a, b = j.rows(96, 128), t.rows(96, 128)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_array_equal(b["weight"][4:], 0.0)


def test_store_per_client_state():
    store = HostClientStore.synthetic(seed=0, num_clients=8, n_local=2, input_shape=(4,),
                                      num_classes=2)
    ema = store.ensure_state("pacing_ema", (), np.float32, fill=1.5)
    assert ema.shape == (8,) and (ema == 1.5).all()
    store.set_state_rows("pacing_ema", 2, 4, [0.5, 0.25])
    np.testing.assert_array_equal(store.state_rows("pacing_ema", 0, 5),
                                  [1.5, 1.5, 0.5, 0.25, 1.5])
    store.ensure_state("strikes", (3,), np.int32)
    assert store.state_names() == ["pacing_ema", "strikes"]
    assert store.state_bytes() == 8 * 4 + 8 * 3 * 4
    store.pad_to(12)
    assert store.ensure_state("pacing_ema", ()).shape == (12,)
    np.testing.assert_array_equal(store.state_rows("pacing_ema", 8, 12), 0)


# ------------------------------------------------------- bitwise parity
def test_successive_block_draws_equal_one_draw():
    """draw_indices over consecutive row blocks from one generator is the
    whole-population draw, at the trace config's shape (2048 rows, 10
    steps of 32) and at uneven sample counts."""
    core = tfc.FedCore(None, talg.fedavg(0.05), tfc.FedCoreConfig(batch_size=32))
    ns = torch.from_numpy(np.random.default_rng(0).integers(0, 70, 2048))
    whole = core.draw_indices(torch.Generator().manual_seed(7), ns)
    gen = torch.Generator().manual_seed(7)
    parts = [core.draw_indices(gen, ns[i:i + 32]) for i in range(0, 2048, 32)]
    assert torch.equal(torch.cat(parts), whole)


CASES = {
    "plain": {},
    "deadline_attack_clip": {"completion_time": COMPLETION, "deadline": DEADLINE,
                             "attack_scale": ATTACK,
                             "defense": tdef.DefenseConfig(clip_norm=2.0)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_round_is_the_resident_round_bitwise(port, case):
    """Two rounds at 16 padded clients: two stream blocks of 8 against the
    resident round's four blocks of 4, with participation and per-client
    steps."""
    tcore, tstate, host, resident = port
    kw = CASES[case]
    res_kw = {k: (torch.from_numpy(_pad16(v, np.inf if k == "completion_time" else 1.0))
                  if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    store = HostClientStore.from_dataset(host)
    sa = sb = tstate
    for _ in range(2):
        a = tcore.round_step(sa, resident, participate=torch.from_numpy(_pad16(PART, 0.0)),
                             num_steps=torch.from_numpy(_pad16(STEPS, 3).astype(np.int64)),
                             **res_kw)
        sb, mb, stats = tcore.stream_round(sb, store, stream_rows=STREAM_ROWS,
                                           participate=PART, num_steps=STEPS, **kw)
        _same_round(a, (sb, mb))
        sa = a[0]
    assert stats.blocks == 2 and stats.rows == 16 and stats.block_rows == STREAM_ROWS
    if case != "plain":
        assert float(mb.stragglers) > 0 and float(mb.clipped) > 0
    # O(block) device memory: two staged blocks, params and the carry.
    params_bytes = sum(v.numel() * 4 for v in sb.params.values())
    assert stats.peak_hbm_bytes_est <= 2 * stats.transfer_bytes // stats.blocks \
        + 2 * params_bytes + 16


def test_streamed_label_drift_is_the_shifted_resident_round(port):
    tcore, tstate, host, resident = port
    shift = np.zeros(NUM_CLIENTS, np.int64)
    shift[::3] = 1
    shift[::7] = 2
    y = resident.y.clone()
    y[:NUM_CLIENTS] = (y[:NUM_CLIENTS] + torch.from_numpy(shift)[:, None]) % 10
    a = tcore.round_step(tstate, dataclasses.replace(resident, y=y))
    b = tcore.stream_round(tstate, HostClientStore.from_dataset(host), stream_rows=STREAM_ROWS,
                           participate=np.ones(NUM_CLIENTS, np.float32),
                           label_shift=shift, label_classes=10)
    _same_round(a, b[:2])
    assert not torch.equal(a[0].params["dense.0.weight"],
                           tcore.round_step(tstate, resident)[0].params["dense.0.weight"])


def test_resident_at_block_padding_is_streamed_at_stream_padding(port):
    """The real clients draw the same rows whichever the padding: 12
    resident rows against 16 streamed ones train the same round."""
    tcore, tstate, host, _ = port
    a = tcore.round_step(tstate, host.pad_for(4).to("cpu"))
    b = tcore.stream_round(tstate, HostClientStore.from_dataset(host), stream_rows=STREAM_ROWS)
    for k in a[0].params:
        assert torch.equal(a[0].params[k], b[0].params[k]), k
    assert torch.equal(a[1].client_loss[:NUM_CLIENTS], b[1].client_loss[:NUM_CLIENTS])
    assert torch.equal(a[1].mean_loss, b[1].mean_loss)


# ----------------------------------------------------------- against JAX
@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_round_matches_jax(case):
    """Two streamed rounds on both engines, the port handed JAX's draws
    for the store's padded rows."""
    jcore, tcore, jstate, tstate = _cores("mlp2", jalg.fedavg(0.05), talg.fedavg(0.05))
    jstore = jcd.HostClientStore.from_dataset(_host(jcd))
    tstore = tcd.HostClientStore.from_dataset(_host(tcd))
    jstore.pad_to(16), tstore.pad_to(16)
    rows = jstore.rows(0, 16)
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    kw = dict(CASES[case], participate=PART, num_steps=STEPS)
    jkw = dict(kw)
    if "defense" in kw:
        jkw["defense"] = jdef.DefenseConfig(clip_norm=2.0)
    for r in range(2):
        idx = _family_indices(key_data, rows["client_uid"], rows["num_samples"], r)
        jstate, jm, jstats = jcore.stream_round(jstate, jstore, stream_rows=STREAM_ROWS, **jkw)
        tstate, tm, tstats = tcore.stream_round(tstate, tstore, stream_rows=STREAM_ROWS,
                                                indices=idx, **kw)
        _compare_tree(tstate.params, jstate.params, PARAM_ATOL)
        jloss = np.asarray(jm.client_loss)
        np.testing.assert_array_equal(np.isnan(tm.client_loss.numpy()), np.isnan(jloss))
        np.testing.assert_allclose(tm.client_loss.numpy(), jloss, atol=LOSS_ATOL, rtol=0)
        for f in ("weight_sum", "clients_trained", "stragglers", "clipped"):
            assert float(getattr(tm, f)) == float(getattr(jm, f)), f
        for f in ("blocks", "block_rows", "rows", "state_bytes"):
            assert getattr(tstats, f) == getattr(jstats, f), f
    if case != "plain":
        assert float(tm.stragglers) == 3 and 0 < float(tm.clipped) < float(tm.clients_trained)


def test_stream_refusals_match_jax():
    jcore, tcore, jstate, tstate = _cores("mlp2", jalg.fedavg(0.05), talg.fedavg(0.05))
    jstore = jcd.HostClientStore.from_dataset(_host(jcd))
    tstore = tcd.HostClientStore.from_dataset(_host(tcd))
    ones = np.ones(NUM_CLIENTS, np.float32)
    cases = [
        dict(stream_rows=6),
        dict(stream_rows=STREAM_ROWS, completion_time=ones),
        dict(stream_rows=STREAM_ROWS, defense="median"),
        dict(stream_rows=STREAM_ROWS, label_shift=ones.astype(np.int32)),
        dict(),
    ]
    for kw in cases:
        jkw, tkw = dict(kw), dict(kw)
        if kw.get("defense"):
            jkw["defense"] = jdef.DefenseConfig(aggregator="median")
            tkw["defense"] = tdef.DefenseConfig(aggregator="median")
        with pytest.raises(ValueError) as want:
            jcore.stream_round(jstate, jstore, **jkw)
        with pytest.raises(ValueError) as got:
            tcore.stream_round(tstate, tstore, **tkw)
        assert str(got.value) == str(want.value), kw
    # The deadline's message names the port's own pacing module.
    with pytest.raises(ValueError, match="deadline given without completion_time"):
        tcore.stream_round(tstate, tstore, stream_rows=STREAM_ROWS, deadline=1.0)
    with pytest.raises(ValueError, match="indices must be"):
        tcore.stream_round(tstate, tstore, stream_rows=STREAM_ROWS,
                           indices=torch.zeros((12, LOCAL_STEPS, BATCH), dtype=torch.int64))
    for name in ("ditto", "scaffold"):
        jc, tc, js, ts = _cores("mlp2", getattr(jalg, name)(0.05), getattr(talg, name)(0.05))
        with pytest.raises(ValueError) as want:
            jc.stream_round(js, jstore, stream_rows=STREAM_ROWS)
        with pytest.raises(ValueError) as got:
            tc.stream_round(ts, tstore, stream_rows=STREAM_ROWS)
        assert str(got.value) == str(want.value)
    # The sharded server update does not stream, in either package.
    jc, tc, js, ts = _cores("mlp2", jalg.fedavg(0.05), talg.fedavg(0.05),
                            shard_server_update=True)
    with pytest.raises(ValueError) as want:
        jc.stream_round(js, jstore, stream_rows=STREAM_ROWS)
    with pytest.raises(ValueError) as got:
        tc.stream_round(ts, tstore, stream_rows=STREAM_ROWS)
    assert str(got.value) == str(want.value)
    assert "shard_server_update=true does not compose" in str(got.value)


# -------------------------------------------------------- the runner path
SCENARIO = {"online_base": 0.6, "online_amp": 0.3, "class_phase_hours": {"low": 6.0},
            "phase_jitter_hours": 2.0, "leave_rate": 0.05, "join_frac": 0.2,
            "join_rate": 0.3, "drift_period_rounds": 2, "stream_block_rows": STREAM_ROWS}


def scenario_task(task_id, rounds=3, streamed=True, **blocks):
    """tests/test_torch_runner.py's task (12 clients in two classes with
    compute profiles, block 4, a dispatch strategy with drops, train +
    eval) with a scenario: diurnal phase per class, churn, joins, label
    drift every 2 rounds, and two stream blocks of 8 when ``streamed``."""
    task = task_json(task_id, rounds=rounds)
    params = engine_params(task)
    params["scenario"] = dict(SCENARIO)
    if not streamed:
        del params["scenario"]["stream_block_rows"]
    params.update(blocks)
    return set_engine_params(task, params)


@pytest.mark.parametrize("streamed", [True, False])
def test_scenario_runner_matches_jax(streamed, monkeypatch):
    """The streamed scenario runner and the resident one (whose drift
    rotates the placed labels for the train launch) against the JAX runner
    on the same task; the port from JAX's init and draws."""
    from olearning_sim_tpu.engine import runner as jrunner_mod
    from olearning_sim_tpu.telemetry import MetricsRegistry
    from olearning_sim_tpu_torch.engine import runner as trunner_mod

    registry = MetricsRegistry()
    jtask = scenario_task("scen_jax", streamed=streamed)
    ttask = scenario_task("scen_port", streamed=streamed)
    jok, tok = [], []
    for mod, sink in ((jrunner_mod, jok), (trunner_mod, tok)):
        orig = mod.SimulationRunner._analyze_results

        def spy(self, operator, round_idx, ok, _orig=orig, _sink=sink):
            if operator.kind == "train":
                _sink.append({k: np.asarray(v).copy() for k, v in ok.items()})
            return _orig(self, operator, round_idx, ok)

        monkeypatch.setattr(mod.SimulationRunner, "_analyze_results", spy)
    jrunner, jrepo, jhist, init = _run_jax(jtask, registry)
    if streamed:
        trunner, trepo, thist = _run_port_streamed(ttask, registry, init)
    else:
        trunner, trepo, thist = _run_port(ttask, registry, init)
    for col in ("logical_target", "logical_result", "logical_round"):
        assert trepo.get_item_value("scen_port", col) == \
            jrepo.get_item_value("scen_jax", col), col
    drifted = 0
    for jr, tr in zip(jhist, thist):
        j, t = jr["train"]["data_0"], tr["train"]["data_0"]
        for k in ("released", "dropped", "clients_trained", "sim_duration_s", "scenario"):
            assert t[k] == j[k], (jr["round"], k)
        assert abs(t["mean_loss"] - j["mean_loss"]) <= LOSS_ATOL
        if streamed:
            for k in ("blocks", "cursor", "block_rows", "rows"):
                assert t["stream"][k] == j["stream"][k], (jr["round"], k)
        else:
            assert "stream" not in t and "stream" not in j
        je, te = jr["evaluate"]["data_0"], tr["evaluate"]["data_0"]
        assert abs(te["eval_loss"] - je["eval_loss"]) <= LOSS_ATOL
        drifted += t["scenario"]["drifted"]
    assert drifted > 0 and len(tok) == len(jok) == 3
    for a, b in zip(tok, jok):
        np.testing.assert_array_equal(a["data_0"], b["data_0"])
    jparams = params_from_jax(jax.tree.map(np.asarray, jrunner.states["data_0"].params))
    _compare_tree(trunner.states["data_0"].params, jrunner.states["data_0"].params, PARAM_ATOL)
    assert set(jparams) == set(trunner.states["data_0"].params)


def _run_port_streamed(task, registry, init):
    """The port's runner from JAX's init params, each streamed round handed
    JAX's draws for the store's padded rows."""
    from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo

    repo = TaskTableRepo()
    runner = build_runner_from_taskconfig(task, task_repo=repo, registry=registry,
                                          device="cpu")
    params, key_data = init
    core = runner.core
    runner.states["data_0"] = core.init_state(device="cpu", params=params)
    orig = core.stream_round

    def stream_round_with_jax_draws(state, store, **kw):
        store.pad_to(pad_to_multiple(store.padded_clients, kw["stream_rows"]))
        rows = store.rows(0, store.padded_clients)
        kw["indices"] = _jax_indices(key_data, rows["client_uid"], rows["num_samples"],
                                     state.round_idx, core.config.max_local_steps,
                                     core.config.batch_size)
        return orig(state, store, **kw)

    core.stream_round = stream_round_with_jax_draws
    return runner, repo, runner.run()


def test_streamed_round_emits_nested_stream_spans():
    tracer = default_tracer()
    tracer.clear()
    runner = build_runner_from_taskconfig(scenario_task("spans", rounds=1), device="cpu")
    runner.run()
    stages, steps = tracer.spans("stream_stage"), tracer.spans("stream_step")
    assert [s.attrs["block"] for s in stages] == [0, 1]
    assert [s.attrs["block"] for s in steps] == [0, 1]
    train = [s for s in tracer.spans() if s.name == "round.train.train"]
    assert len(train) == 1
    assert all(s.parent_id == train[0].span_id for s in stages + steps)


def test_streamed_runner_refuses_gathering_defense_and_stateful_algorithms():
    from olearning_sim_tpu.engine.task_bridge import build_runner_from_taskconfig as jbuild
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan

    plan = make_mesh_plan(devices=jax.devices()[:1])
    for blocks in ({"defense": {"aggregator": "median"}},
                   {"algorithm": {"name": "ditto", "local_lr": 0.1}}):
        with pytest.raises(ValueError) as want:
            jbuild(scenario_task("bad", **blocks), plan=plan)
        with pytest.raises(ValueError) as got:
            build_runner_from_taskconfig(scenario_task("bad", **blocks), device="cpu")
        assert str(got.value) == str(want.value)


def test_streamed_runner_resumes_bitwise(tmp_path):
    """A streamed scenario run preempted at round 2 (retry policy: the
    checkpoint rollback replays it) and a run of 3 rounds finished by a
    fresh runner over the same checkpoint directory each equal the
    uninterrupted 4-round run bitwise; every record keeps its stream
    cursor."""
    straight = build_runner_from_taskconfig(scenario_task("resume", rounds=4), device="cpu")
    straight.run()

    ckpt = {"checkpoint": {"directory": str(tmp_path / "a" / "{task_id}"), "every": 1},
            "resilience": {"failure_policy": "retry"}}
    pre = build_runner_from_taskconfig(scenario_task("resume", rounds=4, **ckpt), device="cpu")
    plan = {"seed": 0, "specs": [{"point": "runner.round_begin", "rounds": [2],
                                  "error": "preempt"}]}
    with tfaults.chaos(tfaults.FaultPlan.from_dict(plan)):
        hist = pre.run()
    assert [h["round"] for h in hist] == [0, 1, 2, 3]
    _assert_same_state(pre, straight)

    ckpt = {"checkpoint": {"directory": str(tmp_path / "b" / "{task_id}"), "every": 1}}
    first = build_runner_from_taskconfig(scenario_task("resume", rounds=3, **ckpt), device="cpu")
    first.run()
    fresh = build_runner_from_taskconfig(scenario_task("resume", rounds=4, **ckpt), device="cpu")
    hist = fresh.run()
    assert [h["round"] for h in hist] == [0, 1, 2, 3]
    assert all(h["train"]["data_0"]["stream"]["cursor"] == 2 for h in hist)
    _assert_same_state(fresh, straight)


def test_streamed_population_skips_poison_and_label_flip():
    """NaN poisoning and label flips swap device buffers, which a streamed
    population does not have: both are skipped (with a warning), so the
    run equals the clean streamed run bitwise, while a sign flip still
    reaches the round."""
    clean = build_runner_from_taskconfig(scenario_task("skip", rounds=2), device="cpu")
    clean.run()
    plan = {"seed": 0, "specs": [
        {"point": "runner.poison_clients", "rounds": [0], "error": "nan",
         "payload": {"clients": [1, 5]}},
        {"point": "runner.attack_clients", "times": -1,
         "payload": {"mode": "label_flip", "clients": [0, 2, 3]}}]}
    skipped = build_runner_from_taskconfig(scenario_task("skip", rounds=2), device="cpu")
    with tfaults.chaos(tfaults.FaultPlan.from_dict(plan)):
        hist = skipped.run()
    _assert_same_state(skipped, clean)
    assert all("attacked" not in h["train"]["data_0"] for h in hist)
    flip = {"seed": 0, "specs": [{"point": "runner.attack_clients", "times": -1,
                                  "payload": {"mode": "sign_flip", "clients": [0, 2, 3]}}]}
    attacked = build_runner_from_taskconfig(scenario_task("skip", rounds=2), device="cpu")
    with tfaults.chaos(tfaults.FaultPlan.from_dict(flip)):
        hist = attacked.run()
    assert hist[0]["train"]["data_0"]["attack_mode"] == "sign_flip"
    assert not torch.equal(attacked.states["data_0"].params["dense.0.weight"],
                           clean.states["data_0"].params["dense.0.weight"])
