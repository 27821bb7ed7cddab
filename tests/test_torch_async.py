"""Buffered asynchronous rounds in the port (engine/async_rounds.py, the
async path of FedCore.round_step and of the runner), after
tests/test_async.py, against the JAX package:

- the planner exactly: windows, scores, commit times, fills, the staleness
  weights, the idle seconds and the stale-dropped mask, over completion
  times with ties, zeros and non-finite arrivals; AsyncConfig.from_dict's
  refusals with JAX's messages;
- whole async rounds against the JAX engine's at dp 1 on the same params and
  minibatch draws, under every schedule, a staleness drop, an attack with a
  clip, a trimmed mean with anomaly scores (scored from the trimmed mean,
  the async program's center) and a median: params within mlp2's bound,
  commits and drops exact, the buffer's weights within 1e-6;
- the buffered sums and commits against a numpy oracle built from the
  port's own per-client deltas; one buffer under ``constant`` against the
  synchronous round;
- the refusals of the core, the runner and the bridge, with JAX's messages;
- the async runner against the JAX runner on the same task: every
  accounting field, the commit clock, the staleness observations and the
  buffer-depth gauge exactly, params within the bound;
- a preempted run and a retried round, each equal to the uninterrupted run
  bitwise, the commit clock included."""

import json

import jax
import numpy as np
import pytest
import torch

from olearning_sim_tpu.engine import async_rounds as jasync
from olearning_sim_tpu.engine import algorithms as jalg
from olearning_sim_tpu.engine import defense as jdef
from olearning_sim_tpu_torch.engine import algorithms as talg
from olearning_sim_tpu_torch.engine import async_rounds as tasync
from olearning_sim_tpu_torch.engine import defense as tdef
from olearning_sim_tpu_torch.engine import fedcore as tfc
from olearning_sim_tpu_torch.engine.client_data import make_synthetic_dataset
from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
from olearning_sim_tpu_torch.resilience import HostPreemption
from olearning_sim_tpu_torch.resilience import faults as tfaults

import torch_threads  # noqa: F401
from test_torch_defense import ATTACK, PART, STEPS, _clip_between, _norms
from test_torch_fedcore_families import (
    PARAM_ATOL,
    _compare_metrics,
    _compare_tree,
    _cores,
    _jax_indices,
    _plan,
    _populations,
    _put,
)

# ------------------------------------------------------------- the planner
PLAN_COMPLETIONS = {
    "ties": np.array([3.0, 1.0, 2.0, 2.0, np.inf, 5.0, 2.0, 0.5, 1.0, 7.0], np.float32),
    "zeros_nan": np.array([0.0, 1.5, np.nan, 0.0, 4.0, -1.0, np.inf, 2.5, 1.5, 3.0],
                          np.float32),
    "linspace": np.linspace(0.5, 8.0, 10).astype(np.float32),
    "all_inf": np.full(10, np.inf, np.float32),
}
SELECTIONS = {
    "all": np.ones(10, bool),
    "some": np.array([1, 1, 1, 1, 1, 0, 1, 0, 1, 1], bool),
    "none": np.zeros(10, bool),
}
PLAN_CONFIGS = {
    "M2": {"buffer_size": 2},
    "M3_stale1": {"buffer_size": 3, "max_staleness": 1},
    "M4_score": {"buffer_size": 4, "schedule": "score", "max_staleness": 0},
    "M16_constant": {"buffer_size": 16, "schedule": "constant"},
}


@pytest.mark.parametrize("padded", [10, 16])
@pytest.mark.parametrize("sel", sorted(SELECTIONS))
@pytest.mark.parametrize("comp", sorted(PLAN_COMPLETIONS))
@pytest.mark.parametrize("conf", sorted(PLAN_CONFIGS))
def test_plan_matches_jax_exactly(conf, comp, sel, padded):
    completion, selected = PLAN_COMPLETIONS[comp], SELECTIONS[sel]
    jp = jasync.plan_async_round(jasync.AsyncConfig(**PLAN_CONFIGS[conf]), completion,
                                 selected, padded)
    tp = tasync.plan_async_round(tasync.AsyncConfig(**PLAN_CONFIGS[conf]), completion,
                                 selected, padded)
    assert tp.num_windows == jp.num_windows and tp.num_selected == jp.num_selected
    for name in ("window", "commit_time", "fill"):
        a, b = getattr(tp, name), getattr(jp, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (tp.score is None) == (jp.score is None)
    if jp.score is not None:
        assert tp.score.dtype == jp.score.dtype
        np.testing.assert_array_equal(tp.score, jp.score)
    np.testing.assert_array_equal(tp.stale_dropped_mask(), jp.stale_dropped_mask())
    assert tp.idle_seconds(completion) == jp.idle_seconds(completion)


@pytest.mark.parametrize("max_staleness", [None, 0, 2])
@pytest.mark.parametrize("schedule", ["constant", "polynomial", "score"])
def test_staleness_weights_match_jax(schedule, max_staleness):
    for alpha, windows in ((0.5, 5), (2.0, 1), (0.0, 4)):
        want = jasync.staleness_weights(schedule, alpha, windows, max_staleness)
        got = tasync.staleness_weights(schedule, alpha, windows, max_staleness)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("obj", [
    "fast", {"bufer_size": 8}, {"buffer_size": 0}, {"schedule": "exponential"},
    {"max_staleness": -1}, {"staleness_alpha": -0.5}, {"jitter": -0.1},
    {"default_step_s": -1.0}, {"speed_profiles": {"high": "quick"}},
    {"buffer_size": 25, "max_staleness": 8, "schedule": "polynomial",
     "staleness_alpha": 0.5, "speed_profiles": {"high": 0.05, "low": 0.5},
     "default_step_s": 0.1, "jitter": 0.1},
    {"buffer_size": None, "schedule": "score"},
])
def test_async_config_from_dict_matches_jax(obj):
    def parse(mod):
        try:
            return mod.AsyncConfig.from_dict(obj)
        except (TypeError, ValueError) as e:
            return type(e), str(e)

    want, got = parse(jasync), parse(tasync)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert dataclasses_dict(got) == dataclasses_dict(want)
        assert got.num_windows(100) == want.num_windows(100)
        jp, tp = want.pacing_config(), got.pacing_config()
        assert tp.enabled == jp.enabled is False
        assert (tp.speed_profiles, tp.default_step_s, tp.jitter) == \
            (jp.speed_profiles, jp.default_step_s, jp.jitter)


def dataclasses_dict(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


# ------------------------------------------------- whole rounds against JAX
NUM_CLIENTS = 11  # padded to 12: three blocks of 4, three windows of 4
# Arrivals with ties (clients 2 and 5, 7 and 9) and a client that never
# arrives (11, padding).
ARRIVAL = np.array([0.4, 2.5, 0.3, 1.9, 0.3, 0.3, 3.0, 0.9, 1.1, 0.9, 2.2, np.inf],
                   np.float32)
# Scores: L2 distances between deltas both engines compute in bf16
# (tests/test_torch_defense.py).
SCORE_RTOL = 1e-5
STATS_RTOL = 1e-6
ROUND_CASES = {
    "constant": {"async": {"buffer_size": 4, "schedule": "constant"}},
    "polynomial": {"async": {"buffer_size": 4, "staleness_alpha": 0.7}},
    "score": {"async": {"buffer_size": 4, "schedule": "score"}},
    "max_staleness": {"async": {"buffer_size": 4, "staleness_alpha": 0.7,
                                "max_staleness": 1}},
    "attack_clip": {"async": {"buffer_size": 4}, "attack": True,
                    "defense": {"clip": True}},
    # The third window is empty. (The JAX async program does not trace
    # with anomaly scores on this jax: test_async_scores_match_numpy_oracle
    # holds the port's scores instead.)
    "trimmed_mean_clip": {"async": {"buffer_size": 5, "schedule": "score"},
                          "attack": True,
                          "defense": {"clip": True, "aggregator": "trimmed_mean",
                                      "trim_fraction": 0.2}},
    "median": {"async": {"buffer_size": 4, "max_staleness": 1}, "attack": True,
               "defense": {"aggregator": "median"}},
    "fedadam": {"async": {"buffer_size": 4}, "algorithm": "fedadam"},
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_async_round_matches_jax(case):
    """Two async rounds of each case on both engines from JAX's init params
    and minibatch draws: params within mlp2's bound, the metrics as in the
    synchronous parity tests, commits and stale drops exactly, the buffer's
    weights within STATS_RTOL, clipped counts exactly and anomaly scores
    within SCORE_RTOL."""
    spec = ROUND_CASES[case]
    name = spec.get("algorithm", "fedavg")
    jcore, tcore, jstate, tstate = _cores("mlp2", getattr(jalg, name)(0.05),
                                          getattr(talg, name)(0.05))
    jds, tds = _populations("mlp2", num_clients=NUM_CLIENTS)
    plan = _plan()
    acfg = spec["async"]
    selected = PART[:NUM_CLIENTS] > 0
    jplan = jasync.plan_async_round(jasync.AsyncConfig(**acfg), ARRIVAL[:NUM_CLIENTS],
                                    selected, 12)
    tplan = tasync.plan_async_round(tasync.AsyncConfig(**acfg), ARRIVAL[:NUM_CLIENTS],
                                    selected, 12)
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    kw_j = {"num_steps": _put(plan, STEPS), "participate": _put(plan, PART)}
    kw_t = {"num_steps": torch.from_numpy(STEPS), "participate": torch.from_numpy(PART)}
    if spec.get("attack"):
        kw_j["attack_scale"] = _put(plan, ATTACK)
        kw_t["attack_scale"] = torch.from_numpy(ATTACK)
    d = dict(spec.get("defense") or {})
    clip = d.pop("clip", False)
    for r in range(2):
        idx = _jax_indices(key_data, tds.client_uid.numpy(), tds.num_samples.numpy(), r)
        if d or clip:
            if clip:
                norms = _norms(tcore, tstate, tds, idx, **kw_t)
                weights = PART * (STEPS > 0) * (~tplan.stale_dropped_mask())
                d["clip_norm"] = _clip_between(norms, weights)
            kw_j["defense"] = jdef.DefenseConfig(**d)
            kw_t["defense"] = tdef.DefenseConfig(**d)
        jstate, jm, jst = jcore.round_step(jstate, jds, async_plan=jplan, **kw_j)
        tstate, tm, tst = tcore.round_step(tstate, tds, indices=idx, async_plan=tplan, **kw_t)
        _compare_metrics(tm, jm)
        _compare_tree(tstate.params, jstate.params, PARAM_ATOL)
        assert float(tst.commits) == float(jst.commits)
        assert float(tst.dropped_stale) == float(jst.dropped_stale)
        np.testing.assert_allclose(tst.buffer_fill.numpy(), np.asarray(jst.buffer_fill),
                                   rtol=STATS_RTOL, atol=0)
        np.testing.assert_allclose(float(tst.committed_weight), float(jst.committed_weight),
                                   rtol=STATS_RTOL, atol=0)
        assert float(tm.clipped) == float(jm.clipped)
        jscore = np.asarray(jm.anomaly_score)
        assert tuple(tm.anomaly_score.shape) == jscore.shape
        np.testing.assert_allclose(tm.anomaly_score.numpy(), jscore, rtol=SCORE_RTOL, atol=0)
    # Each case exercises what it names.
    if case == "max_staleness":
        assert float(tst.dropped_stale) > 0 and float(tst.commits) == 2
    if d.get("clip_norm"):
        assert 0 < float(tm.clipped)
    if case == "trimmed_mean_clip":
        assert float(tst.buffer_fill[2]) == 0 and float(tst.commits) == 2
    if name == "fedadam":
        assert int(tstate.opt_state["count"]) == int(jstate.opt_state[0].count) == 6


# ------------------------------------------------- the port against oracles
ORACLE_CLIENTS = 16
ORACLE_COMPLETION = np.linspace(0.5, 8.0, ORACLE_CLIENTS).astype(np.float32)


@pytest.fixture(scope="module")
def small():
    """The JAX test's fixture: mlp2 hidden 8 on 16 clients, block 2."""
    core = tfc.build_fedcore(
        "mlp2", talg.fedavg(0.1),
        tfc.FedCoreConfig(batch_size=4, max_local_steps=2, block_clients=2),
        model_overrides={"hidden": (8,), "num_classes": 3}, input_shape=(8,), device="cpu")
    ds = make_synthetic_dataset(7, ORACLE_CLIENTS, 6, (8,), 3, class_sep=3.0).pad_for(2).to("cpu")
    state = core.init_state(0, device="cpu")
    # Per-client deltas from one-client synchronous rounds: every client
    # anchors at the round-begin params and draws the round's indices, the
    # async engine's dispatch model.
    deltas = []
    for c in range(ds.num_clients):
        onehot = torch.zeros(ds.num_clients)
        onehot[c] = 1.0
        st, _ = core.round_step(state, ds, participate=onehot)
        deltas.append({k: st.params[k].double() - state.params[k].double()
                       for k in state.params})
    return core, ds, state, deltas


@pytest.mark.parametrize("max_staleness", [None, 1])
def test_buffered_sums_match_numpy_oracle(small, max_staleness):
    core, ds, state, deltas = small
    acfg = tasync.AsyncConfig(buffer_size=4, schedule="polynomial", staleness_alpha=0.7,
                              max_staleness=max_staleness)
    ap = tasync.plan_async_round(acfg, ORACLE_COMPLETION, np.ones(ORACLE_CLIENTS, bool),
                                 ds.num_clients)
    s, m, st = core.round_step(state, ds, async_plan=ap)
    alive = ap.num_windows if max_staleness is None else max_staleness + 1
    assert int(st.commits) == alive
    assert int(st.dropped_stale) == 4 * (ap.num_windows - alive)
    assert int(m.clients_trained) == 4 * alive
    weights = ds.weight.double().numpy()
    sw = tasync.staleness_weights("polynomial", 0.7, ap.num_windows, max_staleness)
    cur = {k: v.double().clone() for k, v in state.params.items()}
    for w in range(alive):
        members = np.flatnonzero(ap.window == w)
        wsum = weights[members].sum()
        for k in cur:
            mean_d = sum(weights[c] * deltas[c][k] for c in members) / wsum
            cur[k] = cur[k] + float(sw[w]) * mean_d
    for k, v in cur.items():
        np.testing.assert_allclose(s.params[k].double().numpy(), v.numpy(), rtol=2e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("aggregator", ["trimmed_mean", "median", "mean"])
def test_async_scores_match_numpy_oracle(small, aggregator):
    """Each window's robust statistic over its own members, and each
    client's anomaly score from its own window's center: the aggregator's
    own result when it is robust (the JAX async program's center), the
    median under the mean aggregator, which then commits the weighted
    mean."""
    core, ds, state, deltas = small
    trim = 0.25
    acfg = tasync.AsyncConfig(buffer_size=4, schedule="polynomial", staleness_alpha=0.7)
    ap = tasync.plan_async_round(acfg, ORACLE_COMPLETION, np.ones(ORACLE_CLIENTS, bool),
                                 ds.num_clients)
    defense = tdef.DefenseConfig(aggregator=aggregator, trim_fraction=trim,
                                 anomaly_threshold=3.0)
    s, m, st = core.round_step(state, ds, async_plan=ap, defense=defense)
    assert int(st.commits) == ap.num_windows
    weights = ds.weight.double().numpy()
    sw = tasync.staleness_weights("polynomial", 0.7, ap.num_windows)
    cur = {k: v.double().clone() for k, v in state.params.items()}
    want_scores = np.zeros(ds.num_clients)
    for w in range(ap.num_windows):
        members = np.flatnonzero(ap.window == w)
        n = len(members)
        center, agg = {}, {}
        for k in cur:
            srt = np.sort(np.stack([deltas[c][k].numpy() for c in members]), axis=0)
            t = int(np.floor(trim * n))
            med = (srt[(n - 1) // 2] + srt[n // 2]) / 2
            center[k] = srt[t:n - t].mean(axis=0) if aggregator == "trimmed_mean" else med
            agg[k] = center[k] if aggregator != "mean" else \
                sum(weights[c] * deltas[c][k].numpy() for c in members) / weights[members].sum()
            cur[k] = cur[k] + float(sw[w]) * torch.from_numpy(agg[k])
        for c in members:
            want_scores[c] = np.sqrt(sum(((deltas[c][k].numpy() - center[k]) ** 2).sum()
                                         for k in cur))
    np.testing.assert_allclose(m.anomaly_score.numpy(), want_scores, rtol=1e-5, atol=0)
    for k, v in cur.items():
        np.testing.assert_allclose(s.params[k].double().numpy(), v.numpy(), rtol=2e-5,
                                   atol=1e-6, err_msg=k)


def test_single_buffer_constant_equals_the_sync_round(small):
    core, ds, state, _ = small
    acfg = tasync.AsyncConfig(buffer_size=ds.num_clients, schedule="constant")
    ap = tasync.plan_async_round(acfg, ORACLE_COMPLETION, np.ones(ORACLE_CLIENTS, bool),
                                 ds.num_clients)
    assert ap.num_windows == 1
    s_async, m_async, st = core.round_step(state, ds, async_plan=ap)
    s_sync, m_sync = core.round_step(state, ds)
    assert int(st.commits) == 1
    assert float(m_async.clients_trained) == float(m_sync.clients_trained)
    torch.testing.assert_close(m_async.client_loss, m_sync.client_loss, rtol=0, atol=0,
                               equal_nan=True)
    for k in s_sync.params:
        np.testing.assert_allclose(s_async.params[k].numpy(), s_sync.params[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_empty_and_stale_windows_are_bitwise_no_ops(small):
    """A window that holds no weight (its members sit out) or lies past
    max_staleness commits nothing, bit for bit: Adam's count counts only
    the commits, and the last window empty, dropped as stale, or both,
    gives one round. The same round twice is bitwise the same."""
    _, ds, _, _ = small
    core = tfc.build_fedcore(
        "mlp2", talg.fedadam(0.1, server_lr=0.05),
        tfc.FedCoreConfig(batch_size=4, max_local_steps=2, block_clients=2),
        model_overrides={"hidden": (8,), "num_classes": 3}, input_shape=(8,), device="cpu")
    state = core.init_state(0, device="cpu")
    everyone = np.ones(ORACLE_CLIENTS, bool)

    def run(part_out, **acfg):
        cfg = tasync.AsyncConfig(buffer_size=4, schedule="constant", **acfg)
        ap = tasync.plan_async_round(cfg, ORACLE_COMPLETION, everyone, ds.num_clients)
        part = torch.ones(ds.num_clients)
        part[list(part_out)] = 0
        s, _, st = core.round_step(state, ds, async_plan=ap, participate=part)
        return s, st

    # Window 1 (clients 4-7) empty in the middle of the round.
    s, st = run(range(4, 8))
    assert int(st.commits) == 3 and int(s.opt_state["count"]) == 3
    assert st.buffer_fill[1] == 0
    # Window 3 (clients 12-15): empty, stale, or both.
    empty, st_e = run(range(12, 16))
    stale, st_s = run((), max_staleness=2)
    both, st_b = run(range(12, 16), max_staleness=2)
    assert int(st_e.commits) == int(st_s.commits) == int(st_b.commits) == 3
    assert int(st_s.dropped_stale) == 4 and int(st_e.dropped_stale) == 0
    for other in (stale, both):
        for k in empty.params:
            assert torch.equal(other.params[k], empty.params[k]), k
        for m in ("mu", "nu"):
            for k in empty.params:
                assert torch.equal(other.opt_state[m][k], empty.opt_state[m][k]), (m, k)
        assert int(other.opt_state["count"]) == 3
    again, _ = run(range(4, 8))
    for k in s.params:
        assert torch.equal(s.params[k], again.params[k]), k


# ------------------------------------------------------------- refusals
def test_core_refusals_match_jax():
    jcore, tcore, jstate, tstate = _cores("mlp2", jalg.fedavg(0.05), talg.fedavg(0.05))
    jds, tds = _populations("mlp2", num_clients=NUM_CLIENTS)
    selected = np.ones(NUM_CLIENTS, bool)

    def both(jkw, tkw):
        with pytest.raises(ValueError) as want:
            jcore.round_step(jstate, jds, **jkw)
        with pytest.raises(ValueError) as got:
            tcore.round_step(tstate, tds, **tkw)
        assert str(got.value) == str(want.value)
        return str(got.value)

    for padded in (12, 24):
        jp = jasync.plan_async_round(jasync.AsyncConfig(buffer_size=4),
                                     ARRIVAL[:NUM_CLIENTS], selected, padded)
        tp = tasync.plan_async_round(tasync.AsyncConfig(buffer_size=4),
                                     ARRIVAL[:NUM_CLIENTS], selected, padded)
        if padded == 12:
            comp = np.ones(12, np.float32)
            msg = both(dict(async_plan=jp, completion_time=_put(_plan(), comp), deadline=1.0),
                       dict(async_plan=tp, completion_time=torch.from_numpy(comp),
                            deadline=1.0))
            assert "mutually exclusive" in msg
        else:
            assert "different population" in both(dict(async_plan=jp), dict(async_plan=tp))
    for mod in (jasync, tasync):
        with pytest.raises(ValueError, match="padded population 8 smaller"):
            mod.plan_async_round(mod.AsyncConfig(buffer_size=4), ARRIVAL[:NUM_CLIENTS],
                                 selected, 8)
    # A personalized algorithm: with its state and without.
    jd, td, jdst, tdst = _cores("mlp2", jalg.ditto(0.05), talg.ditto(0.05))
    jp = jasync.plan_async_round(jasync.AsyncConfig(buffer_size=4), ARRIVAL[:NUM_CLIENTS],
                                 selected, 12)
    tp = tasync.plan_async_round(tasync.AsyncConfig(buffer_size=4), ARRIVAL[:NUM_CLIENTS],
                                 selected, 12)
    for with_personal in (True, False):
        jkw, tkw = {"async_plan": jp}, {"async_plan": tp}
        if with_personal:
            jkw["personal"] = jd.init_personal(jdst, 12)
            tkw["personal"] = td.init_personal(tdst, 12)
        with pytest.raises(ValueError) as want:
            jd.round_step(jdst, jds, **jkw)
        with pytest.raises(ValueError) as got:
            td.round_step(tdst, tds, **tkw)
        assert str(got.value) == str(want.value)


# ------------------------------------------------ the runner against JAX's
ASYNC_BLOCK = {"buffer_size": 3, "max_staleness": 1, "schedule": "polynomial",
               "staleness_alpha": 0.5, "speed_profiles": {"high": 0.05, "low": 0.3},
               "default_step_s": 0.1, "jitter": 0.2}
ASYNC_KEYS = ("commits", "committed", "stale_dropped", "buffer_size", "windows", "idle_s",
              "commit_clock", "round_close_s")
RUNNER_CASES = {
    "polynomial": ({"async": ASYNC_BLOCK}, None),
    "score_defended": (
        {"async": dict(ASYNC_BLOCK, schedule="score", max_staleness=None),
         "defense": {"clip_norm": 0.5, "aggregator": "trimmed_mean", "trim_fraction": 0.2}},
        {"seed": 3, "specs": [{"point": "runner.attack_clients", "times": -1,
                               "payload": {"mode": "scale", "factor": -8.0,
                                           "clients": [0, 5, 8]}}]}),
}


def _staleness(registry, task_id):
    m = registry.get("ols_engine_staleness_rounds")
    child = dict(m.children())[(task_id,)]
    return child.count, child.sum, list(child.counts)


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_async_runner_matches_jax(case):
    from test_torch_deadline import HOST_KEYS, robust_task
    from test_torch_runner import LOSS_ATOL, _phase_counts, _run_jax, _run_port, _series

    from olearning_sim_tpu.telemetry import MetricsRegistry

    blocks, chaos = RUNNER_CASES[case]
    registry = MetricsRegistry()
    resilience = {"failure_policy": "retry"}
    jtask = robust_task(f"async_{case}_jax", 3, resilience, **blocks)
    ttask = robust_task(f"async_{case}_port", 3, resilience, **blocks)
    jrunner, jrepo, jhist, init = _run_jax(jtask, registry, chaos)
    trunner, trepo, thist = _run_port(ttask, registry, init, chaos)
    jid, tid = jtask["task_id"], ttask["task_id"]
    for col in ("logical_target", "logical_result", "logical_round", "logical_operator"):
        assert trepo.get_item_value(tid, col) == jrepo.get_item_value(jid, col), col
    assert _series(registry, tid) == _series(registry, jid)
    assert _phase_counts(registry, tid) == _phase_counts(registry, jid)
    assert _staleness(registry, tid) == _staleness(registry, jid)
    assert [sorted(h) for h in thist] == [sorted(h) for h in jhist]
    for jr, tr in zip(jhist, thist):
        for k in ("async_clock", "quarantine_state"):
            assert tr.get(k) == jr.get(k), (jr["round"], k)
        j, t = jr["train"]["data_0"], tr["train"]["data_0"]
        assert sorted(t) == sorted(j)
        for k in HOST_KEYS + ASYNC_KEYS:
            assert t.get(k) == j.get(k), (jr["round"], k)
        assert abs(t["mean_loss"] - j["mean_loss"]) <= LOSS_ATOL
    _compare_tree(trunner.states["data_0"].params, jrunner.states["data_0"].params, PARAM_ATOL)
    recs = [h["train"]["data_0"] for h in thist]
    assert all(r["windows"] == 4 and r["commits"] >= 1 for r in recs)
    if case == "polynomial":
        assert sum(r["stale_dropped"] for r in recs) > 0
    else:
        assert sum(r["clipped"] for r in recs) > 0


def test_runner_refusals_match_jax():
    from olearning_sim_tpu.engine.task_bridge import build_runner_from_taskconfig as jbuild
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan

    from test_torch_deadline import DEADLINE, robust_task

    cases = [
        {"async": ASYNC_BLOCK, "deadline": DEADLINE},
        {"async": ASYNC_BLOCK, "algorithm": {"name": "ditto", "local_lr": 0.1}},
        {"async": ASYNC_BLOCK, "algorithm": {"name": "scaffold", "local_lr": 0.1}},
        {"async": ASYNC_BLOCK, "scenario": {"stream_block_rows": 4}},
    ]
    for blocks in cases:
        task = robust_task("async_refused", 1, **blocks)
        with pytest.raises(ValueError) as want:
            jbuild(task, plan=make_mesh_plan(devices=jax.devices()[:1]))
        with pytest.raises(ValueError) as got:
            build_runner_from_taskconfig(task, device="cpu")
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- resume
def _async_task(task_id, rounds=4, **blocks):
    from test_torch_deadline import robust_task

    return robust_task(task_id, rounds, evaluate=False, **dict({"async": ASYNC_BLOCK}, **blocks))


def _same(a, b):
    from test_torch_checkpoint import _assert_same_state

    _assert_same_state(a, b)
    assert [h.get("async_clock") for h in a.history] == [h.get("async_clock") for h in b.history]
    assert a._async_commit_clock == b._async_commit_clock
    assert a.history == json.loads(json.dumps(b.history, default=float))


def test_preempted_async_run_resumes_bitwise(tmp_path):
    straight = build_runner_from_taskconfig(_async_task("async_resume"), device="cpu")
    straight.run()
    assert straight._async_commit_clock == sum(
        h["train"]["data_0"]["commits"] for h in straight.history)
    ckpt = {"directory": str(tmp_path / "{task_id}"), "every": 1}
    first = build_runner_from_taskconfig(_async_task("async_resume", checkpoint=ckpt),
                                         device="cpu")
    preempt = {"point": "runner.round_begin", "rounds": [2], "error": "preempt"}
    with tfaults.chaos(tfaults.FaultPlan.from_dict({"seed": 1, "specs": [preempt]})):
        with pytest.raises(HostPreemption):
            first.run()
    first.checkpointer.wait()
    resumed = build_runner_from_taskconfig(_async_task("async_resume", checkpoint=ckpt),
                                           device="cpu")
    resumed.begin()
    assert resumed._loop["round_idx"] == 2
    assert resumed._async_commit_clock == straight.history[1]["async_clock"]
    while resumed.step():
        pass
    resumed.finish()
    _same(resumed, straight)


def test_retried_async_round_equals_the_clean_run():
    """A failure at round 2's end (after its commits) rolls back to the
    round's snapshot, commit clock included, and the retry equals the
    clean run bitwise."""
    task = _async_task("async_retry", resilience={"failure_policy": "retry"})
    straight = build_runner_from_taskconfig(task, device="cpu")
    straight.run()
    retried = build_runner_from_taskconfig(task, device="cpu")
    fail = {"point": "runner.pre_checkpoint", "rounds": [2]}
    with tfaults.chaos(tfaults.FaultPlan.from_dict({"seed": 1, "specs": [fail]})):
        retried.run()
    summary = json.loads(retried.task_repo.get_item_value("async_retry", "resilience"))
    assert summary["counters"]["rollback"] == 1
    _same(retried, straight)
