"""The port's scenario traces (``engine/scenario.py``, a numpy copy) against
the JAX package's, exactly: every array of every round's trace for the
trace config's scenario over its 50 rounds and for tests/test_scenario.py's
configs, ``combine_traces`` over both packages' traces, and every
``from_dict`` and range rejection with the JAX package's error."""

import json
import pathlib

import numpy as np
import pytest

from olearning_sim_tpu.deviceflow import trace_compiler as jtc
from olearning_sim_tpu.engine import scenario as jsc
from olearning_sim_tpu_torch.deviceflow import trace_compiler as ttc
from olearning_sim_tpu_torch.engine import scenario as tsc

import torch_threads  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
FIELDS = ("participate", "arrival_time", "alive", "online", "charging_ok", "label_shift")


def _trace_config():
    task = json.loads((REPO / "configs" / "fedavg_mnist_mlp_trace.json").read_text())
    params = json.loads(task["operatorflow"]["operators"][0]["logical_simulation"]
                        ["operator_params"])
    return task, params["scenario"]


def _models(block, num_clients, seed, **kw):
    return (jsc.ScenarioModel(jsc.ScenarioConfig.from_dict(block), num_clients, seed=seed, **kw),
            tsc.ScenarioModel(tsc.ScenarioConfig.from_dict(block), num_clients, seed=seed, **kw))


def _assert_same_trace(jt, tt, where):
    for f in FIELDS:
        a, b = getattr(jt, f), getattr(tt, f)
        if a is None:
            assert b is None, (where, f)
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (where, f)
        np.testing.assert_array_equal(b, a, err_msg=f"{where} {f}")
    assert tt.counts() == jt.counts(), where


def test_trace_config_matches_jax_over_its_50_rounds():
    """The config's population (50 "high" + 50 "low", the runner's trace
    seed 0) round by round: the diurnal phase per device class, the spike
    at rounds 8-10, churn and joins, and label drift all equal JAX's."""
    task, block = _trace_config()
    rounds = task["operatorflow"]["flow_setting"]["round"]
    cls = np.repeat([0, 1], 50)
    jm, tm = _models(block, 100, 0, class_of_client=cls, device_classes=["high", "low"])
    np.testing.assert_array_equal(tm.phase, jm.phase)
    counts = []
    for r in range(rounds):
        jt, tt = jm.round_trace(r), tm.round_trace(r)
        _assert_same_trace(jt, tt, f"round {r}")
        counts.append(tt.counts())
    # What the block exercises: the spike lifts rounds 8-10 above their
    # neighbours' mean availability, clients churn and join, labels drift.
    avail = [c["available"] for c in counts]
    assert np.mean(avail[8:11]) > np.mean(avail[5:8] + avail[11:14])
    assert max(c["churned"] for c in counts) > 0
    assert counts[0]["alive"] < 100  # joiners not yet arrived
    assert 0 < counts[rounds - 1]["drifted"] <= 100


# tests/test_scenario.py's configs, each with the population and seed it
# uses there (and num_classes where drift wraps).
CONFIGS = {
    "oracle": (dict(round_seconds=3600.0, online_base=0.5, online_amp=0.3, peak_hour=10.0,
                    charging_required=True, charging_hours=6.0, leave_rate=0.01,
                    join_frac=0.2, join_rate=0.1,
                    spikes=[{"round": 7, "rounds": 1, "boost": 2.0}]), 500, 3, None),
    "determinism": (dict(online_base=0.5, online_amp=0.4, leave_rate=0.005), 300, 4, None),
    "churn": (dict(leave_rate=0.05, join_frac=0.3, join_rate=0.2), 400, 2, None),
    "offline": (dict(online_base=0.3), 1000, 1, None),
    "spike": (dict(online_base=0.25, spikes=[{"round": 5, "rounds": 2, "boost": 3.0}]),
              2000, 9, None),
    "charging_always": (dict(charging_required=True, charging_hours=24.0), 100, 5, None),
    "charging_never": (dict(charging_required=True, charging_hours=0.0), 100, 5, None),
    "drift": (dict(drift_period_rounds=5), 400, 6, 10),
    "no_drift": ({}, 50, 0, None),
    "empty": (dict(online_base=0.5, leave_rate=0.1), 0, 0, None),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_scenario_configs_match_jax(name):
    block, c, seed, num_classes = CONFIGS[name]
    jm, tm = _models(block, c, seed, num_classes=num_classes)
    for r in (0, 1, 3, 4, 5, 7, 9, 25, 60):
        _assert_same_trace(jm.round_trace(r), tm.round_trace(r), f"{name} round {r}")


def test_combine_traces_matches_jax():
    """A dispatch-strategy trace (sine release with drops) intersected with
    a scenario trace, in both packages, from the same inputs."""
    strategy = {"flow_dispatch": {"use_strategy": True, "total_dispatch_amount": 60,
                                  "specific_timing": {
                                      "use": True, "time_type": "relative",
                                      "timings": [0, 300, 900], "amounts": [20, 20, 20],
                                      "drop_simulation": {"drop_probability": [0.1, 0.2, 0.3]}}}}
    _, block = _trace_config()
    cls = np.repeat([0, 1], 50)
    jm, tm = _models(block, 100, 0, class_of_client=cls, device_classes=["high", "low"])
    for r in (0, 8, 30):
        ja = jtc.compile_trace(strategy, 100, r, task_id="t", operator="train", seed=0)
        ta = ttc.compile_trace(strategy, 100, r, task_id="t", operator="train", seed=0)
        jc = jtc.combine_traces(ja, jm.round_trace(r).as_client_trace())
        tc = ttc.combine_traces(ta, tm.round_trace(r).as_client_trace())
        for f in ("participate", "arrival_time", "dropped"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f), err_msg=f)
        assert (tc.num_released, tc.num_dropped, tc.round_duration()) == \
            (jc.num_released, jc.num_dropped, jc.round_duration())
    with pytest.raises(ValueError) as want:
        jtc.combine_traces(ja, jsc.ScenarioModel(jsc.ScenarioConfig(), 12).round_trace(0)
                           .as_client_trace())
    with pytest.raises(ValueError) as got:
        ttc.combine_traces(ta, tsc.ScenarioModel(tsc.ScenarioConfig(), 12).round_trace(0)
                           .as_client_trace())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", [
    "not a dict",
    {"online_bias": 0.5},
    {"online_base": 1.5},
    {"online_base": -0.1},
    {"online_amp": -1.0},
    {"phase_jitter_hours": -2.0},
    {"charging_hours": -1.0},
    {"round_seconds": 0.0},
    {"day_seconds": -5.0},
    {"leave_rate": 1.0},
    {"join_frac": 1.5},
    {"join_rate": 0.0},
    {"drift_period_rounds": 0},
    {"stream_block_rows": 0},
    {"class_phase_hours": [6.0]},
    {"spikes": ["x"]},
    {"spikes": [{"boost": 2.0}]},
    {"spikes": [{"round": 1, "boots": 2.0}]},
    {"spikes": [{"round": -1}]},
    {"spikes": [{"round": 1, "rounds": 0}]},
    {"spikes": [{"round": 1, "boost": -2.0}]},
])
def test_from_dict_rejects_as_jax(bad):
    with pytest.raises((TypeError, ValueError)) as want:
        jsc.ScenarioConfig.from_dict(bad)
    with pytest.raises(want.type) as got:
        tsc.ScenarioConfig.from_dict(bad)
    assert str(got.value) == str(want.value)


def test_from_dict_round_trip_matches_jax():
    _, block = _trace_config()
    for obj in (block, {}, {"charging_required": 1, "class_phase_hours": {"low": "6"},
                            "spikes": [{"round": "2"}], "stream_block_rows": 64.0}):
        j, t = jsc.ScenarioConfig.from_dict(obj), tsc.ScenarioConfig.from_dict(obj)
        for f in ("round_seconds", "day_seconds", "online_base", "online_amp", "peak_hour",
                  "class_phase_hours", "phase_jitter_hours", "charging_required",
                  "charging_hours", "leave_rate", "join_frac", "join_rate",
                  "drift_period_rounds", "stream_block_rows", "streamed"):
            assert getattr(t, f) == getattr(j, f), f
        assert [(s.round, s.rounds, s.boost) for s in t.spikes] == \
            [(s.round, s.rounds, s.boost) for s in j.spikes]
    assert tsc.ScenarioConfig.from_dict(block).streamed
    assert not tsc.ScenarioConfig().streamed
