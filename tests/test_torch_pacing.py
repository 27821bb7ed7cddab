"""The port's engine/pacing.py against the JAX package's: the same seeded
inputs give exactly the same completion times, cohorts, round closes,
arrival ranks and adaptive-controller states (tolerance: none, bitwise),
and a malformed config is refused with the same error."""

import numpy as np
import pytest

from olearning_sim_tpu.engine import pacing as jp
from olearning_sim_tpu_torch.engine import pacing as tp

import torch_threads  # noqa: F401

CLASSES = ["high", "low", "mid"]  # "mid" is listed in no speed profile


def _cfgs(**kw):
    return jp.DeadlineConfig(**kw), tp.DeadlineConfig(**kw)


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    arrival = rng.uniform(0.0, 3.0, n).astype(np.float32)
    arrival[rng.random(n) < 0.1] = np.inf  # never released
    steps = rng.integers(0, 11, n).astype(np.int32)
    cls = rng.integers(0, len(CLASSES), n)
    eligible = rng.random(n) < 0.8
    return arrival, steps, cls, eligible


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("jitter", [0.0, 0.3])
def test_completion_times_match(seed, jitter):
    kw = dict(speed_profiles={"high": 0.05, "low": 0.5}, default_step_s=0.2,
              jitter=jitter)
    jc, tc = _cfgs(**kw)
    arrival, steps, cls, _ = _inputs(seed, 37)
    for rnd, stream in ((0, 0), (3, 12345), (17, 2**31 + 7)):
        want = jp.completion_times(arrival, steps, cls, CLASSES, jc, seed, rnd, stream)
        got = tp.completion_times(arrival, steps, cls, CLASSES, tc, seed, rnd, stream)
        _equal(got, want)
    # No device classes at all: default_step_s for everyone.
    _equal(tp.completion_times(arrival, steps, cls, [], tc, seed, 1),
           jp.completion_times(arrival, steps, cls, [], jc, seed, 1))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k,alpha", [(None, 0.0), (5, 0.25), (12, 0.5), (40, 0.3)])
def test_cohort_close_and_ranks_match(seed, k, alpha):
    """Over-selection, the K-th-arrival close and the arrival ranks; K = 40
    asks for more clients than are eligible (the cohort is then shorter
    than K and the close is the controller's)."""
    jc, tc = _cfgs(target_cohort=k, over_selection=alpha, speed_profiles={"high": 0.05},
                   jitter=0.1)
    arrival, steps, cls, eligible = _inputs(100 + seed, 31)
    for rnd in range(3):
        jsel = jp.select_cohort(eligible, jc, seed, rnd, stream=9)
        tsel = tp.select_cohort(eligible, tc, seed, rnd, stream=9)
        _equal(tsel, jsel)
        comp = jp.completion_times(arrival, steps, cls, CLASSES, jc, seed, rnd)
        comp = np.where(jsel, comp, np.inf).astype(np.float32)
        for ctrl in (float("inf"), 1.25, 0.01):
            assert (tp.effective_deadline(comp, tsel, tc, ctrl)
                    == jp.effective_deadline(comp, jsel, jc, ctrl))
        _equal(tp.arrival_ranks(comp, tsel), jp.arrival_ranks(comp, jsel))
        dl = jp.effective_deadline(comp, jsel, jc, 1.25)
        jpace = jp.RoundPacing(jsel, comp, dl, int(jsel.sum()),
                               int((jsel & (comp <= dl)).sum()), 3)
        tpace = tp.RoundPacing(tsel, comp, dl, int(tsel.sum()),
                               int((tsel & (comp <= dl)).sum()), 3)
        assert (tpace.round_close_s(), tpace.quorum_met, tpace.n_stragglers) == (
            jpace.round_close_s(), jpace.quorum_met, jpace.n_stragglers)
    if k == 40:
        assert int(tsel.sum()) == int(eligible.sum()) < k


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("deadline_s", [None, 2.0])
def test_controller_matches(adaptive, deadline_s):
    kw = dict(deadline_s=deadline_s, adaptive=adaptive, target_completion_fraction=0.85,
              ema_beta=0.3, margin=1.1, min_deadline_s=0.05, max_deadline_s=4.0)
    jc, tc = _cfgs(**kw)
    jctl, tctl = jp.DeadlineController(jc), tp.DeadlineController(tc)
    history = []
    for seed in range(6):
        comp = _inputs(seed, 23)[0] * np.float32(1 + seed)
        if seed == 3:
            comp[:] = np.inf  # nothing finite: no update
        assert tctl.current_deadline() == jctl.current_deadline()
        jctl.observe(comp)
        tctl.observe(comp)
        assert tctl.state_dict() == jctl.state_dict()
        history.append({"round": seed, "pacing": tctl.state_dict()})
    replay_t, replay_j = tp.DeadlineController(tc), jp.DeadlineController(jc)
    replay_t.load_from_history(history[:4] + [{"round": 4}])
    replay_j.load_from_history(history[:4] + [{"round": 4}])
    assert replay_t.state_dict() == replay_j.state_dict() == history[3]["pacing"]
    replay_t.load_from_history([])
    assert replay_t.state_dict() == {"ema": None}


@pytest.mark.parametrize("block", [
    {"deadline_s": 1.5, "over_selection": 0.25, "target_cohort": 60,
     "quorum_fraction": 0.4, "speed_profiles": {"high": 0.05, "low": 0.5},
     "adaptive": True, "target_completion_fraction": 0.85},
    {"quorum_fracton": 0.5},
    {"quorum_fraction": 1.5},
    {"over_selection": -0.1},
    {"target_cohort": 0},
    {"min_deadline_s": 2.0, "max_deadline_s": 1.0},
    {"ema_beta": 0.0},
    "tight",
])
def test_from_dict_matches(block):
    def parse(mod):
        try:
            return mod.DeadlineConfig.from_dict(block)
        except (TypeError, ValueError) as e:
            return type(e), str(e)

    want, got = parse(jp), parse(tp)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert got.__dict__ == want.__dict__ and got.enabled == want.enabled
