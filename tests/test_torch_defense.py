"""The port's adversarial-client defense (engine/defense.py) and the round's
robustness options (engine/fedcore.py) against the JAX package's:

- the robust aggregators and the Krum-style scores on the same [C, ...]
  arrays and participant masks (n = 0, 1, 2, odd and even; trim 0 and
  0.49), also with the client-axis sort chunked finer than the leaf;
- whole mlp2 rounds with a deadline, an attack, a clip, a trimmed mean with
  scores, a median, and SCAFFOLD with a clip under attack, against the JAX
  engine's on the same params and minibatch indices;
- the attacked runner (sign_flip, scale, label_flip, with and without the
  defense) against the JAX runner on the same task;
- the bitwise-neutral paths inside the port: an inf deadline and an
  all-ones attack give the plain round, a clip disabled by the sentinel the
  unclipped one, and deadline masking the round of an explicit on-time
  participation mask;
- DefenseConfig.from_dict's refusals, with the JAX package's messages."""

import jax
import numpy as np
import pytest
import torch

from olearning_sim_tpu.engine import algorithms as jalg
from olearning_sim_tpu.engine import defense as jdef
from olearning_sim_tpu_torch.engine import algorithms as talg
from olearning_sim_tpu_torch.engine import defense as tdef
from olearning_sim_tpu_torch.engine import fedcore as tfc

import torch_threads  # noqa: F401
from test_torch_fedcore_families import (
    PARAM_ATOL,
    _compare_metrics,
    _compare_per_client,
    _compare_tree,
    _cores,
    _jax_indices,
    _plan,
    _populations,
    _put,
)

# Robust statistics of the same f32 inputs: the sort is exact on both
# sides; only the window's sum (and the scores' sums of squares) may add in
# another order.
AGG_RTOL, AGG_ATOL = 1e-6, 1e-7
C = 9


def _leaf(seed, shape=(C, 4, 5)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mask(n, seed):
    m = np.zeros(C, bool)
    m[np.random.default_rng(seed).choice(C, n, replace=False)] = True
    return m


def _chunk_columns(monkeypatch, chunk):
    """Sort ``chunk`` columns at a time over C clients (None: the default
    budget, which holds every leaf here whole)."""
    if chunk is not None:
        monkeypatch.setattr(tdef, "SORT_CHUNK_BYTES", 4 * C * chunk)
        assert tdef.sort_chunk(C) == chunk


@pytest.mark.parametrize("chunk", [None, 3])
@pytest.mark.parametrize("trim", [0.0, 0.15, 0.49])
@pytest.mark.parametrize("aggregator", ["trimmed_mean", "median"])
@pytest.mark.parametrize("n", [0, 1, 2, 5, 6, 9])
def test_robust_leaf_aggregate_matches_jax(n, aggregator, trim, chunk, monkeypatch):
    _chunk_columns(monkeypatch, chunk)
    leaf, mask = _leaf(n), _mask(n, n + 1)
    # Non-participants may hold anything, non-finite values included.
    leaf[~mask, 0, 0] = np.nan
    want = np.asarray(jdef.robust_leaf_aggregate(
        jax.numpy.asarray(leaf), jax.numpy.asarray(mask), aggregator,
        jax.numpy.float32(trim)))
    got = tdef.robust_leaf_aggregate(torch.from_numpy(leaf), torch.from_numpy(mask),
                                     aggregator, torch.tensor(trim))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=AGG_RTOL, atol=AGG_ATOL)
    if n == 0:
        assert not got.any()


@pytest.mark.parametrize("chunk", [None, 7])
@pytest.mark.parametrize("n", [0, 1, 2, 5, 6])
def test_distance_scores_match_jax(n, chunk, monkeypatch):
    _chunk_columns(monkeypatch, chunk)
    leaves = {"w": _leaf(10 + n), "b": _leaf(20 + n, (C, 3))}
    mask = _mask(n, n)
    jtree = {k: jax.numpy.asarray(v) for k, v in leaves.items()}
    jmask = jax.numpy.asarray(mask)
    jcenter = jdef.robust_aggregate(jtree, jmask, "median", jax.numpy.float32(0.1))
    want = np.asarray(jdef.distance_scores(jtree, jcenter, jmask))
    tleaves = {k: torch.from_numpy(v) for k, v in leaves.items()}
    tmask = torch.from_numpy(mask)
    center = tdef.robust_aggregate(tleaves, tmask, "median", torch.tensor(0.1))
    for k, v in center.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jcenter[k]), rtol=AGG_RTOL,
                                   atol=AGG_ATOL)
    got = tdef.distance_scores(tleaves, center, tmask)
    np.testing.assert_allclose(got.numpy(), want, rtol=AGG_RTOL, atol=AGG_ATOL)
    assert not got[~tmask].any()


def test_sort_chunk_bounds_the_transient():
    assert tdef.sort_chunk(128) * 128 * 4 == tdef.SORT_CHUNK_BYTES
    assert tdef.sort_chunk(1 << 40) == 1


@pytest.mark.parametrize("block", [
    "tight", {"aggregator": "krum"}, {"clip_nrom": 1.0}, {"trim_fraction": 0.7},
    {"anomaly_threshold": -1.0}, {"clip_norm": 0.0}, {"quarantine_after": 0},
    {"clip_norm": 10.0, "aggregator": "trimmed_mean", "trim_fraction": 0.15,
     "anomaly_threshold": 4.0, "quarantine_after": 2, "readmit_after": 5},
])
def test_from_dict_matches_jax(block):
    def parse(mod):
        try:
            return mod.DefenseConfig.from_dict(block)
        except (TypeError, ValueError) as e:
            return type(e), str(e)

    want, got = parse(jdef), parse(tdef)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert got.__dict__ == want.__dict__
        assert ((got.enabled, got.score_enabled, got.gathers_deltas)
                == (want.enabled, want.score_enabled, want.gathers_deltas))


# ------------------------------------------------------------ whole rounds
NUM_CLIENTS = 11  # padded to 12: three blocks of 4
STEPS = np.array([3, 2, 0, 3, 1, 3, 3, 2, 3, 1, 3, 3], np.int32)
PART = np.array([1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 0], np.float32)
COMPLETION = np.array([0.4, 2.5, 0.1, 1.9, 0.3, 0.2, 3.0, 0.9, 1.1, 0.5, 2.2, np.inf],
                      np.float32)
DEADLINE = 2.0
ATTACK = np.array([1, -1, 1, 1, 1, 8, 1, 1, -3, 1, 1, 1], np.float32)
# Scores: L2 distances over all parameters between deltas that both
# engines compute in bf16 from the same params and draws (measured: 2.0e-6
# relative at most over these rounds).
SCORE_RTOL = 1e-5


def _norms(tcore, tstate, tds, idx, **kw):
    """Per-client delta norms of a port round (clip disabled), captured at
    the clip."""
    seen = []
    orig = tfc._clip_client_deltas

    def spy(d32, clip):
        norm2 = sum(v.reshape(v.shape[0], -1).square().sum(dim=1) for v in d32.values())
        seen.append(torch.sqrt(norm2))
        return orig(d32, clip)

    kw = dict(kw, defense=tdef.DefenseConfig(clip_norm=float("inf")))
    tfc._clip_client_deltas = spy
    try:
        tcore.round_step(tstate, tds, indices=idx, **kw)
    finally:
        tfc._clip_client_deltas = orig
    return torch.cat(seen).numpy()


def _clip_between(norms, weights):
    """A clip norm halfway between two neighbouring participant norms at
    their widest relative gap, at least 1e-3 relative from every norm."""
    vals = np.sort(norms[weights > 0])
    gaps = (vals[1:] - vals[:-1]) / vals[1:]
    i = int(np.argmax(gaps[: len(gaps) - 1]))  # leave at least two above
    clip = float((vals[i] + vals[i + 1]) / 2)
    assert np.min(np.abs(norms - clip) / clip) > 1e-3
    return clip


CASES = {
    "plain": {},
    "deadline": {"deadline": True},
    "attack": {"attack": True},
    "clip": {"defense": {"clip": True}},
    "trimmed_mean_scores": {"attack": True, "defense": {
        "clip": True, "aggregator": "trimmed_mean", "trim_fraction": 0.2,
        "anomaly_threshold": 3.0}},
    "median": {"deadline": True, "attack": True, "defense": {"aggregator": "median"}},
    # SCAFFOLD composes with clip only; its control refresh reads the
    # trained delta, not the attacked one the client ships.
    "scaffold_clip": {"scaffold": True, "deadline": True, "attack": True,
                      "defense": {"clip": True}},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_matches_jax(case):
    """Two rounds of each robustness option on both engines; params within
    the family's mlp2 FedAvg tolerance (SCAFFOLD's controls within that
    tolerance over K lr, as in tests/test_torch_fedcore_families.py),
    stragglers and clipped exactly, anomaly scores within SCORE_RTOL."""
    spec = CASES[case]
    name = "scaffold" if spec.get("scaffold") else "fedavg"
    jcore, tcore, jstate, tstate = _cores("mlp2", getattr(jalg, name)(0.05),
                                          getattr(talg, name)(0.05))
    jds, tds = _populations("mlp2", num_clients=NUM_CLIENTS)
    jctl = tctl = None
    if spec.get("scaffold"):
        jctl = jcore.init_control(jstate, jds.num_clients)
        tctl = tcore.init_control(tstate, tds.num_clients)
    plan = _plan()
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    kw_j = {"num_steps": _put(plan, STEPS), "participate": _put(plan, PART)}
    kw_t = {"num_steps": torch.from_numpy(STEPS), "participate": torch.from_numpy(PART)}
    on_time = PART * (COMPLETION <= DEADLINE)
    if spec.get("deadline"):
        kw_j.update(completion_time=_put(plan, COMPLETION), deadline=DEADLINE)
        kw_t.update(completion_time=torch.from_numpy(COMPLETION), deadline=DEADLINE)
    if spec.get("attack"):
        kw_j["attack_scale"] = _put(plan, ATTACK)
        kw_t["attack_scale"] = torch.from_numpy(ATTACK)
    d = dict(spec.get("defense") or {})
    for r in range(2):
        idx = _jax_indices(key_data, tds.client_uid.numpy(), tds.num_samples.numpy(), r)
        if d:
            if d.pop("clip", False) or "clip_norm" in d:
                norms = _norms(tcore, tstate, tds, idx, control=tctl, **kw_t)
                weights = (on_time if spec.get("deadline") else PART) * (STEPS > 0)
                d["clip_norm"] = _clip_between(norms, weights)
            kw_j["defense"] = jdef.DefenseConfig(**d)
            kw_t["defense"] = tdef.DefenseConfig(**d)
        if tctl is None:
            jstate, jm = jcore.round_step(jstate, jds, **kw_j)
            tstate, tm = tcore.round_step(tstate, tds, indices=idx, **kw_t)
        else:
            jstate, jm, jctl = jcore.round_step(jstate, jds, control=jctl, **kw_j)
            tstate, tm, tctl = tcore.round_step(tstate, tds, indices=idx, control=tctl,
                                                **kw_t)
            _compare_tree(tctl.server_control, jctl.server_control, PARAM_ATOL / (3 * 0.05),
                          "server control")
            _compare_per_client(tctl.client_controls, jctl.client_controls, 12,
                                PARAM_ATOL / 0.05, "client control")
        _compare_metrics(tm, jm)
        _compare_tree(tstate.params, jstate.params, PARAM_ATOL)
        assert float(tm.stragglers) == float(jm.stragglers)
        assert float(tm.clipped) == float(jm.clipped)
        jscore = np.asarray(jm.anomaly_score)
        assert tuple(tm.anomaly_score.shape) == jscore.shape
        np.testing.assert_allclose(tm.anomaly_score.numpy(), jscore, rtol=SCORE_RTOL, atol=0)
    if spec.get("deadline"):
        assert float(tm.stragglers) == 3  # clients 1, 6 and 10 are late
    if d.get("clip_norm"):
        assert 0 < float(tm.clipped) < float(tm.clients_trained)
    if d.get("anomaly_threshold"):
        assert (tm.anomaly_score > 0).sum() == float(tm.clients_trained)


def _round(tcore, tstate, tds, idx, **kw):
    state, m = tcore.round_step(tstate, tds, indices=idx, num_steps=torch.from_numpy(STEPS),
                                **kw)
    return state.params, m


def _same(a, b):
    for k in b:
        assert torch.equal(a[k], b[k]), k


def test_neutral_paths_are_bitwise_the_plain_round():
    _, tcore, jstate, tstate = _cores("mlp2", jalg.fedavg(0.05), talg.fedavg(0.05))
    _, tds = _populations("mlp2", num_clients=NUM_CLIENTS)
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    idx = _jax_indices(key_data, tds.client_uid.numpy(), tds.num_samples.numpy(), 0)
    part = torch.from_numpy(PART)
    plain, pm = _round(tcore, tstate, tds, idx, participate=part)
    comp = torch.from_numpy(COMPLETION)
    for kw in (dict(completion_time=comp, deadline=float("inf")),
               dict(attack_scale=torch.ones(12)),
               dict(defense=tdef.DefenseConfig()),  # not enabled: the plain round
               # Scoring on, clip disabled (None, or inf): the sentinel
               # leaves every delta as it was.
               dict(defense=tdef.DefenseConfig(anomaly_threshold=4.0)),
               dict(defense=tdef.DefenseConfig(clip_norm=float("inf")))):
        params, m = _round(tcore, tstate, tds, idx, participate=part, **kw)
        _same(params, plain)
        assert torch.equal(m.mean_loss, pm.mean_loss) and float(m.clipped) == 0
    # Deadline masking is the round of the explicit on-time mask.
    masked, mm = _round(tcore, tstate, tds, idx, participate=part, completion_time=comp,
                        deadline=DEADLINE)
    explicit, em = _round(tcore, tstate, tds, idx,
                          participate=torch.from_numpy(PART * (COMPLETION <= DEADLINE)))
    _same(masked, explicit)
    assert torch.equal(mm.mean_loss, em.mean_loss) and float(mm.stragglers) == 3
    # ...and it is not the plain round.
    assert any(not torch.equal(masked[k], plain[k]) for k in plain)
    # A plain round's metrics carry the defaults.
    assert float(pm.stragglers) == float(pm.clipped) == float(pm.anomaly_score) == 0
    assert pm.anomaly_score.dim() == 0


def test_round_refusals():
    _, tcore, _, tstate = _cores("mlp2", jalg.fedavg(0.05), talg.fedavg(0.05))
    _, tds = _populations("mlp2")
    comp = torch.zeros(8)
    with pytest.raises(ValueError, match="deadline given without completion_time"):
        tcore.round_step(tstate, tds, deadline=1.0)
    with pytest.raises(ValueError, match="completion_time given without a deadline"):
        tcore.round_step(tstate, tds, completion_time=comp)
    scaffold = tfc.build_fedcore("mlp2", talg.scaffold(0.05), tcore.config,
                                 model_overrides={"hidden": (8,), "num_classes": 10},
                                 input_shape=(784,), device="cpu")
    st = scaffold.init_state(device="cpu")
    with pytest.raises(ValueError, match="not supported with control-variate algorithms"):
        scaffold.round_step(st, tds, control=scaffold.init_control(st, 8),
                            defense=tdef.DefenseConfig(aggregator="median"))
    # Clip only composes with SCAFFOLD.
    scaffold.round_step(st, tds, control=scaffold.init_control(st, 8),
                        defense=tdef.DefenseConfig(clip_norm=1.0))


# ---------------------------------------------------- the runner, attacked
DEFENSE = {"clip_norm": 2.0, "aggregator": "trimmed_mean", "trim_fraction": 0.2,
           "anomaly_threshold": 3.0, "quarantine_after": 1, "readmit_after": 2}
ATTACKS = {
    "sign_flip": ({"mode": "sign_flip", "clients": [1, 4, 9]}, DEFENSE),
    "scale": ({"mode": "scale", "factor": -8.0, "clients": [0, 5, 8]}, DEFENSE),
    "label_flip": ({"mode": "label_flip", "fraction": 0.25},
                   {"aggregator": "median", "anomaly_threshold": 2.0}),
    "scale_undefended": ({"mode": "scale", "factor": 4.0, "fraction": 0.2}, None),
}


@pytest.mark.parametrize("mode", sorted(ATTACKS))
def test_attacked_runner_matches_jax(mode):
    """The JAX runner and the port's under the same attack plan (every
    round, or a seeded fraction): the attacked sets, clipped and flagged
    counts, the flagged clients, the quarantine states and the counters
    agree exactly."""
    from test_torch_deadline import compare_with_jax

    payload, defense = ATTACKS[mode]
    chaos = {"seed": 3, "specs": [{"point": "runner.attack_clients", "times": -1,
                                   "payload": payload}]}
    blocks = {"defense": defense} if defense else {}
    _, hist = compare_with_jax(f"attack_{mode}", chaos=chaos,
                               resilience={"failure_policy": "retry"}, **blocks)
    recs = [h["train"]["data_0"] for h in hist]
    assert all(r["attack_mode"] == payload["mode"] for r in recs)
    assert all(r["attacked"] == len(payload.get("clients", [])) or "fraction" in payload
               for r in recs)
    if mode == "scale":
        # Each attacker is clipped or flagged in a round it is released in,
        # and all three, and only they, end up quarantined.
        assert sum(r["clipped"] for r in recs) and sum(r["flagged"] for r in recs) == 3
        assert set(hist[-1]["quarantine_state"]["data_0"]["total"]) == {"0", "5", "8"}
