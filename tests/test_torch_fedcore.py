"""The port's round engine (olearning_sim_tpu_torch.engine) against the JAX
package's: data generators, server optimizers against optax, the config,
the finiteness gate, and whole FedAdam rounds plus evaluation of a small
DistilBERT-shaped model in both sample modes.

JAX draws each client's minibatch indices from its threefry stream
(fold_in(fold_in(fold_in(base_key, uid), round), step) -> randint, as in
olearning_sim_tpu/engine/fedcore.py); the test recomputes those indices
and hands them to the port's round_step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from olearning_sim_tpu.engine import algorithms as jalg
from olearning_sim_tpu.engine import client_data as jcd
from olearning_sim_tpu.engine import fedcore as jfc
from olearning_sim_tpu.parallel.mesh import global_put, make_mesh_plan
from olearning_sim_tpu_torch.engine import algorithms as talg
from olearning_sim_tpu_torch.engine import client_data as tcd
from olearning_sim_tpu_torch.engine import fedcore as tfc
from olearning_sim_tpu_torch.weights import params_from_jax

SMALL = dict(depth=2, width=32, heads=4, mlp_dim=64, vocab_size=97, max_len=16)
SEQ = 16
# f32 on both sides; two rounds of local SGD plus server Adam accumulate
# differences of matmul/reduction order, amplified at most by Adam's
# 1/(sqrt(nu) + eps) normalisation.
PARAM_ATOL, PARAM_RTOL = 2e-6, 1e-5
LOSS_ATOL = 1e-5


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [
    dict(dirichlet_alpha=None),
    dict(dirichlet_alpha=0.8),
    dict(dirichlet_alpha=0.5, num_samples_range=(3, 10), num_classes=3),
])
def test_text_dataset_generator_identical(kw):
    a = jcd.make_synthetic_text_dataset(7, 9, 10, SEQ, vocab_size=97, **kw)
    b = tcd.make_synthetic_text_dataset(7, 9, 10, SEQ, vocab_size=97, **kw)
    for f in ("x", "y", "num_samples", "client_uid", "weight"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.num_real_clients == b.num_real_clients


def test_text_eval_set_identical():
    for ja, tb in zip(jcd.make_central_text_eval_set(3, 50, SEQ, vocab_size=97),
                      tcd.make_central_text_eval_set(3, 50, SEQ, vocab_size=97)):
        np.testing.assert_array_equal(ja, tb)


def test_pad_for_matches_jax():
    plan = make_mesh_plan(devices=jax.devices()[:1])
    a = jcd.make_synthetic_text_dataset(0, 6, 5, SEQ, vocab_size=97).pad_for(plan, 4)
    b = tcd.make_synthetic_text_dataset(0, 6, 5, SEQ, vocab_size=97).pad_for(4)
    assert b.num_clients == 8
    for f in ("x", "y", "num_samples", "client_uid", "weight"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), getattr(b, f))


def test_dataset_to_device():
    ds = tcd.make_synthetic_text_dataset(0, 4, 5, SEQ, vocab_size=97).to("cpu")
    assert ds.x.dtype == torch.int32 and ds.y.dtype == torch.int64
    assert ds.weight.dtype == torch.float32
    assert ds.num_clients == 4 and ds.n_local == 5


# ------------------------------------------------------- server optimizers
def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": (1e-3 * rng.standard_normal((5,))).astype(np.float32)}


@pytest.mark.parametrize("pair", [
    (jalg.fedadam(0.01, 0.001).server_optimizer, talg.fedadam(0.01, 0.001).server_optimizer),
    (optax.adam(0.1), talg.Adam(0.1)),
    (jalg.fedavg(0.05, 1.0).server_optimizer, talg.fedavg(0.05, 1.0).server_optimizer),
    (jalg.fedavg(0.05, 0.5, 0.9).server_optimizer, talg.fedavg(0.05, 0.5, 0.9).server_optimizer),
], ids=["fedadam", "adam", "fedavg", "fedavgm"])
def test_server_optimizer_matches_optax(pair):
    jopt, topt = pair
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _tree(step + 1)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts)
        tp = {k: p + tu[k] for k, p in tp.items()}
        for k in params:
            # f32 elementwise formulas in the same order; XLA's fused pow,
            # sqrt and division differ from torch's by a few ulps of the
            # update (up to ~3e-8 on an update of lr = 0.1) per step.
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=2e-6)


# ------------------------------------------------------------------ config
def test_config_from_dict_matches_jax():
    obj = {"batch_size": 8, "max_local_steps": 2, "block_clients": 4,
           "eval_batch_size": 32, "sample_mode": "gather"}
    a, b = jfc.FedCoreConfig.from_dict(obj), tfc.FedCoreConfig.from_dict(obj)
    for k in obj:
        assert getattr(a, k) == getattr(b, k)
    for n_local in (8, 16, 17, 40):
        assert (jfc.FedCoreConfig(batch_size=8).use_multiplicity(n_local)
                == tfc.FedCoreConfig(batch_size=8).use_multiplicity(n_local))


@pytest.mark.parametrize("bad", [{"batch_sise": 4}, {"sample_mode": "x"},
                                 {"block_clients": 0}])
def test_config_rejects_bad_input(bad):
    with pytest.raises(ValueError):
        tfc.FedCoreConfig.from_dict(bad)


def test_finite_client_mask_matches_jax():
    losses = np.array([0.5, np.nan, 1.0, 2.0, np.inf], np.float32)
    d = np.ones((5, 3, 2), np.float32)
    d[2, 1, 0] = np.nan
    d[3, 0, 1] = -np.inf
    e = np.ones((5, 4), np.float32)
    ref = np.asarray(jfc._finite_client_mask(jnp.asarray(losses),
                                             {"d": jnp.asarray(d), "e": jnp.asarray(e)}))
    out = tfc._finite_client_mask(torch.from_numpy(losses),
                                  {"d": torch.from_numpy(d), "e": torch.from_numpy(e)})
    np.testing.assert_array_equal(out.numpy(), ref)
    assert ref.tolist() == [True, False, False, False, False]


# ------------------------------------------------------------- the round
def _jax_indices(key_data, uids, num_samples, round_idx, steps, batch):
    """The JAX engine's per-client minibatch draw, recomputed."""
    base_key = jax.random.wrap_key_data(key_data)

    def one(uid, n):
        key = jax.random.fold_in(jax.random.fold_in(base_key, uid), jnp.int32(round_idx))

        def step(i):
            return jax.random.randint(jax.random.fold_in(key, i), (batch,), 0,
                                      jnp.maximum(n, 1))

        return jax.vmap(step)(jnp.arange(steps))

    return np.array(jax.vmap(one)(jnp.asarray(uids, jnp.int32),
                                  jnp.asarray(num_samples, jnp.int32)))


def _compare_params(tparams, jparams):
    ref = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert set(ref) == set(tparams)
    for k, v in ref.items():
        np.testing.assert_allclose(tparams[k].numpy(), v.numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=k)


@pytest.mark.parametrize("mode", ["gather", "multiplicity"])
def test_fedadam_rounds_match_jax(mode):
    cfg = dict(batch_size=4, max_local_steps=3, block_clients=4, sample_mode=mode,
               eval_batch_size=16)
    plan = make_mesh_plan(devices=jax.devices()[:1])
    jcore = jfc.build_fedcore("distilbert", jalg.fedadam(0.05, 0.01), plan,
                              jfc.FedCoreConfig(**cfg),
                              model_overrides=dict(SMALL, dtype=jnp.float32),
                              input_shape=(SEQ,))
    tcore = tfc.build_fedcore("distilbert", talg.fedadam(0.05, 0.01),
                              tfc.FedCoreConfig(**cfg),
                              model_overrides=dict(SMALL, dtype=torch.float32),
                              device="cpu")
    jstate = jcore.init_state(jax.random.key(0))
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    tstate = tcore.init_state(device="cpu", params=params_from_jax(
        jax.tree.map(np.asarray, jstate.params)))

    # 7 real clients with 3..10 samples, padded to 8; per-client step
    # counts include a client that runs no step (NaN loss, weight 0).
    host = tcd.make_synthetic_text_dataset(1, 7, 10, SEQ, vocab_size=97,
                                           dirichlet_alpha=0.8,
                                           num_samples_range=(3, 10))
    jds = jcd.make_synthetic_text_dataset(1, 7, 10, SEQ, vocab_size=97,
                                          dirichlet_alpha=0.8,
                                          num_samples_range=(3, 10))
    jds = jds.pad_for(plan, 4).place(plan)
    tds = host.pad_for(4).to("cpu")
    steps = np.array([3, 2, 0, 3, 1, 3, 3, 3], np.int32)
    jsteps = global_put(steps, plan.client_sharding())

    for r in range(2):
        idx = _jax_indices(key_data, tds.client_uid.numpy(),
                           tds.num_samples.numpy(), r, 3, 4)
        jstate, jm = jcore.round_step(jstate, jds, num_steps=jsteps)
        tstate, tm = tcore.round_step(tstate, tds, num_steps=torch.from_numpy(steps),
                                      indices=torch.from_numpy(idx))
        jloss = np.asarray(jm.client_loss)
        assert np.isnan(jloss[2]) and np.isnan(tm.client_loss[2].item())
        np.testing.assert_allclose(tm.client_loss.numpy(), jloss, atol=LOSS_ATOL, rtol=0)
        np.testing.assert_allclose(float(tm.mean_loss), float(jm.mean_loss), atol=LOSS_ATOL)
        assert float(tm.weight_sum) == float(jm.weight_sum)
        assert float(tm.clients_trained) == float(jm.clients_trained) == 6
        _compare_params(tstate.params, jstate.params)
    assert tstate.round_idx == int(jstate.round_idx) == 2

    x, y = tcd.make_central_text_eval_set(2, 40, SEQ, vocab_size=97)
    jl, ja = jcore.evaluate(jstate.params, x, y)
    tl, ta = tcore.evaluate(tstate.params, x, y)
    assert abs(tl - jl) < LOSS_ATOL and abs(ta - ja) < 1e-6


def test_flash_evaluate_matches_jax():
    plan = make_mesh_plan(devices=jax.devices()[:1])
    ov = dict(SMALL, attention_impl="flash")
    jcore = jfc.build_fedcore("distilbert", jalg.fedadam(), plan,
                              jfc.FedCoreConfig(eval_batch_size=16),
                              model_overrides=dict(ov, dtype=jnp.float32),
                              input_shape=(SEQ,))
    tcore = tfc.build_fedcore("distilbert", talg.fedadam(),
                              tfc.FedCoreConfig(eval_batch_size=16),
                              model_overrides=dict(ov, dtype=torch.float32), device="cpu")
    jparams = jcore.init_state(jax.random.key(5)).params
    tparams = tcore.init_state(device="cpu", params=params_from_jax(
        jax.tree.map(np.asarray, jparams))).params
    x, y = tcd.make_central_text_eval_set(4, 40, SEQ, vocab_size=97)
    x[3, 5:] = 0  # padding, and one row that is all padding
    x[7, :] = 0
    jl, ja = jcore.evaluate(jparams, x, y)
    tl, ta = tcore.evaluate(tparams, x, y)
    assert abs(tl - jl) < LOSS_ATOL and abs(ta - ja) < 1e-6


def _small_core(**cfg):
    return tfc.build_fedcore(
        "distilbert", talg.fedadam(0.05, 0.01),
        tfc.FedCoreConfig(batch_size=4, max_local_steps=2, block_clients=4, **cfg),
        model_overrides=dict(SMALL, dtype=torch.float32), device="cpu")


def test_round_is_deterministic_from_seed():
    ds = tcd.make_synthetic_text_dataset(0, 8, 6, SEQ, vocab_size=97).to("cpu")
    out = []
    for _ in range(2):
        core = _small_core()
        state = core.init_state(seed=3, device="cpu")
        state, m = core.round_step(state, ds)
        out.append((state.params, m.client_loss))
    assert all(torch.equal(out[0][0][k], out[1][0][k]) for k in out[0][0])
    assert torch.equal(out[0][1], out[1][1])
    assert torch.isfinite(out[0][1]).all()


def test_draw_indices_in_range():
    core = _small_core()
    ns = torch.tensor([1, 2, 5, 0])
    idx = core.draw_indices(torch.Generator().manual_seed(0), ns)
    assert tuple(idx.shape) == (4, 2, 4)
    assert int(idx.min()) >= 0
    assert (idx.amax(dim=(1, 2)) < torch.clamp(ns, min=1)).all()
    assert (idx[0] == 0).all() and (idx[3] == 0).all()


def test_participate_zero_excludes_client():
    ds = tcd.make_synthetic_text_dataset(0, 4, 6, SEQ, vocab_size=97).to("cpu")
    core = _small_core()
    state = core.init_state(seed=0, device="cpu")
    _, m = core.round_step(state, ds, participate=torch.tensor([1.0, 0.0, 1.0, 1.0]))
    assert float(m.clients_trained) == 3
    assert float(m.weight_sum) == 18.0


def test_round_rejects_unpadded_population():
    ds = tcd.make_synthetic_text_dataset(0, 6, 6, SEQ, vocab_size=97).to("cpu")
    core = _small_core()
    with pytest.raises(ValueError, match="pad_for"):
        core.round_step(core.init_state(device="cpu"), ds)


def test_entry_points_refuse_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tfc.build_fedcore("distilbert", talg.fedadam(), model_overrides=SMALL)
    core = _small_core()
    with pytest.raises(RuntimeError, match="cuda"):
        core.init_state()
    with pytest.raises(RuntimeError, match="cuda"):
        tcd.make_synthetic_text_dataset(0, 2, 3, SEQ, vocab_size=97).to()
