"""Whole rounds of the port's engine against the JAX engine on the headline
families (mlp2, cnn4) for every algorithm factory: FedAvg in both sample
modes, FedProx, FedYogi, FedAdagrad, FedAvgM, SCAFFOLD (client and server
controls, partial participation, a take() cohort), Ditto (personal params,
personal_loss and evaluate_personal, with a client that runs no step and
one that does not participate), the bf16 local-SGD carry and bf16 personal
storage; and the round's refusals of misplaced per-client state.

Both sides compute the models in bf16 (the families hard-code it) from the
same parameters, carried over by olearning_sim_tpu_torch.weights, on the
same populations (bf16 features on both sides). JAX draws each client's
minibatch indices from its threefry stream (the global branch from
fold_in(fold_in(base_key, uid), round), Ditto's personal branch from that
key folded with 0x0D1770, then fold_in(key, step) -> randint); the test
recomputes them and hands them to the port's round_step."""

import jax
import jax.numpy as jnp
import numpy as np
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

import torch_threads  # noqa: F401

# bf16 compute on both sides over 2 rounds of 3 local steps: the two differ
# where a bf16 activation or gradient rounds the other way (XLA may also
# keep excess precision across fused bf16 ops), which moves a parameter by
# about lr * |g| * 2^-8 per step. Measured well under these (largest
# about 1e-4 on params and 3e-4 on losses over three FedAvg rounds at
# full width).
PARAM_ATOL = 1e-3
LOSS_ATOL = 2e-3


def _bf16_ulp_at_init_bound(min_fan_in):
    """bf16's ulp at the largest |param| lecun-normal init can draw: the
    truncation at 2 sigma bounds it by 2 / 0.87962566 / sqrt(fan_in)."""
    bound = 2 / 0.87962566 / np.sqrt(min_fan_in)
    return 2.0 ** (np.floor(np.log2(bound)) - 7)


# bf16 carry: the parameters themselves are stepped in bf16, so a step that
# rounds the other way moves a parameter by one bf16 ulp at its own scale.
# Each family's largest parameters lie in the layer of smallest fan-in:
# mlp2's head (32, |p| <= 0.40) and cnn4's first conv (27, |p| <= 0.44),
# both in [0.25, 0.5), where the ulp is 2^-9. Measured: 5e-5 (mlp2) and
# 9.8e-4 (cnn4). A sanity bound only: an f32 carry on mlp2 lands 1.3e-3
# to 2.3e-3 from JAX's bf16-carry params, so MOVED_RTOL decides.
CARRY_PARAM_ATOL = {"mlp2": _bf16_ulp_at_init_bound(32),
                    "cnn4": _bf16_ulp_at_init_bound(27)}
# What a round moved (new - old global params), against JAX's by relative
# L2: the check that decides whether an algorithm term (FedProx) or the
# bf16 carry is implemented. Each case with a control also runs the same
# port round without that term from the same params and draws, which must
# miss JAX's move by more than the limit. Measured over two rounds:
#   mlp2: sound <= 2.6e-4, but 2.1e-3 for SCAFFOLD under the bf16 carry
#         (round 1's carry error reaches round 2 through c_i / (K lr));
#         controls >= 3.2e-2 (FedAvg for FedProx mu 0.5; f32 for the carry:
#         4.5e-2 to 9.2e-2 in FedAvg, SCAFFOLD and Ditto);
#   cnn4: sound <= 7.2e-3 in f32 and 2.2e-2 under the bf16 carry (its bf16
#         convolutions round differently from XLA's, and the carry keeps
#         those differences in the parameters); controls >= 1.7e-1 (f32
#         carry; FedAvg for FedProx mu 5: 2.5e-1).
# Each limit lies between, at least 2.4 times above the family's largest
# sound gap and 2.9 times below its smallest control gap.
MOVED_RTOL = {"mlp2": 5e-3, "cnn4": 6e-2}
SALT = 0x0D1770

SHAPES = {"mlp2": (784,), "cnn4": (16, 16, 3)}
OVERRIDES = {"mlp2": dict(hidden=(32,), num_classes=10),
             "cnn4": dict(features=(8, 16), num_classes=10)}
N_LOCAL, BATCH, STEPS, BLOCK = 10, 4, 3, 4


def _plan():
    return make_mesh_plan(devices=jax.devices()[:1])


def _jax_indices(key_data, uids, num_samples, round_idx, salt=None):
    """The JAX engine's per-client minibatch draw, recomputed."""
    base_key = jax.random.wrap_key_data(key_data)

    def one(uid, n):
        key = jax.random.fold_in(jax.random.fold_in(base_key, uid), jnp.int32(round_idx))
        if salt is not None:
            key = jax.random.fold_in(key, salt)

        def step(i):
            return jax.random.randint(jax.random.fold_in(key, i), (BATCH,), 0,
                                      jnp.maximum(n, 1))

        return jax.vmap(step)(jnp.arange(STEPS))

    return torch.from_numpy(np.array(jax.vmap(one)(jnp.asarray(uids, jnp.int32),
                                                   jnp.asarray(num_samples, jnp.int32))))


def _tcore(family, talgo, **cfg):
    return tfc.build_fedcore(family, talgo, tfc.FedCoreConfig(
        batch_size=BATCH, max_local_steps=STEPS, block_clients=BLOCK, **cfg),
        model_overrides=OVERRIDES[family], input_shape=SHAPES[family], device="cpu")


def _cores(family, jalgo, talgo, **cfg):
    jcfg = {k: (jnp.dtype(str(v).split(".")[-1]) if isinstance(v, torch.dtype) else v)
            for k, v in cfg.items()}
    jcore = jfc.build_fedcore(family, jalgo, _plan(), jfc.FedCoreConfig(
        batch_size=BATCH, max_local_steps=STEPS, block_clients=BLOCK, **jcfg),
        model_overrides=OVERRIDES[family], input_shape=SHAPES[family])
    tcore = _tcore(family, talgo, **cfg)
    jstate = jcore.init_state(jax.random.key(3))
    tstate = tcore.init_state(device="cpu", params=params_from_jax(
        jax.tree.map(np.asarray, jstate.params)))
    return jcore, tcore, jstate, tstate


def _populations(family, num_clients=7, take=None, alpha=0.5):
    """7 real clients with 4..10 samples (Dirichlet label skew), padded to
    8; ``take`` selects a cohort first."""
    out = []
    for mod in (jcd, tcd):
        ds = mod.make_synthetic_dataset(1, num_clients, N_LOCAL, SHAPES[family], 10,
                                        dirichlet_alpha=alpha, num_samples_range=(4, 10))
        out.append(ds if take is None else ds.take(take))
    plan = _plan()
    return out[0].pad_for(plan, BLOCK).place(plan), out[1].pad_for(BLOCK).to("cpu")


def _per_client(tree, c):
    return params_from_jax(jax.tree.map(lambda a: np.asarray(a)[c], tree))


def _compare_tree(tparams, jtree, atol, what="params"):
    ref = params_from_jax(jax.tree.map(np.asarray, jtree))
    assert set(ref) == set(tparams)
    for k, v in ref.items():
        np.testing.assert_allclose(tparams[k].float().numpy(), v.numpy(), atol=atol,
                                   rtol=0, err_msg=f"{what} {k}")


def _compare_per_client(tparams, jtree, C, atol, what):
    for c in range(C):
        ref = _per_client(jtree, c)
        for k, v in ref.items():
            np.testing.assert_allclose(tparams[k][c].float().numpy(), v.numpy(), atol=atol,
                                       rtol=0, err_msg=f"{what} client {c} {k}")


def _compare_metrics(tm, jm, loss_atol=LOSS_ATOL):
    jloss = np.asarray(jm.client_loss)
    tloss = tm.client_loss.numpy()
    np.testing.assert_array_equal(np.isnan(tloss), np.isnan(jloss))
    np.testing.assert_allclose(tloss, jloss, atol=loss_atol, rtol=0)
    np.testing.assert_allclose(float(tm.mean_loss), float(jm.mean_loss), atol=loss_atol)
    np.testing.assert_allclose(float(tm.personal_loss), float(jm.personal_loss),
                               atol=loss_atol)
    assert float(tm.weight_sum) == float(jm.weight_sum)
    assert float(tm.clients_trained) == float(jm.clients_trained)


def _snapshot(jtree):
    """JAX params as torch tensors, copied: round_step donates its state."""
    return params_from_jax(jax.tree.map(np.array, jtree))


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


def _moved_gap(t_new, t_old, j_new, j_old):
    """||(t_new - t_old) - (j_new - j_old)|| / ||j_new - j_old|| over all
    parameters: how far the port's move in a round is from JAX's."""
    num = den = 0.0
    for k, j in j_new.items():
        dj = j - j_old[k]
        num += float(((t_new[k].float() - t_old[k].float()) - dj).pow(2).sum())
        den += float(dj.pow(2).sum())
    return (num / den) ** 0.5


def _check_moved(family, t_new, t_old, j_new, j_old, control=None):
    """The port's move within MOVED_RTOL of JAX's; the control's (params
    after the same round without the term under test) outside it."""
    rtol = MOVED_RTOL[family]
    gap = _moved_gap(t_new, t_old, j_new, j_old)
    assert gap <= rtol, f"moved {gap:.3e} from JAX's move, limit {rtol:g}"
    if control is not None:
        cgap = _moved_gap(control, t_old, j_new, j_old)
        assert cgap > rtol, f"the control moved only {cgap:.3e} from JAX's move"


def _put(plan, a):
    return global_put(np.asarray(a), plan.client_sharding())


def _run_rounds(family, jalgo, talgo, rounds=2, param_atol=PARAM_ATOL, control=None,
                steps=(3, 2, 0, 3, 1, 3, 3, 3), participate=None, **cfg):
    """``rounds`` rounds of a plain (server-optimizer-only) algorithm on
    both engines; client 2 runs no step, client 7 is padding. ``control`` =
    (algorithm, config overrides): a port round that lacks the term under
    test, run each round from the port's params on the same draws."""
    jcore, tcore, jstate, tstate = _cores(family, jalgo, talgo, **cfg)
    if control is not None:
        ccore = _tcore(family, control[0], **dict(cfg, **control[1]))
    jds, tds = _populations(family)
    plan = _plan()
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    steps = np.asarray(steps, np.int32)
    kw_j, kw_t = {"num_steps": _put(plan, steps)}, {"num_steps": torch.from_numpy(steps)}
    if participate is not None:
        kw_j["participate"] = _put(plan, np.asarray(participate, np.float32))
        kw_t["participate"] = torch.tensor(participate, dtype=torch.float32)
    for r in range(rounds):
        idx = _jax_indices(key_data, tds.client_uid.numpy(), tds.num_samples.numpy(), r)
        j_old, t_old = _snapshot(jstate.params), _clone(tstate.params)
        jstate, jm = jcore.round_step(jstate, jds, **kw_j)
        tstate, tm = tcore.round_step(tstate, tds, indices=idx, **kw_t)
        _compare_metrics(tm, jm)
        _compare_tree(tstate.params, jstate.params, param_atol)
        cparams = None
        if control is not None:
            cstate = ccore.init_state(device="cpu", params=t_old)
            cparams = ccore.round_step(cstate, tds, indices=idx, **kw_t)[0].params
        _check_moved(family, tstate.params, t_old, _snapshot(jstate.params), j_old, cparams)
    assert np.isnan(tm.client_loss[2].item())
    return jcore, tcore, jstate, tstate


# -------------------------------------------------------------- FedAvg
@pytest.mark.parametrize("mode", ["gather", "multiplicity"])
@pytest.mark.parametrize("family", ["mlp2", "cnn4"])
def test_fedavg_rounds_match_jax(family, mode):
    jcore, tcore, jstate, tstate = _run_rounds(
        family, jalg.fedavg(0.05), talg.fedavg(0.05), sample_mode=mode)
    x, y = tcd.make_central_eval_set(2, 24, SHAPES[family], 10)
    jl, ja = jcore.evaluate(jstate.params, x, y)
    tl, ta = tcore.evaluate(tstate.params, x, y)
    assert abs(tl - jl) < LOSS_ATOL and abs(ta - ja) <= 1 / 24


# --------------------------------------------------- server optimizers
@pytest.mark.parametrize("family,name,kw", [
    # mu large enough that the proximal pull (lr * mu * |p - w| per step)
    # moves a round well beyond the bf16 noise: the FedAvg control fails.
    ("cnn4", "fedprox", dict(local_lr=0.05, mu=5.0)),
    ("mlp2", "fedprox", dict(local_lr=0.05, mu=0.5)),
    ("mlp2", "fedyogi", dict(local_lr=0.05, server_lr=0.01)),
    ("mlp2", "fedadagrad", dict(local_lr=0.05, server_lr=0.01)),
    ("cnn4", "fedavgm", dict(local_lr=0.05, server_momentum=0.9)),
])
def test_algorithm_rounds_match_jax(family, name, kw):
    control = (talg.fedavg(kw["local_lr"]), {}) if name == "fedprox" else None
    _run_rounds(family, jalg.from_config(name, **kw), talg.from_config(name, **kw),
                participate=[1, 1, 1, 0, 1, 1, 1, 1], control=control)


# ------------------------------------------------------------ bf16 carry
@pytest.mark.parametrize("family,name,mode", [
    ("mlp2", "fedavg", "multiplicity"),
    ("cnn4", "fedprox", "gather"),
])
def test_bf16_carry_rounds_match_jax(family, name, mode):
    _run_rounds(family, jalg.from_config(name), talg.from_config(name),
                param_atol=CARRY_PARAM_ATOL[family], sample_mode=mode,
                carry_dtype=torch.bfloat16,
                control=(talg.from_config(name), {"carry_dtype": None}))


# -------------------------------------------------------------- SCAFFOLD
@pytest.mark.parametrize("carry", [None, torch.bfloat16])
def test_scaffold_rounds_match_jax(carry):
    """A take() cohort of 6 out of a population of 12 (so |S|/N uses N =
    12, not the padded 8 nor the cohort's 6), one non-participant, one
    client that runs no step: c_i, c and the params after two rounds."""
    family = "mlp2"
    jcore, tcore, jstate, tstate = _cores(family, jalg.scaffold(0.05), talg.scaffold(0.05),
                                          carry_dtype=carry)
    cohort = [9, 0, 4, 11, 6, 2]
    jds, tds = _populations(family, num_clients=12, take=cohort)
    assert tds.population == jds.population == 12 and tds.num_clients == 8
    plan = _plan()
    jctl = jcore.init_control(jstate, jds.num_clients)
    tctl = tcore.init_control(tstate, tds.num_clients)
    steps = np.array([3, 0, 2, 3, 3, 1, 3, 3], np.int32)
    part = np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    atol = PARAM_ATOL if carry is None else CARRY_PARAM_ATOL[family]
    # Under the bf16 carry, the control steps the same round in f32.
    ccore = None if carry is None else _tcore(family, talg.scaffold(0.05))
    for r in range(2):
        idx = _jax_indices(key_data, tds.client_uid.numpy(), tds.num_samples.numpy(), r)
        j_old, t_old = _snapshot(jstate.params), _clone(tstate.params)
        t_ctl = tfc.ControlState(_clone(tctl.client_controls), _clone(tctl.server_control))
        kw_t = dict(participate=torch.from_numpy(part), num_steps=torch.from_numpy(steps),
                    indices=idx)
        jstate, jm, jctl = jcore.round_step(jstate, jds, participate=_put(plan, part),
                                            num_steps=_put(plan, steps), control=jctl)
        tstate, tm, tctl = tcore.round_step(tstate, tds, control=tctl, **kw_t)
        _compare_metrics(tm, jm)
        assert float(tm.clients_trained) == 4  # 6 real - 1 absent - 1 no-step
        _compare_tree(tstate.params, jstate.params, atol)
        cparams = None
        if ccore is not None:
            cparams = ccore.round_step(ccore.init_state(device="cpu", params=t_old), tds,
                                       control=t_ctl, **kw_t)[0].params
        _check_moved(family, tstate.params, t_old, _snapshot(jstate.params), j_old, cparams)
        # c_i = -c - delta / (K lr): delta is O(K lr |g|), so the controls
        # carry the params' error divided by K lr.
        _compare_tree(tctl.server_control, jctl.server_control, atol / (STEPS * 0.05),
                      "server control")
        _compare_per_client(tctl.client_controls, jctl.client_controls, 8,
                            atol / 0.05, "client control")
    for k, v in tctl.client_controls.items():
        assert not v[1].any() and not v[3].any(), k  # no step / absent: c_i stays 0
        assert v[0].any(), k
    assert any(v.any() for v in tctl.server_control.values())


# ----------------------------------------------------------------- Ditto
@pytest.mark.parametrize("personal_dtype,carry", [
    (None, None), (torch.bfloat16, None), (torch.bfloat16, torch.bfloat16)],
    ids=["f32", "bf16_personal", "bf16_personal_and_carry"])
def test_ditto_rounds_match_jax(personal_dtype, carry):
    family = "mlp2"
    jcore, tcore, jstate, tstate = _cores(
        family, jalg.ditto(0.05, lam=0.3), talg.ditto(0.05, lam=0.3),
        personal_dtype=personal_dtype, carry_dtype=carry)
    jds, tds = _populations(family)
    plan = _plan()
    jper = jcore.init_personal(jstate, jds.num_clients)
    tper = tcore.init_personal(tstate, tds.num_clients)
    assert all(v.dtype == (personal_dtype or torch.float32) for v in tper.params.values())
    steps = np.array([3, 2, 0, 3, 1, 3, 3, 3], np.int32)  # client 2 runs no step
    part = np.array([1, 1, 1, 1, 0, 1, 1, 1], np.float32)  # client 4 sits out
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    # bf16 storage: a personal param may round to a neighbouring bf16 value
    # (ulp 2^-11 in the hidden layer, |v| <= 0.08, which holds 96% of the
    # parameters) on top of the compute difference.
    atol = PARAM_ATOL if carry is None else CARRY_PARAM_ATOL[family]
    # Under the bf16 carry, the control steps the same round in f32.
    ccore = None if carry is None else _tcore(family, talg.ditto(0.05, lam=0.3),
                                              personal_dtype=personal_dtype)
    before = {k: v.clone() for k, v in tper.params.items()}
    for r in range(2):
        uids, ns = tds.client_uid.numpy(), tds.num_samples.numpy()
        idx = _jax_indices(key_data, uids, ns, r)
        pidx = _jax_indices(key_data, uids, ns, r, salt=SALT)
        j_old, t_old = _snapshot(jstate.params), _clone(tstate.params)
        t_per = tfc.PersonalState(_clone(tper.params))
        kw_t = dict(participate=torch.from_numpy(part), num_steps=torch.from_numpy(steps),
                    indices=idx, personal_indices=pidx)
        jstate, jm, jper = jcore.round_step(jstate, jds, participate=_put(plan, part),
                                            num_steps=_put(plan, steps), personal=jper)
        tstate, tm, tper = tcore.round_step(tstate, tds, personal=tper, **kw_t)
        _compare_metrics(tm, jm)
        assert float(tm.personal_loss) > 0
        _compare_tree(tstate.params, jstate.params, atol)
        cparams = None
        if ccore is not None:
            cparams = ccore.round_step(ccore.init_state(device="cpu", params=t_old), tds,
                                       personal=t_per, **kw_t)[0].params
        _check_moved(family, tstate.params, t_old, _snapshot(jstate.params), j_old, cparams)
        _compare_per_client(tper.params, jper.params, 8, atol + 2.0 ** -11, "personal")
    for k, v in tper.params.items():
        assert v.dtype == before[k].dtype
        assert torch.equal(v[4], before[k][4]) and torch.equal(v[2], before[k][2]), k
        assert not torch.equal(v[0], before[k][0]), k
    jl, ja = jcore.evaluate_personal(jper, jds)
    tl, ta = tcore.evaluate_personal(tper, tds)
    assert abs(tl - jl) < LOSS_ATOL and abs(ta - ja) < 2e-2


@pytest.mark.parametrize("name", ["ditto", "scaffold", "fedavg"])
def test_diverged_client_leaves_no_trace(name):
    """A client whose data is non-finite trains to NaN: the finiteness gate
    drops it from the aggregate, its SCAFFOLD control does not advance and
    its Ditto personal params keep their old values, while the others move."""
    core = _small(talg.from_config(name), personal_dtype=torch.bfloat16)
    host = tcd.make_synthetic_dataset(0, 4, 6, (784,), 10)
    host.x[1, 0, 0] = np.nan
    ds = host.to("cpu")
    st = core.init_state(device="cpu")
    kw = {}
    if name == "ditto":
        kw["personal"] = core.init_personal(st, 4)
    if name == "scaffold":
        kw["control"] = core.init_control(st, 4)
    new, m, *aux = core.round_step(st, ds, **kw)
    assert float(m.clients_trained) == 3 and float(m.weight_sum) == 18.0
    assert np.isnan(m.client_loss[1].item()) and torch.isfinite(m.mean_loss)
    assert all(torch.isfinite(p).all() and not torch.equal(p, st.params[k])
               for k, p in new.params.items())
    if aux:
        before = kw.get("personal", kw.get("control"))
        tree = aux[0].params if name == "ditto" else aux[0].client_controls
        old = before.params if name == "ditto" else before.client_controls
        for k, v in tree.items():
            assert torch.equal(v[1], old[k][1]) and not torch.equal(v[0], old[k][0]), k
            assert torch.isfinite(v).all(), k
        assert torch.isfinite(m.personal_loss)


# --------------------------------------------------------------- refusals
def _small(alg, **cfg):
    return tfc.build_fedcore("mlp2", alg, tfc.FedCoreConfig(
        batch_size=4, max_local_steps=2, block_clients=4, **cfg),
        model_overrides=OVERRIDES["mlp2"], input_shape=(784,), device="cpu")


def test_round_refuses_misplaced_client_state():
    ds = tcd.make_synthetic_dataset(0, 4, 6, (784,), 10).to("cpu")
    avg, sca, dit = (_small(a) for a in (talg.fedavg(), talg.scaffold(), talg.ditto()))
    st = avg.init_state(device="cpu")
    ctl, per = sca.init_control(st, 4), dit.init_personal(st, 4)
    with pytest.raises(ValueError, match="uses control variates"):
        sca.round_step(st, ds)
    with pytest.raises(ValueError, match="is personalized"):
        dit.round_step(st, ds)
    with pytest.raises(ValueError, match="does not use control variates"):
        avg.round_step(st, ds, control=ctl)
    with pytest.raises(ValueError, match="does not use control variates"):
        dit.round_step(st, ds, personal=per, control=ctl)
    with pytest.raises(ValueError, match="not personalized"):
        avg.round_step(st, ds, personal=per)
    with pytest.raises(ValueError, match="not personalized"):
        sca.round_step(st, ds, control=ctl, personal=per)
    with pytest.raises(ValueError, match="not personalized"):
        avg.round_step(st, ds, personal_indices=torch.zeros((4, 2, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="leading client axis"):
        sca.round_step(st, ds, control=sca.init_control(st, 8))
    out = sca.round_step(st, ds, control=ctl)
    assert len(out) == 3 and isinstance(out[2], tfc.ControlState)
    assert len(avg.round_step(st, ds)) == 2


@pytest.mark.parametrize("family", ["mlp2", "cnn4"])
def test_entry_points_refuse_missing_cuda(family, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tfc.build_fedcore(family, talg.scaffold(), input_shape=SHAPES[family])
    with pytest.raises(RuntimeError, match="cuda"):
        tcd.make_synthetic_dataset(0, 2, 3, SHAPES[family], 10).to()
    core = tfc.build_fedcore(family, talg.ditto(), input_shape=SHAPES[family], device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        core.init_state()


def test_algorithm_combinations_refused():
    with pytest.raises(ValueError, match="mutually exclusive"):
        _small(talg.Algorithm("x", 0.05, talg.SGD(1.0), personalized=True,
                              control_variates=True))
    with pytest.raises(ValueError, match="local_lr > 0"):
        _small(talg.scaffold(local_lr=0.0))


@pytest.mark.parametrize("obj", [
    {"carry_dtype": "bf16"}, {"carry_dtype": "bfloat16", "personal_dtype": "f32"},
    {"personal_dtype": "float16"}, {"carry_dtype": None},
])
def test_dtype_knobs_match_jax(obj):
    a, b = jfc.FedCoreConfig.from_dict(obj), tfc.FedCoreConfig.from_dict(obj)
    for k in ("carry_dtype", "personal_dtype"):
        ja, tb = getattr(a, k), getattr(b, k)
        assert (ja is None and tb is None) or str(jnp.dtype(ja)) == str(tb).split(".")[-1]


@pytest.mark.parametrize("bad", [{"carry_dtype": "int32"}, {"personal_dtype": "nope"},
                                 {"carry_dtype": "bool"}])
def test_dtype_knobs_refused(bad):
    with pytest.raises(ValueError):
        jfc.FedCoreConfig.from_dict(bad)
    with pytest.raises(ValueError):
        tfc.FedCoreConfig.from_dict(bad)


# ------------------------------------- rounds of the larger families
# tests/test_torch_{resnet,vit,moe}.py hold resnet18, vit_tiny and moe_text
# against the JAX engine through family_rounds, at small widths.
def family_rounds(family, overrides, shape, jalgo, talgo, *, dtype, rounds, text=False,
                  num_classes=10, controls=(), **cfg):
    """``rounds`` rounds of one family on both engines in the compute
    ``dtype`` ("f32" or "bf16", the flax modules' ``dtype`` override), from
    JAX's init params, on the same 7-client population padded to 8
    (client 2 runs no step, client 4 sits out) and the same minibatch draws.
    ``controls``: (name, port algorithm, config overrides, model overrides),
    each stepped through every round from the port's params on the same
    draws. Returns one record per round: JAX's and the port's params before
    and after, their metrics, the controls' params and, for Ditto, both
    personal states after the round (JAX's as a numpy tree); the run's
    last ``jper``/``tper`` come back beside them."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = {k: (jnp.dtype(str(v).split(".")[-1]) if isinstance(v, torch.dtype) else v)
            for k, v in cfg.items()}
    plan = _plan()
    jcore = jfc.build_fedcore(family, jalgo, plan, jfc.FedCoreConfig(
        batch_size=BATCH, max_local_steps=STEPS, block_clients=BLOCK, **jcfg),
        model_overrides=dict(overrides, dtype=jdt), input_shape=shape)

    def tcore(alg, cfg_over=None, model_over=None):
        return tfc.build_fedcore(family, alg, tfc.FedCoreConfig(
            batch_size=BATCH, max_local_steps=STEPS, block_clients=BLOCK,
            **dict(cfg, **(cfg_over or {}))),
            model_overrides=dict(overrides, dtype=tdt, **(model_over or {})),
            input_shape=shape, device="cpu")

    core = tcore(talgo)
    ccores = [(name, tcore(alg, c_over, m_over)) for name, alg, c_over, m_over in controls]
    jstate = jcore.init_state(jax.random.key(3))
    tstate = core.init_state(device="cpu", params=params_from_jax(
        jax.tree.map(np.asarray, jstate.params)))
    pops = []
    for mod in (jcd, tcd):
        if text:
            pops.append(mod.make_synthetic_text_dataset(
                1, 7, N_LOCAL, shape[0], num_classes, vocab_size=overrides["vocab_size"],
                dirichlet_alpha=0.5, num_samples_range=(4, 10)))
        else:
            pops.append(mod.make_synthetic_dataset(1, 7, N_LOCAL, shape, num_classes,
                                                   dirichlet_alpha=0.5,
                                                   num_samples_range=(4, 10)))
    jds, tds = pops[0].pad_for(plan, BLOCK).place(plan), pops[1].pad_for(BLOCK).to("cpu")
    steps = np.array([3, 2, 0, 3, 1, 3, 3, 3], np.int32)
    part = np.array([1, 1, 1, 1, 0, 1, 1, 1], np.float32)
    kw_j = dict(num_steps=_put(plan, steps), participate=_put(plan, part))
    jper = tper = None
    if talgo.personalized:
        jper = jcore.init_personal(jstate, jds.num_clients)
        tper = core.init_personal(tstate, tds.num_clients)
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    records = []
    for r in range(rounds):
        uids, ns = tds.client_uid.numpy(), tds.num_samples.numpy()
        kw_t = dict(num_steps=torch.from_numpy(steps), participate=torch.from_numpy(part),
                    indices=_jax_indices(key_data, uids, ns, r))
        rec = {"j_old": _snapshot(jstate.params), "t_old": _clone(tstate.params)}
        if talgo.personalized:
            kw_t["personal_indices"] = _jax_indices(key_data, uids, ns, r, salt=SALT)
            p_old = tfc.PersonalState(_clone(tper.params))
            jstate, jm, jper = jcore.round_step(jstate, jds, personal=jper, **kw_j)
            tstate, tm, tper = core.round_step(tstate, tds, personal=tper, **kw_t)
            # JAX's round donates its personal state: keep a host copy.
            rec.update(j_personal=jax.tree.map(np.array, jper.params), t_personal=tper)
        else:
            jstate, jm = jcore.round_step(jstate, jds, **kw_j)
            tstate, tm = core.round_step(tstate, tds, **kw_t)
        rec.update(j_new=_snapshot(jstate.params), t_new=_clone(tstate.params), jm=jm, tm=tm,
                   controls={})
        for name, cc in ccores:
            extra = {"personal": tfc.PersonalState(_clone(p_old.params))} \
                if talgo.personalized else {}
            out = cc.round_step(cc.init_state(device="cpu", params=rec["t_old"]), tds,
                                **kw_t, **extra)
            rec["controls"][name] = (out[0].params, out[2] if extra else None)
        records.append(rec)
    return dict(records=records, jcore=jcore, tcore=core, jds=jds, tds=tds, jper=jper,
                tper=tper)


def real_client_loss_gap(tm, jm, real=7):
    """Largest |port - JAX| client loss over the real clients (NaN where
    both ran no step)."""
    t, j = tm.client_loss.numpy()[:real], np.asarray(jm.client_loss)[:real]
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    ok = ~np.isnan(j)
    return float(np.abs(t[ok] - j[ok]).max())


def tree_rel_gap(a, b):
    """||a - b|| / ||b|| over every leaf of two port param dicts."""
    num = sum(float((a[k].float() - b[k].float()).pow(2).sum()) for k in b)
    den = sum(float(b[k].float().pow(2).sum()) for k in b)
    return (num / den) ** 0.5
