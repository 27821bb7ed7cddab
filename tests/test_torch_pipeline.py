"""The port's pipeline parallelism over gloo ranks (pp 2, at dp 1 on two
ranks and dp 2 on four), against the JAX package's at pp 2 (two of
conftest's eight virtual CPU devices) and the port's dense model:

- ``stack_block_params`` / ``unstack_block_params`` round trips, exact;
- ``pp_forward`` (GPipe, M microbatches) against JAX's ``pp_forward`` and
  the dense forward;
- ``pp_train_step`` (two SGD steps) against JAX's and the dense step: the
  port's gradients carry no ``check_vma=False`` factor (JAX's
  ``parallel/scale_check.py``), so they are held against the dense
  gradient directly;
- the pipelined round (FedAvg, FedProx, FedAdam, and FedAvg at 3
  microbatches of 6-row minibatches) against JAX's pp-2 round, with
  ``evaluate`` on an eval set of 12 rows and one of 13 (a batch that no
  microbatch count divides: evaluation runs the dense model, as JAX's);
- every refusal of ``validate_pp_build``, ``pp_forward`` and the round's
  launch against JAX's on the same input.

f32 compute on both sides, held to tests/test_torch_fedcore.py's
tolerances: only the order of summation differs. The ranks run once per
world size for the module (tests/test_torch_dp.py's harness); this module
imports no JAX at its top."""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_dp import one_thread, run_ranks
from test_torch_tp import (
    BATCH,
    BLOCK,
    LOSS_ATOL,
    N_LOCAL,
    NUM,
    PADDED,
    SEQ,
    TEXT,
    _close,
    _jax_core,
    _jax_flat,
    _jax_indices,
    _params,
    _population,
    _tree,
    _tcore,
)

PP = 2
ROUNDS = 2
LR = 0.1
CASES = {"fedavg": {}, "fedprox": {"algorithm": "fedprox"}, "fedadam": {"algorithm": "fedadam"},
         "fedavg_m3": {"microbatches": 3, "batch": 6}}
EVAL_N, EVAL_ODD_N = 12, 13
STEP_BATCH = 8


def _dense_model():
    from olearning_sim_tpu_torch.models import get_model

    return get_model("distilbert").build(**TEXT, dtype=torch.float32)


def _tokens():
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, TEXT["vocab_size"], (STEP_BATCH, SEQ)).astype(np.int32)
    tokens[2, 5:] = 0
    tokens[5, 3:] = 0
    return tokens, (tokens[:, 0] % TEXT["num_classes"]).astype(np.int64)


def run_case(case, inp, plan):
    """Two pipelined rounds of ``case`` from JAX's init params and draws."""
    spec = CASES[case]
    core = _tcore(spec, plan, microbatches=spec.get("microbatches") if plan.pp > 1 else None)
    ds = _population().pad_for(plan.dp * BLOCK).shard(plan).to("cpu")
    state = core.init_state(device="cpu", params=_params(inp))
    out = {}
    for r in range(ROUNDS):
        idx = inp[f"idx{spec.get('batch', BATCH)}/{r}"]
        state, m = core.round_step(state, ds, indices=torch.from_numpy(idx))
        out.update({f"{r}/p/{k}": v.numpy() for k, v in state.params.items()})
        for f in ("mean_loss", "weight_sum", "clients_trained", "client_loss"):
            out[f"{r}/m/{f}"] = getattr(m, f).numpy()
    for key, n in (("eval", EVAL_N), ("eval_odd", EVAL_ODD_N)):
        out[key] = np.array(core.evaluate(state.params, *_eval_set(n)))
    return out


def _eval_set(n):
    from olearning_sim_tpu_torch.engine.client_data import make_central_text_eval_set

    return make_central_text_eval_set(4, n, SEQ, vocab_size=TEXT["vocab_size"])


def run_steps(inp, plan):
    """pp_forward, then two pp_train_step SGD steps."""
    from olearning_sim_tpu_torch.engine.algorithms import SGD
    from olearning_sim_tpu_torch.parallel import pipeline
    from olearning_sim_tpu_torch.weights import unstack_block_params

    model = _dense_model()
    tokens, labels = _tokens()
    params = _params(inp)
    out = {"forward": pipeline.pp_forward(model, params, tokens, plan).numpy(),
           "forward_m4": pipeline.pp_forward(model, params, tokens, plan,
                                             num_microbatches=4 // plan.dp).numpy()}
    rest, stacked = pipeline.pp_place_params(params, plan)
    opt = SGD(LR)
    opt_state = opt.init(pipeline.pp_tree(rest, stacked))
    for s in range(2):
        rest, stacked, opt_state, loss = pipeline.pp_train_step(
            model, rest, stacked, opt_state, tokens, labels, opt, plan)
        out[f"loss/{s}"] = np.float32(loss)
    from olearning_sim_tpu_torch.parallel import collectives

    full = {k: collectives.all_gather([v], plan.pp_group, dim=0)[0]
            for k, v in stacked.items()}
    out.update({f"step/{k}": v.numpy() for k, v in unstack_block_params(rest, full).items()})
    return out


def _pp_job(rank, world, inp):
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    plan = make_mesh_plan(pp=PP)
    assert plan.pp == PP and plan.dp == world // PP and plan.pp_rank == rank % PP
    out = run_steps(inp, plan)
    for case in CASES:
        out.update({f"{case}/{k}": v for k, v in run_case(case, inp, plan).items()})
    return out


# ------------------------------------------------------------------ inputs
@pytest.fixture(scope="module")
def inputs():
    import jax

    from olearning_sim_tpu.parallel.mesh import make_mesh_plan as jplan
    from olearning_sim_tpu_torch.weights import params_from_jax

    jstate = _jax_core({}, jplan(devices=jax.devices()[:1])).init_state(jax.random.key(3))
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    ds = _population().pad_for(BLOCK)
    assert ds.padded_clients == PADDED
    uids, ns = np.asarray(ds.client_uid), np.asarray(ds.num_samples)
    inp = {f"p/{k}": v.numpy() for k, v in params.items()}
    for r in range(ROUNDS):
        for batch in sorted({c.get("batch", BATCH) for c in CASES.values()}):
            inp[f"idx{batch}/{r}"] = _jax_indices(key_data, uids, ns, r, batch=batch)
    return inp


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return {world: run_ranks(__name__, "_pp_job", world, inputs,
                             tmp_path_factory.mktemp(f"pp_{world}"))
            for world in (PP, 2 * PP)}


@pytest.fixture(scope="module")
def dense(inputs):
    """The port's dense forward, SGD steps and pp-1 rounds, in this process
    on one thread."""
    import torch.nn.functional as F
    from torch.func import functional_call

    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    model = _dense_model()
    tokens, labels = _tokens()
    tok = torch.from_numpy(tokens).long()
    params = _params(inputs)
    out = {}
    with one_thread():
        out["forward"] = functional_call(model, params, (tok,)).detach().numpy()
        for s in range(2):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = F.cross_entropy(functional_call(model, leaves, (tok,)),
                                   torch.from_numpy(labels))
            grads = torch.autograd.grad(loss, list(leaves.values()))
            params = {k: (v - LR * g).detach() for (k, v), g in zip(leaves.items(), grads)}
            out[f"loss/{s}"] = float(loss.detach())
        out.update({f"step/{k}": v.numpy() for k, v in params.items()})
        plan = make_mesh_plan()
        for case in CASES:
            out.update({f"{case}/{k}": v for k, v in run_case(case, inputs, plan).items()})
    return out


_JAX = {}


def _jax_round(case, inputs):
    """Two rounds of ``case`` on the JAX engine's pipelined program at pp 2."""
    if case in _JAX:
        return _JAX[case]
    import jax

    from olearning_sim_tpu.engine import client_data as jcd
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan

    plan = make_mesh_plan(devices=jax.devices()[:PP], pp=PP)
    jcore = _jax_core(CASES[case], plan, microbatches=CASES[case].get("microbatches"))
    jstate = jcore.init_state(jax.random.key(3))
    jds = jcd.make_synthetic_text_dataset(
        5, NUM, N_LOCAL, SEQ, vocab_size=TEXT["vocab_size"], dirichlet_alpha=0.5,
        num_samples_range=(3, N_LOCAL)).pad_for(plan, BLOCK).place(plan)
    out = {"state": [], "metrics": []}
    for _ in range(ROUNDS):
        jstate, jm = jcore.round_step(jstate, jds)
        out["state"].append(jax.tree.map(np.array, jstate.params))
        out["metrics"].append(jax.tree.map(np.asarray, jm))
    for key, n in (("eval", EVAL_N), ("eval_odd", EVAL_ODD_N)):
        out[key] = jcore.evaluate(jstate.params, *_eval_set(n))
    _JAX[case] = out
    return out


# ------------------------------------------------------------------- checks
def test_stack_unstack_round_trip_is_exact():
    from olearning_sim_tpu_torch.weights import stack_block_params, unstack_block_params

    params = _dense_model().init_params(torch.Generator().manual_seed(0))
    rest, stacked = stack_block_params(params)
    assert all(v.shape[0] == TEXT["depth"] for v in stacked.values())
    back = unstack_block_params(rest, stacked)
    assert set(back) == set(params)
    assert all(torch.equal(back[k], params[k]) for k in params)


@pytest.mark.parametrize("world", [PP, 2 * PP])
def test_pp_forward_matches_jax_and_dense(world, ranks, inputs, dense):
    """pp_forward at pp 2 (M = 2 and M = 4 microbatches over the dp shard)
    against JAX's pp_forward of the same params and the dense forward."""
    import jax
    import jax.numpy as jnp

    from olearning_sim_tpu.models import get_model
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu.parallel.pipeline import pp_forward
    from olearning_sim_tpu_torch.weights import params_to_jax

    tokens, _ = _tokens()
    jmodel = get_model("distilbert").build(**TEXT, dtype=jnp.float32)
    jparams = params_to_jax(_params(inputs), heads=TEXT["heads"])
    want = np.asarray(pp_forward(jmodel, jparams, tokens,
                                 make_mesh_plan(devices=jax.devices()[:PP], pp=PP)))
    for res in ranks[world]:
        for key in ("forward", "forward_m4"):
            np.testing.assert_allclose(res[key], want, atol=LOSS_ATOL, rtol=0, err_msg=key)
            np.testing.assert_allclose(res[key], dense["forward"], atol=LOSS_ATOL, rtol=0)


@pytest.mark.parametrize("world", [PP, 2 * PP])
def test_pp_train_step_matches_jax_and_dense(world, ranks, inputs, dense):
    """Two pp_train_step SGD steps land where JAX's pp_train_step and the
    dense SGD steps land: no gradient factor to undo."""
    import jax
    import jax.numpy as jnp
    import optax

    from olearning_sim_tpu.models import get_model
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu.parallel.pipeline import (
        pp_place_params,
        pp_train_step,
        unstack_block_params,
    )
    from olearning_sim_tpu_torch.weights import params_to_jax

    tokens, labels = _tokens()
    jmodel = get_model("distilbert").build(**TEXT, dtype=jnp.float32)
    plan = make_mesh_plan(devices=jax.devices()[:PP], pp=PP)
    rest, stacked = pp_place_params(params_to_jax(_params(inputs), heads=TEXT["heads"]), plan)
    opt = optax.sgd(LR)
    opt_state = opt.init((rest, stacked))
    jloss = []
    for _ in range(2):
        rest, stacked, opt_state, loss = pp_train_step(
            jmodel, rest, stacked, opt_state, tokens, labels.astype(np.int32), opt, plan)
        jloss.append(float(loss))
    want = _jax_flat(unstack_block_params(jax.device_get(rest), jax.device_get(stacked)))
    for res in ranks[world]:
        _close(_tree(res, "step/"), want, "pp_train_step vs JAX")
        _close(_tree(res, "step/"), _tree(dense, "step/"), "pp_train_step vs dense")
        for s in range(2):
            assert abs(float(res[f"loss/{s}"]) - jloss[s]) < LOSS_ATOL
            assert abs(float(res[f"loss/{s}"]) - dense[f"loss/{s}"]) < LOSS_ATOL


@pytest.mark.parametrize("world", [PP, 2 * PP])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pp2_round_matches_jax_pp2(case, world, ranks, inputs, dense):
    """The pipelined round: every rank the same, JAX's pp-2 round within
    the f32 tolerances, and the port's pp-1 round to summation order; its
    evaluate against JAX's on 12 rows and on 13."""
    results = [{k[len(case) + 1:]: v for k, v in r.items() if k.startswith(case + "/")}
               for r in ranks[world]]
    for other in results[1:]:
        for k in results[0]:
            assert np.array_equal(other[k], results[0][k], equal_nan=True), k
    mine = results[0]
    ref = _jax_round(case, inputs)
    mp1 = {k[len(case) + 1:]: v for k, v in dense.items() if k.startswith(case + "/")}
    for r in range(ROUNDS):
        _close(_tree(mine, f"{r}/p/"), _jax_flat(ref["state"][r]), f"round {r} vs JAX")
        _close(_tree(mine, f"{r}/p/"), _tree(mp1, f"{r}/p/"), f"round {r} vs pp 1")
        jm = ref["metrics"][r]
        tl, jl = mine[f"{r}/m/client_loss"], np.asarray(jm.client_loss)
        np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
        np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL, rtol=0)
        np.testing.assert_allclose(mine[f"{r}/m/mean_loss"], np.asarray(jm.mean_loss),
                                   atol=LOSS_ATOL, rtol=0)
        for f in ("weight_sum", "clients_trained"):
            assert float(mine[f"{r}/m/{f}"]) == float(getattr(jm, f)), f
    for key in ("eval", "eval_odd"):
        jl, ja = ref[key]
        assert abs(mine[key][0] - jl) < LOSS_ATOL and abs(mine[key][1] - ja) < 1e-6, key


def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_pp_refusals_match_jax():
    """validate_pp_build, pp_forward's validation and the pipelined round's
    launch refuse what JAX's refuse, in its words."""
    import jax
    import jax.numpy as jnp

    from olearning_sim_tpu.engine import algorithms as jalg
    from olearning_sim_tpu.engine import fedcore as jfc
    from olearning_sim_tpu.engine import pp_rounds as jpp
    from olearning_sim_tpu.models import get_model as jget
    from olearning_sim_tpu.parallel import pipeline as jpl
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan as jplan
    from olearning_sim_tpu_torch.engine import algorithms as talg
    from olearning_sim_tpu_torch.engine import fedcore as tfc
    from olearning_sim_tpu_torch.engine import pp_rounds as tpp
    from olearning_sim_tpu_torch.models import get_model as tget
    from olearning_sim_tpu_torch.parallel import pipeline as tpl
    from olearning_sim_tpu_torch.parallel.mesh import MeshPlan

    jp = jplan(devices=jax.devices()[:PP], pp=PP)
    tp = MeshPlan(dp=1, sp=1, rank=0, pp=PP)
    cases = [
        (dict(depth=3), {}, "fedavg", None),
        (dict(attention_impl="flash"), {}, "fedavg", None),
        ({}, {}, "ditto", None),
        ({}, {}, "scaffold", None),
        ({}, {"shard_server_update": True}, "fedavg", None),
        ({}, {}, "fedavg", 3),
        ({}, {}, "fedavg", 0),
    ]
    for over, cfg, alg, mb in cases:
        jmodel = jget("distilbert").build(**dict(TEXT, **over))
        tmodel = tget("distilbert").build(**dict(TEXT, **over))
        jcfg = jfc.FedCoreConfig(batch_size=BATCH, **cfg)
        tcfg = tfc.FedCoreConfig(batch_size=BATCH, **cfg)
        want = _refusal(lambda: jpp.validate_pp_build(jmodel, jp, jcfg,
                                                      getattr(jalg, alg)(0.1), mb))
        got = _refusal(lambda: tpp.validate_pp_build(tmodel, tp, tcfg,
                                                     getattr(talg, alg)(0.1), mb))
        assert got == want, (over, cfg, alg, mb)
    tokens, _ = _tokens()
    jmodel = jget("distilbert").build(**TEXT)
    tmodel = tget("distilbert").build(**TEXT)
    for mb in (3, 0, 16):
        assert _refusal(lambda: tpl.pp_forward(tmodel, {}, tokens, tp, num_microbatches=mb)) \
            == _refusal(lambda: jpl.pp_forward(jmodel, {}, tokens, jp, num_microbatches=mb))
    assert _refusal(lambda: tpl.pp_forward(tmodel, {}, tokens, MeshPlan(dp=1, sp=1, rank=0))) \
        == _refusal(lambda: jpl.pp_forward(jmodel, {}, tokens, jplan(devices=jax.devices()[:1])))
    # The round's launch: a deadline on a pipelined core.
    jcore = _jax_core({}, jp)
    jstate = jcore.init_state(jax.random.key(3))
    from olearning_sim_tpu.engine import client_data as jcd

    jds = jcd.make_synthetic_text_dataset(5, NUM, N_LOCAL, SEQ, vocab_size=128).pad_for(
        jp, BLOCK).place(jp)
    core = _tcore({}, tp)
    ds = _population().pad_for(BLOCK).to("cpu")
    ct = np.zeros(PADDED, np.float32)
    want = _refusal(lambda: jcore.round_step(jstate, jds, completion_time=jnp.asarray(ct),
                                             deadline=1.0))
    got = _refusal(lambda: core.round_step(core.init_state(device="cpu"), ds,
                                           completion_time=torch.from_numpy(ct), deadline=1.0))
    assert got == want
    assert _refusal(lambda: _tcore({}, MeshPlan(dp=1, sp=1, rank=0), microbatches=2)) == \
        _refusal(lambda: _jax_core({}, jplan(devices=jax.devices()[:1]), microbatches=2))
