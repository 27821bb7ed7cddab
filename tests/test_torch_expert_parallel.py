"""The port's expert parallelism over two gloo ranks (ep 2), against the JAX
package's ``ep_train_step`` at ep 2 (two of conftest's eight virtual CPU
devices) and the port's dense step:

- ``ep_param_specs`` splits exactly the ``expert_*`` leaves JAX's splits,
  and ``sharded_expert_fraction`` equals JAX's;
- ``ep_place_params`` hands each rank its contiguous slice of the experts;
- two ``ep_train_step`` SGD steps of ``moe_text`` (the Switch aux loss
  averaged over the blocks) land where JAX's and the dense steps land, and
  both ranks' replicated leaves are the same.

f32 compute on both sides, held to tests/test_torch_fedcore.py's
tolerances. The ranks run once for the module (tests/test_torch_dp.py's
harness); this module imports no JAX at its top."""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_dp import one_thread, run_ranks
from test_torch_tp import LOSS_ATOL, _close, _jax_flat, _params, _tree

EP = 2
LR = 0.1
AUX = 0.01
MOE = dict(vocab_size=128, max_len=8, width=32, depth=2, heads=4, mlp_dim=64, num_experts=4,
           num_classes=2)


def _model():
    from olearning_sim_tpu_torch.models import get_model

    return get_model("moe_text").build(**MOE, dtype=torch.float32)


def _tokens():
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, MOE["vocab_size"], (8, 8)).astype(np.int32)
    tokens[1, 4:] = 0
    return tokens, (tokens[:, 0] % MOE["num_classes"]).astype(np.int64)


def _ep_job(rank, world, inp):
    from olearning_sim_tpu_torch.engine.algorithms import SGD
    from olearning_sim_tpu_torch.parallel import expert_parallel as ep
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    plan = make_mesh_plan(ep=EP)
    assert plan.ep == EP and plan.ep_rank == rank and plan.dp == 1
    params, specs = ep.ep_place_params(_params(inp), plan)
    opt = SGD(LR)
    opt_state = opt.init(params)
    tokens, labels = _tokens()
    out = {}
    for s in range(2):
        params, opt_state, loss = ep.ep_train_step(_model(), params, opt_state, tokens, labels,
                                                   opt, plan, aux_weight=AUX)
        out[f"loss/{s}"] = np.float32(loss)
    out.update({f"p/{k}": v.numpy() for k, v in params.items()})
    out["split"] = np.array(sorted(k for k, d in specs.items() if d is not None))
    return out


@pytest.fixture(scope="module")
def inputs():
    return {f"p/{k}": v.numpy()
            for k, v in _model().init_params(torch.Generator().manual_seed(4)).items()}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_ranks(__name__, "_ep_job", EP, inputs, tmp_path_factory.mktemp("ep"))


def _whole(ranks):
    """The ranks' params with each split leaf concatenated in rank order."""
    split = set(str(k) for k in ranks[0]["split"])
    p = [_tree(r, "p/") for r in ranks]
    return {k: np.concatenate([q[k] for q in p]) if k in split else p[0][k] for k in p[0]}


def test_ep_train_step_matches_jax_and_dense(ranks, inputs):
    """Two SGD steps with the experts split over ep 2 against JAX's
    ep_train_step at ep 2 and the port's dense step."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch.nn.functional as F
    from torch.func import functional_call

    from olearning_sim_tpu.models import get_model
    from olearning_sim_tpu.parallel import expert_parallel as jep
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu_torch.weights import params_to_jax

    tokens, labels = _tokens()
    split = set(str(k) for k in ranks[0]["split"])
    for k in _tree(ranks[0], "p/"):
        if k not in split:
            assert np.array_equal(ranks[0][f"p/{k}"], ranks[1][f"p/{k}"]), k
    got = _whole(ranks)

    plan = make_mesh_plan(devices=jax.devices()[:EP], ep=EP)
    jmodel = get_model("moe_text").build(**MOE, dtype=jnp.float32)
    jparams, _ = jep.ep_place_params(params_to_jax(_params(inputs), heads=MOE["heads"]), plan)
    opt = optax.sgd(LR)
    opt_state = opt.init(jparams)
    jloss = []
    for _ in range(2):
        jparams, opt_state, loss = jep.ep_train_step(jmodel, jparams, opt_state, tokens,
                                                     labels.astype(np.int32), opt, plan,
                                                     aux_weight=AUX)
        jloss.append(float(loss))
    _close(got, _jax_flat(jax.device_get(jparams)), "ep_train_step vs JAX")

    model = _model()
    params = _params(inputs)
    with one_thread():
        for s in range(2):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            logits, aux = functional_call(model, leaves, (torch.from_numpy(tokens).long(),),
                                          {"return_aux": True})
            ce = F.cross_entropy(logits, torch.from_numpy(labels))
            grads = torch.autograd.grad(ce + AUX * aux, list(leaves.values()))
            params = {k: (v - LR * g).detach() for (k, v), g in zip(leaves.items(), grads)}
            for r in ranks:
                assert abs(float(r[f"loss/{s}"]) - float(ce.detach())) < LOSS_ATOL
                assert abs(float(r[f"loss/{s}"]) - jloss[s]) < LOSS_ATOL
    _close(got, {k: v.numpy() for k, v in params.items()}, "ep_train_step vs dense")


@pytest.mark.parametrize("ep", [2, 4])
def test_ep_specs_match_jax(ep):
    """The port splits exactly JAX's expert leaves on their expert dim, and
    the fractions agree, at registry defaults."""
    import jax
    import jax.numpy as jnp

    from olearning_sim_tpu.models import get_model as jget
    from olearning_sim_tpu.parallel import expert_parallel as jep
    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.parallel import expert_parallel as ep_mod
    from olearning_sim_tpu_torch.weights import params_from_jax

    jspec = jget("moe_text")
    jmodel = jspec.build()
    shape = (1,) + tuple(jspec.example_input_shape)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros(shape, jspec.input_dtype))["params"],
        jax.random.key(0))
    jspecs = jep.ep_param_specs(shapes, ep)
    want = jep.sharded_expert_fraction(shapes, jspecs)
    with torch.device("meta"):
        model = get_model("moe_text").build()
    tshapes = {k: v.shape for k, v in model.named_parameters()}
    specs = ep_mod.ep_param_specs(tshapes, ep)
    assert ep_mod.sharded_expert_fraction(tshapes, specs) == pytest.approx(want, abs=1e-12)
    # The split leaves, named as the port names them.
    marks = jax.tree.map(lambda s: np.zeros(()) + any(a is not None for a in s), jspecs,
                         is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    flags = params_from_jax(marks)
    assert {k for k, v in flags.items() if v.item()} == \
        {k for k, d in specs.items() if d is not None}
    assert all(d in (None, 0) for d in specs.values())


def test_ep_place_params_slices_contiguous_experts():
    from olearning_sim_tpu_torch.parallel import expert_parallel as ep_mod
    from olearning_sim_tpu_torch.parallel.mesh import MeshPlan

    params = _model().init_params(torch.Generator().manual_seed(0))
    parts = [ep_mod.ep_place_params(params, MeshPlan(dp=1, sp=1, rank=r, ep=EP))[0]
             for r in range(EP)]
    for k, v in params.items():
        if k.rsplit(".", 1)[-1].startswith("expert_"):
            assert torch.equal(torch.cat([p[k] for p in parts]), v)
        else:
            assert all(torch.equal(p[k], v) for p in parts)
    with pytest.raises(ValueError, match="ep axis"):
        ep_mod.ep_place_params(params, MeshPlan(dp=1, sp=1, rank=0))
