"""The port's moe_text against the JAX package's flax MoETextTransformer:
logits with padded tokens in f32 and bf16; the Switch router's expert ids
and keep masks, exactly, on a batch with pads and with overflow; the aux
loss and its gate gradient against the JAX engine's ``apply_aux_fn``; the
weight converter's exact round trip; the initializers; ``evaluate`` (no
aux term, capacity from the eval batch); and whole FedAvg rounds with the
aux loss against the JAX engine, in f32 (tight, with an aux_loss_weight 0
control) and bf16 (held by its distance from JAX's f32 round, as in
tests/test_torch_resnet.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_fedcore_families import (
    _moved_gap,
    _plan,
    family_rounds,
    real_client_loss_gap,
    tree_rel_gap,
)

from olearning_sim_tpu.engine import algorithms as jalg
from olearning_sim_tpu.engine import client_data as jcd
from olearning_sim_tpu.engine import fedcore as jfc
from olearning_sim_tpu.models import get_model as jax_get_model
from olearning_sim_tpu.models.moe import SwitchFFN as JaxSwitchFFN
from olearning_sim_tpu_torch.engine import algorithms as talg
from olearning_sim_tpu_torch.engine import fedcore as tfc
from olearning_sim_tpu_torch.models import get_model
from olearning_sim_tpu_torch.models.moe import SwitchFFN
from olearning_sim_tpu_torch.weights import params_from_jax, params_to_jax

# tests/test_models.py's overrides for the family; depth 2 where the aux
# loss is a mean over blocks.
SMALL = {"vocab_size": 97, "max_len": 16, "width": 16, "depth": 1, "heads": 2,
         "mlp_dim": 32, "num_experts": 4}
DEEP = dict(SMALL, depth=2)
SEQ = 16
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# Logits (magnitude about 0.6). f32: summation order (measured 1.8e-7);
# bf16: neighbouring bf16 roundings (measured 1.6e-3).
LOGITS_ATOL = {"f32": 1e-5, "bf16": 2e-2}
# Routing: each token's best router probability beats its second by more
# than this, so summation order cannot flip an argmax.
MARGIN = 1e-3
# The aux loss (about 1) and its gradient in f32: summation order only.
AUX_ATOL = 1e-5
# f32 rounds: params and real clients' losses within summation order; the
# move within F32_MOVED_RTOL of JAX's (measured 7.3e-7 and 9.4e-7); the
# same rounds with aux_loss_weight 0 outside it (measured 9.1e-3 and
# 1.2e-2).
F32_PARAM_ATOL, F32_LOSS_ATOL, F32_MOVED_RTOL = 1e-5, 1e-5, 1e-4
# bf16, one round (measured: JAX's move 9.2e-3 from its f32 round, the
# port's 8.6e-3, ratio 0.94; the port's move 1.06e-2 from JAX's bf16
# move; params 1.6e-4 apart by relative L2; losses 2.7e-3 apart). With
# LayerNorm's statistics, scale and bias in bf16 the port reads a ratio of
# 1.56 and 1.77e-2 from JAX's bf16 move: both limits lie between. Params
# are held at the bf16 families' tolerance, BF16_PARAM_RTOL.
BF16_NOISE_RATIO = 1.3
BF16_MOVED_RTOL = 1.4e-2
BF16_PARAM_RTOL = 9.8e-4
BF16_LOSS_ATOL = 2e-2


def _tokens(seed, B=6, L=SEQ):
    """Tokens with trailing pads, scattered pads and one all-pad row."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, SMALL["vocab_size"], size=(B, L)).astype(np.int32)
    tok[1, 9:] = 0
    tok[2, ::3] = 0
    tok[3, :] = 0
    return tok


def _models(dtype, seed, over=SMALL):
    jdt, tdt = DTYPES[dtype]
    jm = jax_get_model("moe_text").build(**over, dtype=jdt)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed),
                                              jnp.ones((1, SEQ), jnp.int32))["params"])
    tm = get_model("moe_text").build(input_shape=(SEQ,), **over, dtype=tdt)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_logits_match_jax(dtype, seed):
    """Outside vmap (as evaluate runs it), pads give -1 slots, which the
    one-hots must map to zero rows."""
    jm, params, tm = _models(dtype, seed)
    tok = _tokens(seed)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(tok)))
    with torch.no_grad():
        out = tm(torch.from_numpy(tok))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGITS_ATOL[dtype], rtol=0)


def _routing_batch(ffn, seed, dtype, B=4, T=12, W=16):
    """Features whose every token, cast to ``dtype``, clears MARGIN under
    ``ffn``'s router (low-margin tokens redrawn), with pads in two rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, W)).astype(np.float32)
    for _ in range(100):
        with torch.no_grad():
            probs = ffn.route(torch.from_numpy(x).to(dtype))[0]
        top = torch.topk(probs, 2, dim=-1).values
        low = ((top[:, 0] - top[:, 1]) <= MARGIN).numpy().reshape(B, T)
        if not low.any():
            break
        x[low] = rng.standard_normal((int(low.sum()), W)).astype(np.float32)
    assert not low.any()
    valid = np.ones((B, T), bool)
    valid[1, 7:] = False
    valid[3, ::2] = False
    return x, valid


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_routing_matches_jax_exactly(dtype, capacity_factor):
    """Expert ids and keep masks equal flax's on a batch with pads; at
    capacity factor 0.5 the experts' queues overflow. JAX's
    expert ids are the argmax of its captured gate output, its keep mask the
    tokens whose expert output is not zero (a dropped token rides the
    residual). The mixture and the aux loss agree too."""
    jdt, tdt = DTYPES[dtype]
    E, W, M = 4, 16, 32
    jffn = JaxSwitchFFN(E, W, M, capacity_factor, dtype=jdt)
    params = jax.tree.map(np.asarray, jffn.init(jax.random.key(0),
                                                jnp.zeros((2, 3, W)))["params"])
    ffn = SwitchFFN(E, W, M, capacity_factor, dtype=tdt)
    port = params_from_jax({"MoEBlock_0": {"SwitchFFN_0": params}})
    ffn.load_state_dict({k.split("switch.", 1)[1]: v for k, v in port.items()})
    x, valid = _routing_batch(ffn, 3, tdt)
    xj = jnp.asarray(x, jdt)
    y_ref, state = jffn.apply({"params": params}, xj, valid=jnp.asarray(valid),
                              capture_intermediates=True, mutable=["intermediates"])
    logits = state["intermediates"]["gate"]["__call__"][0]
    j_expert = np.asarray(jnp.argmax(jax.nn.softmax(logits, axis=-1), axis=-1))
    j_keep = np.asarray(jnp.any(y_ref.reshape(-1, W) != 0, axis=-1))
    j_aux = float(state["intermediates"]["aux_loss"][0])

    xt = torch.from_numpy(x).to(tdt)
    with torch.no_grad():
        _, expert, _, slot, keep, _, cap = ffn.route(xt, torch.from_numpy(valid))
        y, aux = ffn(xt, torch.from_numpy(valid))
    assert cap == max(1, int(capacity_factor * x.shape[0] * x.shape[1] / E))
    np.testing.assert_array_equal(expert.numpy(), j_expert)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    real = valid.reshape(-1)
    assert (slot.numpy()[~real] == -1).all() and not keep.numpy()[~real].any()
    overflow = real & ~keep.numpy()
    assert overflow.any() == (capacity_factor < 1), overflow.sum()
    assert not y.float().reshape(-1, W)[~keep].any()
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_ref, np.float32),
                               atol=1e-5 if dtype == "f32" else 2e-2, rtol=0)
    np.testing.assert_allclose(float(aux), j_aux, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_aux_loss_and_gate_gradient_match_apply_aux_fn(dtype):
    """forward(return_aux=True) against the JAX engine's apply_aux_fn (the
    mean of the blocks' sown losses) at depth 2, and the gradient of the
    aux loss with respect to every gate."""
    jdt, tdt = DTYPES[dtype]
    jcore = jfc.build_fedcore("moe_text", jalg.fedavg(0.05), _plan(),
                              jfc.FedCoreConfig(batch_size=2, max_local_steps=1,
                                                block_clients=2),
                              model_overrides=dict(DEEP, dtype=jdt), input_shape=(SEQ,))
    params = jax.tree.map(np.asarray, jcore.init_state(jax.random.key(0)).params)
    tok = _tokens(4)
    j_logits, j_aux = jcore.apply_aux_fn(params, jnp.asarray(tok))
    j_grad = params_from_jax(jax.tree.map(np.asarray, jax.grad(
        lambda p: jcore.apply_aux_fn(p, jnp.asarray(tok))[1])(params)))

    tm = get_model("moe_text").build(input_shape=(SEQ,), **DEEP, dtype=tdt)
    tp = params_from_jax(params)

    def aux_of(p):
        return torch.func.functional_call(tm, p, (torch.from_numpy(tok),),
                                          {"return_aux": True})[1]

    logits, aux = torch.func.functional_call(tm, tp, (torch.from_numpy(tok),),
                                             {"return_aux": True})
    grad = torch.func.grad(aux_of)(tp)
    atol = AUX_ATOL if dtype == "f32" else 2e-2
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), atol=atol)
    np.testing.assert_allclose(float(aux), float(j_aux), atol=atol)
    assert 0.5 < float(aux) < 4.0
    gates = [k for k in tp if k.endswith("gate.weight")]
    assert len(gates) == 2
    for k in gates:
        assert float(j_grad[k].abs().max()) > 0
        np.testing.assert_allclose(grad[k].numpy(), j_grad[k].numpy(),
                                   atol=atol * float(j_grad[k].abs().max()), rtol=0,
                                   err_msg=k)
    dense = jfc.build_fedcore("mlp2", jalg.fedavg(0.05), _plan(),
                              jfc.FedCoreConfig(batch_size=2, max_local_steps=1,
                                                block_clients=2))
    assert dense.apply_aux_fn is None
    for name in ("mlp2", "resnet18", "vit_tiny", "distilbert"):
        core = tfc.build_fedcore(name, talg.fedavg(), device="cpu")
        assert not core.has_aux, name
    assert tfc.build_fedcore("moe_text", talg.fedavg(), device="cpu").has_aux


def test_weights_round_trip_exact():
    _, params, tm = _models("bf16", 2, DEEP)
    port = params_from_jax(params)
    assert set(port) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert tuple(port[k].shape) == tuple(v.shape), k
    assert tuple(port["blocks.1.switch.expert_w1"].shape) == (4, 16, 32)
    back = params_to_jax(port, heads=DEEP["heads"])
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_init_matches_flax():
    """Expert kernels [E, in, out] are lecun-normal with flax's fan-in E *
    in; the gate and attention kernels lecun-normal; embeddings and
    positions normal(0.02); zero biases; unit LayerNorm scales."""
    tm = get_model("moe_text").build(**dict(SMALL, num_experts=8, mlp_dim=64, width=32))
    a = tm.init_params(torch.Generator().manual_seed(0))
    b = tm.init_params(torch.Generator().manual_seed(0))
    assert set(a) == set(tm.state_dict())
    for k, t in a.items():
        assert torch.equal(t, b[k])
        if "norm" in k:
            assert torch.all(t == (1.0 if k.endswith("weight") else 0.0)), k
        elif k.endswith(("bias", "expert_b1", "expert_b2")):
            assert not t.any(), k
        elif k in ("embed.weight", "pos_embedding"):
            assert abs(float(t.std()) / 0.02 - 1) < 0.05, k
        else:
            fan_in = t.shape[0] * t.shape[1] if "expert_w" in k else np.prod(t.shape[1:])
            std = 1.0 / np.sqrt(fan_in)
            assert float(t.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6, k
            assert abs(float(t.std()) / std - 1) < 6 / np.sqrt(2 * t.numel()), k


def test_evaluate_matches_jax():
    """evaluate adds no aux term, and each eval batch sets its own capacity
    (eval_batch_size rows), in both packages."""
    cfg = dict(batch_size=2, max_local_steps=1, block_clients=2, eval_batch_size=5)
    over = dict(DEEP, dtype=jnp.float32)
    jcore = jfc.build_fedcore("moe_text", jalg.fedavg(0.05), _plan(),
                              jfc.FedCoreConfig(**cfg), model_overrides=over,
                              input_shape=(SEQ,))
    tcore = tfc.build_fedcore("moe_text", talg.fedavg(0.05), tfc.FedCoreConfig(**cfg),
                              model_overrides=dict(DEEP, dtype=torch.float32),
                              input_shape=(SEQ,), device="cpu")
    params = jcore.init_state(jax.random.key(1)).params
    tparams = params_from_jax(jax.tree.map(np.asarray, params))
    x, y = jcd.make_central_text_eval_set(2, 13, SEQ, 2, vocab_size=DEEP["vocab_size"])
    jl, ja = jcore.evaluate(params, x, y)
    tl, ta = tcore.evaluate(tparams, x, y)
    assert abs(tl - jl) < 1e-5 and ta == ja


def _fedavg_rounds(dtype, rounds, controls=()):
    return family_rounds("moe_text", DEEP, (SEQ,), jalg.fedavg(0.05), talg.fedavg(0.05),
                         dtype=dtype, rounds=rounds, text=True, num_classes=2,
                         controls=controls)


@pytest.fixture(scope="module")
def f32_rounds():
    return _fedavg_rounds("f32", 2, controls=[
        ("no_aux", talg.fedavg(0.05), {"aux_loss_weight": 0.0}, None)])["records"]


def test_fedavg_aux_rounds_match_jax_f32(f32_rounds):
    """In f32 routing ties cannot flip between the engines, so the rounds
    (the aux loss in every client's loss) agree to summation order."""
    for rec in f32_rounds:
        assert real_client_loss_gap(rec["tm"], rec["jm"]) <= F32_LOSS_ATOL
        for k, v in rec["j_new"].items():
            np.testing.assert_allclose(rec["t_new"][k].numpy(), v.numpy(),
                                       atol=F32_PARAM_ATOL, rtol=0, err_msg=k)
        gap = _moved_gap(rec["t_new"], rec["t_old"], rec["j_new"], rec["j_old"])
        cgap = _moved_gap(rec["controls"]["no_aux"][0], rec["t_old"], rec["j_new"],
                          rec["j_old"])
        print(f"moe f32 moved gap {gap:.3e}, aux_loss_weight 0 control {cgap:.3e}")
        assert gap <= F32_MOVED_RTOL < cgap, (gap, cgap)


def test_fedavg_aux_round_bf16_within_jax_bf16_noise(f32_rounds):
    f32 = f32_rounds[0]
    bf16 = _fedavg_rounds("bf16", 1)["records"][0]
    g_jax = _moved_gap(bf16["j_new"], f32["j_old"], f32["j_new"], f32["j_old"])
    g_port = _moved_gap(bf16["t_new"], f32["j_old"], f32["j_new"], f32["j_old"])
    g_bf16 = _moved_gap(bf16["t_new"], bf16["t_old"], bf16["j_new"], bf16["j_old"])
    params = tree_rel_gap(bf16["t_new"], bf16["j_new"])
    print(f"moe bf16 moved gap to JAX f32: jax {g_jax:.3e} port {g_port:.3e}; to JAX bf16 "
          f"{g_bf16:.3e}; params {params:.3e}; loss gap "
          f"{real_client_loss_gap(bf16['tm'], bf16['jm']):.3e}")
    assert g_port <= BF16_NOISE_RATIO * g_jax
    assert g_bf16 <= BF16_MOVED_RTOL and params <= BF16_PARAM_RTOL
    assert real_client_loss_gap(bf16["tm"], bf16["jm"]) <= BF16_LOSS_ATOL


def test_aux_loss_weight_config_matches_jax():
    for obj in ({}, {"aux_loss_weight": 0.5}, {"aux_loss_weight": None}, {"aux_loss_weight": 0}):
        a, b = jfc.FedCoreConfig.from_dict(obj), tfc.FedCoreConfig.from_dict(obj)
        assert a.aux_loss_weight == b.aux_loss_weight and isinstance(b.aux_loss_weight, float)
    assert tfc.FedCoreConfig().aux_loss_weight == jfc.FedCoreConfig().aux_loss_weight == 0.01


def test_registry_matches_jax():
    spec, jspec = get_model("moe_text"), jax_get_model("moe_text")
    assert spec.defaults == jspec.defaults
    assert spec.example_input_shape == jspec.example_input_shape
    assert spec.num_classes == jspec.num_classes and spec.input_dtype == jspec.input_dtype
