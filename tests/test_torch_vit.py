"""The port's vit_tiny against the JAX package's flax ViT: logits at small
width in f32 and bf16 (pre-LN blocks, no mask, tanh GELU, the zero ``cls``
token and the learned positions), the weight converter's exact round trip,
the token count derived from the input shape, the initializers, and whole
Ditto rounds with bf16 personal params plus ``evaluate_personal`` against
the JAX engine.

As in tests/test_torch_resnet.py, f32 rounds are held tightly (summation
order) and the bf16 round by its distance from JAX's f32 round against
JAX's own bf16 round's, and by its move against JAX's bf16 move: on one
minibatch of this width JAX's bf16 gradient is 4.0% from its f32
gradient, the port's 2.5% from JAX's f32 and 3.6% from JAX's bf16.
LayerNorm (shared with moe_text and DistilBERT) is held to one bf16
rounding of flax's on the same bf16 input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_fedcore_families import (
    _moved_gap,
    _per_client,
    family_rounds,
    real_client_loss_gap,
    tree_rel_gap,
)

from olearning_sim_tpu.engine import algorithms as jalg
from olearning_sim_tpu.models import get_model as jax_get_model
from olearning_sim_tpu_torch.engine import algorithms as talg
from olearning_sim_tpu_torch.models import get_model
from olearning_sim_tpu_torch.models.transformer import layer_norm
from olearning_sim_tpu_torch.weights import params_from_jax, params_to_jax

SMALL = dict(width=16, depth=2, heads=2, mlp_dim=32)
SHAPE = (32, 32, 3)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# Logits (magnitude about 3). f32: summation order only (measured 1.7e-6).
# bf16: an activation may round to the neighbouring bf16 value (2^-8
# relative) and carry through two blocks (measured 2.1e-2).
LOGITS_ATOL = {"f32": 5e-5, "bf16": 8e-2}

ROUND_OVER = dict(SMALL, num_classes=10)
LAM = 0.3
# f32 rounds: global params and real clients' losses within summation
# order; each round's move within F32_MOVED_RTOL of JAX's (measured 8.4e-7
# and 2.9e-6). The personal params are stored in bf16: the two engines'
# f32 values may round to neighbouring bf16 values, one ulp at most
# (2^-7 relative), and their move (a participant's new minus old values)
# within F32_MOVED_RTOL of JAX's (measured 1.8e-4, the ulp flips); the
# same round with lam 0, which drops Ditto's pull toward the global model,
# moves them outside it (measured 0.67).
F32_PARAM_ATOL, F32_LOSS_ATOL, F32_MOVED_RTOL = 1e-5, 1e-5, 1e-3
BF16_ULP_RTOL = 2.0 ** -7
# bf16, one round: the port's move no farther from JAX's f32 round than
# BF16_NOISE_RATIO times JAX's own bf16 move (measured 0.0221 against
# 0.0197, ratio 1.12), and within BF16_MOVED_RTOL of JAX's bf16 move
# (measured 1.53e-2; with LayerNorm's statistics, scale and bias in bf16
# the port reads 3.09e-2 there, and a ratio of 1.17); real clients'
# losses measured 2.5e-2 apart.
BF16_NOISE_RATIO = 1.3
BF16_MOVED_RTOL = 2.2e-2
BF16_LOSS_ATOL = 5e-2


def _setup(dtype, seed, shape=SHAPE, **over):
    jdt, tdt = DTYPES[dtype]
    over = dict(SMALL, **over)
    jm = jax_get_model("vit_tiny").build(**over, dtype=jdt)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed),
                                              jnp.zeros((1,) + shape))["params"])
    tm = get_model("vit_tiny").build(input_shape=shape, **over, dtype=tdt)
    return jm, params, tm


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_logits_match_jax(dtype, seed):
    jm, params, tm = _setup(dtype, seed)
    x = np.random.default_rng(seed).standard_normal((6,) + SHAPE).astype(np.float32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGITS_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("shape,patch,tokens", [((32, 32, 3), 4, 64), ((28, 28, 1), 4, 49),
                                                ((30, 22, 3), 4, 35), ((32, 32, 3), 8, 16)])
def test_tokens_follow_the_input_shape(shape, patch, tokens):
    """pos_embedding is [1, 1 + tokens, W] with tokens = (H // patch) * (W
    // patch) (a VALID patch conv), as flax creates it; the logits agree."""
    jm, params, tm = _setup("f32", 0, shape, patch=patch)
    assert params["pos_embedding"].shape == (1, 1 + tokens, SMALL["width"])
    assert tuple(tm.pos_embedding.shape) == (1, 1 + tokens, SMALL["width"])
    x = np.random.default_rng(1).standard_normal((3,) + shape).astype(np.float32)
    tm.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply({"params": params}, x)),
                               atol=LOGITS_ATOL["f32"], rtol=0)


def test_full_width_shapes():
    """The registry's ViT-Tiny: width 192, 12 blocks, 65 positions at
    32x32 with patch 4, about 5.4M parameters."""
    tm = get_model("vit_tiny").build()
    assert tuple(tm.pos_embedding.shape) == (1, 65, 192) and len(tm.blocks) == 12
    n = sum(p.numel() for p in tm.parameters())
    assert 5e6 < n < 7e6, n


def test_weights_round_trip_exact():
    _, params, tm = _setup("bf16", 2)
    port = params_from_jax(params)
    assert set(port) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert tuple(port[k].shape) == tuple(v.shape), k
    with pytest.raises(ValueError, match="heads"):
        params_to_jax(port)
    back = params_to_jax(port, heads=SMALL["heads"])
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def one_thread():
    """Elementwise work on one thread: the full-width init is 5x faster so
    alone (0.29 s against 1.50 s on 8 threads) and far more under a loaded
    test run, where every worker's threads contend for the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_init_matches_flax(one_thread):
    """Zero cls and biases, unit LayerNorm scales, normal(0.02) positions,
    lecun-normal kernels; reproducible from one seed."""
    tm = get_model("vit_tiny").build()
    a = tm.init_params(torch.Generator().manual_seed(0))
    b = tm.init_params(torch.Generator().manual_seed(0))
    assert set(a) == set(tm.state_dict())
    for k, t in a.items():
        assert torch.equal(t, b[k])
        if k == "cls" or (k.endswith("bias") and "norm" not in k):
            assert not t.any(), k
        elif "norm" in k:
            assert torch.all(t == (1.0 if k.endswith("weight") else 0.0)), k
        elif k == "pos_embedding":
            assert abs(float(t.std()) / 0.02 - 1) < 0.02, float(t.std())
        else:
            std = 1.0 / np.sqrt(np.prod(t.shape[1:]))
            assert float(t.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6, k
            assert abs(float(t.std()) / std - 1) < 6 / np.sqrt(2 * t.numel()), k


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", [16, 192])
def test_layer_norm_matches_flax(dtype, width):
    """flax's LayerNorm(dtype) (eps 1e-6, fast variance) on the same input,
    scale and bias, inputs off-centre so that statistics kept in bf16 would
    cancel: f32 within summation order, bf16 within one bf16 ulp of flax's
    (2^-7 relative)."""
    import flax.linen as fnn

    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(width)
    x = (3.0 + rng.standard_normal((4, 9, width))).astype(np.float32)
    x = np.array(jnp.asarray(x, jdt).astype(jnp.float32))  # representable in dtype
    scale = (1 + 0.5 * rng.standard_normal(width)).astype(np.float32)
    bias = rng.standard_normal(width).astype(np.float32)
    ref = fnn.LayerNorm(dtype=jdt).apply({"params": {"scale": scale, "bias": bias}},
                                         jnp.asarray(x, jdt))
    ln = torch.nn.LayerNorm(width)
    ln.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        out = layer_norm(torch.from_numpy(x).to(tdt), ln, tdt)
    assert out.dtype == tdt
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "f32" else dict(atol=1e-6, rtol=2.0 ** -7)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **tol)


def _ditto_rounds(dtype, rounds, controls=()):
    return family_rounds("vit_tiny", ROUND_OVER, SHAPE, jalg.ditto(0.05, lam=LAM),
                         talg.ditto(0.05, lam=LAM), dtype=dtype, rounds=rounds,
                         controls=controls, personal_dtype=torch.bfloat16)


def _personal_move(new, old, clients):
    """A Ditto state's move [c, ...] over ``clients``, as f32 port params."""
    return {k: new[k][clients].float() - old[k][clients].float() for k in old}


@pytest.fixture(scope="module")
def f32_run():
    return _ditto_rounds("f32", 2, controls=[("lam0", talg.ditto(0.05, lam=0.0), None, None)])


def test_ditto_rounds_match_jax_f32(f32_run):
    run = f32_run
    movers = [0, 1, 3, 5, 6]  # participants that ran a step
    t_before = j_before = None
    for rec in run["records"]:
        assert real_client_loss_gap(rec["tm"], rec["jm"]) <= F32_LOSS_ATOL
        np.testing.assert_allclose(float(rec["tm"].personal_loss),
                                   float(rec["jm"].personal_loss), atol=F32_LOSS_ATOL)
        for k, v in rec["j_new"].items():
            np.testing.assert_allclose(rec["t_new"][k].numpy(), v.numpy(),
                                       atol=F32_PARAM_ATOL, rtol=0, err_msg=k)
        assert _moved_gap(rec["t_new"], rec["t_old"], rec["j_new"], rec["j_old"]) \
            <= F32_MOVED_RTOL
        tper = rec["t_personal"].params
        jper = {k: torch.stack([_per_client(rec["j_personal"], c)[k]
                                for c in range(8)]) for k in tper}
        for k, v in jper.items():
            assert tper[k].dtype == torch.bfloat16
            np.testing.assert_allclose(tper[k].float().numpy(), v.numpy(),
                                       rtol=BF16_ULP_RTOL, atol=1e-7, err_msg=k)
        if t_before is not None:
            t_move = _personal_move(tper, t_before, movers)
            j_move = _personal_move(jper, j_before, movers)
            c_move = _personal_move(rec["controls"]["lam0"][1].params, t_before, movers)
            gap, cgap = tree_rel_gap(t_move, j_move), tree_rel_gap(c_move, j_move)
            print(f"vit f32 personal move gap {gap:.3e}, lam 0 control {cgap:.3e}")
            assert gap <= F32_MOVED_RTOL < cgap, (gap, cgap)
        t_before, j_before = tper, jper
    jl, ja = run["jcore"].evaluate_personal(run["jper"], run["jds"])
    tl, ta = run["tcore"].evaluate_personal(run["tper"], run["tds"])
    print(f"vit f32 evaluate_personal: jax {jl:.6f} {ja:.4f} port {tl:.6f} {ta:.4f}")
    assert abs(tl - jl) < 1e-4 and ta == ja


def test_ditto_round_bf16_within_jax_bf16_noise(f32_run):
    f32 = f32_run["records"][0]
    run = _ditto_rounds("bf16", 1)
    bf16 = run["records"][0]
    g_jax = _moved_gap(bf16["j_new"], f32["j_old"], f32["j_new"], f32["j_old"])
    g_port = _moved_gap(bf16["t_new"], f32["j_old"], f32["j_new"], f32["j_old"])
    g_bf16 = _moved_gap(bf16["t_new"], bf16["t_old"], bf16["j_new"], bf16["j_old"])
    print(f"vit bf16 moved gap to JAX f32: jax {g_jax:.3e} port {g_port:.3e}; to JAX "
          f"bf16 {g_bf16:.3e}; loss gap {real_client_loss_gap(bf16['tm'], bf16['jm']):.3e}")
    assert g_port <= BF16_NOISE_RATIO * g_jax
    assert g_bf16 <= BF16_MOVED_RTOL
    assert real_client_loss_gap(bf16["tm"], bf16["jm"]) <= BF16_LOSS_ATOL
    jl, ja = run["jcore"].evaluate_personal(run["jper"], run["jds"])
    tl, ta = run["tcore"].evaluate_personal(run["tper"], run["tds"])
    print(f"vit bf16 evaluate_personal: jax {jl:.6f} {ja:.4f} port {tl:.6f} {ta:.4f}")
    assert abs(tl - jl) < BF16_LOSS_ATOL and abs(ta - ja) <= 0.05


def test_registry_matches_jax():
    spec, jspec = get_model("vit_tiny"), jax_get_model("vit_tiny")
    assert spec.defaults == jspec.defaults
    assert spec.example_input_shape == jspec.example_input_shape
    assert spec.num_classes == jspec.num_classes and spec.input_dtype == jspec.input_dtype
