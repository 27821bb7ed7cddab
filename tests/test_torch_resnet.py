"""The port's resnet18 against the JAX package's flax ResNet: logits at
small width (four stages, so XLA's (0, 1) and (1, 1) SAME pads and the 1x1
projection shortcut all occur; also the 7x7/2 stem with its SAME max-pool)
in f32 and bf16, the weight converter's exact round trip, the registry's
shortcut decisions and initializers, flax's GroupNorm under vmap with a
per-client weight, and whole FedProx rounds against the JAX engine.

Rounds run in two compute dtypes. In f32 the two engines differ in
summation order only and are held tightly. In bf16 (the family's default)
a round's gradients carry bf16 rounding noise of several percent through
the GroupNorm stack: on one minibatch of this width, JAX's own bf16
gradient is 12.9% (relative L2) from its f32 gradient, the port's bf16
gradient 11.6% from JAX's f32 and 5.3% from JAX's bf16. So the bf16 round
is held by how far each engine's round moves from JAX's f32 round (the
port's no farther than BF16_NOISE_RATIO times JAX's own) and by its move
against JAX's bf16 move, with limits set between the sound port's readings
and those of a port planted with a bf16-only fault. GroupNorm itself is
held to one bf16 rounding of flax's on the same bf16 input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_fedcore_families import (
    _moved_gap,
    family_rounds,
    real_client_loss_gap,
)

from olearning_sim_tpu.engine import algorithms as jalg
from olearning_sim_tpu.models import get_model as jax_get_model
from olearning_sim_tpu_torch.engine import algorithms as talg
from olearning_sim_tpu_torch.models import get_model
from olearning_sim_tpu_torch.models.common import same_pads
from olearning_sim_tpu_torch.models.resnet import group_norm
from olearning_sim_tpu_torch.weights import params_from_jax, params_to_jax

SMALL = dict(stage_features=(8, 8, 16, 16), blocks_per_stage=(1, 1, 1, 1), groups=4)
CASES = {"small_stem": (SMALL, (28, 28, 1)),
         "large_stem": (dict(SMALL, small_inputs=False), (32, 32, 3))}
# Logits (magnitude about 2-3) of the flax module and the port on the same
# params. f32: summation order only (measured 1.2e-6 and 6.6e-6). bf16: a
# conv or GroupNorm output may round to the neighbouring bf16 value (2^-8
# relative) and carry through four stages (measured up to 5.4e-3 with the
# small stem, 0 with the large). A port that computes the f32 head in
# bf16 reads 1.1e-2, one with GroupNorm's statistics in bf16 1.6e-2
# (small stem) and 1.4e-1 (large).
LOGITS_ATOL = {"f32": 5e-5, "bf16": 8e-3}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

ROUND_OVER = dict(SMALL, num_classes=10)
SHAPE = (28, 28, 1)
# FedProx strong enough that its pull moves a round far from FedAvg's.
MU = 5.0
# f32 rounds, two of them: params and real clients' losses (magnitude about
# 2) within summation order; what a round moved within F32_MOVED_RTOL of
# JAX's move (measured 2.8e-6 and 3.4e-6), the FedAvg control outside it
# (measured 0.37 and 0.44).
F32_PARAM_ATOL, F32_LOSS_ATOL, F32_MOVED_RTOL = 1e-5, 1e-5, 1e-4
# bf16, one round: measured JAX's move 0.208 from its f32 round, the
# port's 0.225 (ratio 1.08); the port's move 0.190 from JAX's bf16 move.
# With GroupNorm's statistics, scale and bias in bf16 (flax's fast
# variance, E[x^2] - E[x]^2, in bf16) the port reads a ratio of 1.28 and
# 0.270 from JAX's bf16 move: BF16_MOVED_RTOL lies between.
BF16_NOISE_RATIO = 1.3
BF16_MOVED_RTOL = 0.23
BF16_LOSS_ATOL = 5e-2


def _setup(case, dtype, seed):
    over, shape = CASES[case]
    jdt, tdt = DTYPES[dtype]
    jm = jax_get_model("resnet18").build(**over, dtype=jdt)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed),
                                              jnp.zeros((1,) + shape))["params"])
    tm = get_model("resnet18").build(input_shape=shape, **over, dtype=tdt)
    return jm, params, tm, shape


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_logits_match_jax(case, dtype, seed):
    jm, params, tm, shape = _setup(case, dtype, seed)
    x = np.random.default_rng(seed).standard_normal((6,) + shape).astype(np.float32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGITS_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_weights_round_trip_exact(case):
    _, params, tm, _ = _setup(case, "bf16", 2)
    port = params_from_jax(params)
    assert set(port) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert tuple(port[k].shape) == tuple(v.shape), k
    back = params_to_jax(port)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_same_pads_are_xla_rules():
    """(0, 1) at 28 -> 14 and 14 -> 7, (1, 1) at 7 -> 4 for a 3x3 stride-2
    window; 0 for the 1x1 stride-2 shortcut; (1, 1) for a stride-1 3x3."""
    def pads(n, k, s):
        return same_pads(torch.zeros(1, 1, n, n), k, s)[:2]

    assert pads(28, 3, 2) == [0, 1] and pads(14, 3, 2) == [0, 1]
    assert pads(7, 3, 2) == [1, 1] and pads(28, 3, 1) == [1, 1]
    assert pads(28, 1, 2) == [0, 0] and pads(7, 1, 2) == [0, 0]
    assert pads(32, 7, 2) == [2, 3]


@pytest.mark.parametrize("over,shape", [
    (SMALL, (28, 28, 1)),
    (dict(SMALL, stage_features=(4, 8, 8, 8)), (28, 28, 1)),
    (dict(SMALL, blocks_per_stage=(2, 1, 2, 1)), (6, 6, 3)),
    (dict(SMALL, small_inputs=False), (9, 9, 3)),
])
def test_projection_shortcuts_follow_flax_shapes(over, shape):
    """A block has a 1x1 projection exactly where flax created one, which
    depends on the input's spatial size (at 1x1 a stride-2 block keeps its
    shape); the head's width and every shape agree."""
    jm = jax_get_model("resnet18").build(**over)
    params = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1,) + shape)))
    params = params["params"]
    tm = get_model("resnet18").build(input_shape=shape, **over)
    for i, block in enumerate(tm.blocks):
        assert block.project == ("Conv_2" in params[f"ResidualBlock_{i}"]), i
    want = params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), params))
    assert {k: tuple(v.shape) for k, v in want.items()} == \
        {k: tuple(v.shape) for k, v in tm.state_dict().items()}


def test_init_matches_flax():
    """Unit GroupNorm scales, zero biases; conv kernels lecun-normal
    (std 1/sqrt(kh*kw*c_in), truncated at 2 sigma), drawn reproducibly."""
    tm = get_model("resnet18").build()
    a = tm.init_params(torch.Generator().manual_seed(0))
    b = tm.init_params(torch.Generator().manual_seed(0))
    assert set(a) == set(tm.state_dict())
    for k, t in a.items():
        assert torch.equal(t, b[k])
        if "norm" in k:
            assert torch.all(t == (1.0 if k.endswith("weight") else 0.0)), k
        elif k.endswith("bias"):
            assert not t.any(), k
        else:
            std = 1.0 / np.sqrt(np.prod(t.shape[1:]))
            assert float(t.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6, k
            assert abs(float(t.std()) / std - 1) < 6 / np.sqrt(2 * t.numel()), k


def test_group_norm_under_vmap_with_per_client_weights():
    """flax's GroupNorm (f32 statistics, eps 1e-6) and its gradients under
    vmap with a different scale and bias per client equal a loop over the
    clients."""

    class Norm(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gn = torch.nn.GroupNorm(4, 8, eps=1e-6)

        def forward(self, x):
            return group_norm(x, self.gn, torch.float32)

    norm = Norm()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 2, 8, 5, 5)).astype(np.float32))
    p = {"gn.weight": torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32)),
         "gn.bias": torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))}
    scale = torch.arange(8.0)[:, None, None]

    def loss(q, xc):
        return (torch.func.functional_call(norm, q, (xc,)).pow(2) * scale).sum()

    batched = torch.func.vmap(torch.func.grad(loss))(p, x)
    for c in range(3):
        one = torch.func.grad(loss)({k: v[c] for k, v in p.items()}, x[c])
        for k in p:
            torch.testing.assert_close(batched[k][c], one[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("groups,features,hw", [(4, 8, 5), (32, 64, 7), (32, 16, 3)])
def test_group_norm_matches_flax(dtype, groups, features, hw):
    """flax's GroupNorm(num_groups=min(groups, features), dtype) on the same
    input, scale and bias, inputs off-centre so that statistics kept in
    bf16 would cancel: f32 within summation order, bf16 within one bf16
    ulp of flax's (2^-7 relative: the two may round an f32 value that lies
    near a rounding boundary to neighbouring bf16 values)."""
    import flax.linen as fnn

    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(groups + features)
    x = (3.0 + rng.standard_normal((2, hw, hw, features))).astype(np.float32)
    x = np.array(jnp.asarray(x, jdt).astype(jnp.float32))  # representable in dtype
    scale = (1 + 0.5 * rng.standard_normal(features)).astype(np.float32)
    bias = rng.standard_normal(features).astype(np.float32)
    g = min(groups, features)
    ref = fnn.GroupNorm(num_groups=g, dtype=jdt).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, jdt))
    gn = torch.nn.GroupNorm(g, features)
    gn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        out = group_norm(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt), gn, tdt)
    assert out.dtype == tdt
    ref = np.asarray(ref, np.float32)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "f32" else dict(atol=1e-6, rtol=2.0 ** -7)
    np.testing.assert_allclose(out.float().permute(0, 2, 3, 1).numpy(), ref, **tol)


def _fedprox_rounds(dtype, rounds, controls=()):
    return family_rounds("resnet18", ROUND_OVER, SHAPE, jalg.fedprox(0.05, mu=MU),
                         talg.fedprox(0.05, mu=MU), dtype=dtype, rounds=rounds,
                         controls=controls)


@pytest.fixture(scope="module")
def f32_rounds():
    return _fedprox_rounds("f32", 2, controls=[
        ("fedavg", talg.fedavg(0.05), None, None)])["records"]


def test_fedprox_rounds_match_jax_f32(f32_rounds):
    for rec in f32_rounds:
        assert real_client_loss_gap(rec["tm"], rec["jm"]) <= F32_LOSS_ATOL
        assert float(rec["tm"].clients_trained) == float(rec["jm"].clients_trained) == 5
        for k, v in rec["j_new"].items():
            np.testing.assert_allclose(rec["t_new"][k].numpy(), v.numpy(),
                                       atol=F32_PARAM_ATOL, rtol=0, err_msg=k)
        gap = _moved_gap(rec["t_new"], rec["t_old"], rec["j_new"], rec["j_old"])
        cgap = _moved_gap(rec["controls"]["fedavg"][0], rec["t_old"], rec["j_new"],
                          rec["j_old"])
        assert gap <= F32_MOVED_RTOL < cgap, (gap, cgap)


def test_fedprox_round_bf16_within_jax_bf16_noise(f32_rounds):
    """One bf16 round of each engine from the same params and draws,
    against JAX's f32 round."""
    f32 = f32_rounds[0]
    bf16 = _fedprox_rounds("bf16", 1)["records"][0]
    g_jax = _moved_gap(bf16["j_new"], f32["j_old"], f32["j_new"], f32["j_old"])
    g_port = _moved_gap(bf16["t_new"], f32["j_old"], f32["j_new"], f32["j_old"])
    g_bf16 = _moved_gap(bf16["t_new"], bf16["t_old"], bf16["j_new"], bf16["j_old"])
    print(f"resnet bf16 moved gap to JAX f32: jax {g_jax:.3e} port {g_port:.3e}; to JAX "
          f"bf16 {g_bf16:.3e}; loss gap {real_client_loss_gap(bf16['tm'], bf16['jm']):.3e}")
    assert g_port <= BF16_NOISE_RATIO * g_jax
    assert g_bf16 <= BF16_MOVED_RTOL
    assert real_client_loss_gap(bf16["tm"], bf16["jm"]) <= BF16_LOSS_ATOL


def test_registry_matches_jax():
    spec, jspec = get_model("resnet18"), jax_get_model("resnet18")
    assert spec.defaults == jspec.defaults
    assert spec.example_input_shape == jspec.example_input_shape
    assert spec.num_classes == jspec.num_classes and spec.input_dtype == jspec.input_dtype
