"""The port's mlp2, cnn4 and cnn4_pool against the JAX package's flax
modules on the same parameters, carried over by
olearning_sim_tpu_torch.weights; the weight converter's exact round trip;
the initializers against flax's lecun-normal; the registry's input
shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from olearning_sim_tpu.models import get_model as jax_get_model
from olearning_sim_tpu_torch.models import get_model
from olearning_sim_tpu_torch.weights import params_from_jax, params_to_jax

import torch_threads  # noqa: F401

# Both sides compute in bf16 as the families hard-code (bf16 layers, f32
# head); they differ in bf16 rounding of the convolution/matmul
# accumulations. Measured at full width: 7.2e-7 (mlp2) and 5.1e-5 (cnn4)
# on logits of magnitude ~2; 1e-3 leaves room for a one-ulp flip of a
# bf16 activation at the small widths here.
LOGITS_ATOL = 1e-3

# Small widths: mlp2 hidden 32; cnn4 features (8, 16) at 16x16x3.
CASES = {
    "mlp2": (dict(hidden=(32,), num_classes=10), (28, 28, 1)),
    "cnn4": (dict(features=(8, 16), num_classes=10), (16, 16, 3)),
    "cnn4_pool": (dict(features=(8, 16), dense=24, num_classes=10), (16, 16, 3)),
    "cnn4_odd": (dict(features=(8, 16), num_classes=10), (15, 13, 3)),
}


def _setup(case, seed):
    over, shape = CASES[case]
    name = case.replace("_odd", "")
    jm = jax_get_model(name).build(**over)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed),
                                              jnp.zeros((1,) + shape))["params"])
    tm = get_model(name).build(input_shape=shape, **over)
    return jm, params, tm, shape


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_logits_match_jax(case, seed):
    jm, params, tm, shape = _setup(case, seed)
    x = np.random.default_rng(seed).standard_normal((6,) + shape).astype(np.float32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGITS_ATOL, rtol=0)


def test_bf16_params_keep_an_f32_head():
    """Under carry_dtype=bf16 the parameters arrive in bf16; the head must
    still compute in f32 (flax's Dense(dtype=f32) casts its kernel up)."""
    jm, params, tm, shape = _setup("mlp2", 0)
    x = np.random.default_rng(3).standard_normal((4,) + shape).astype(np.float32)
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    ref = np.asarray(jm.apply({"params": p16}, jnp.asarray(x)))
    tp = {k: v.to(torch.bfloat16) for k, v in params_from_jax(params).items()}
    with torch.no_grad():
        out = torch.func.functional_call(tm, tp, (torch.from_numpy(x),))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("case", ["mlp2", "cnn4", "cnn4_pool"])
def test_weights_round_trip_exact(case):
    _, params, tm, _ = _setup(case, 2)
    port = params_from_jax(params)
    assert set(port) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert tuple(port[k].shape) == tuple(v.shape), k
    back = params_to_jax(port)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_conv_kernel_layout():
    """A flax Conv kernel [kh, kw, c_in, c_out] lands as [c_out, c_in, kh, kw]."""
    k = np.arange(3 * 3 * 2 * 4, dtype=np.float32).reshape(3, 3, 2, 4)
    out = params_from_jax({"Conv_0": {"kernel": k, "bias": np.zeros(4, np.float32)}})
    w = out["conv.0.weight"].numpy()
    assert w.shape == (4, 2, 3, 3)
    assert w[1, 0, 2, 0] == k[2, 0, 0, 1]


@pytest.mark.parametrize("case", ["mlp2", "cnn4", "cnn4_pool"])
def test_init_matches_flax_lecun_normal(case):
    """Per layer: zero biases; kernels with flax's scale (std 1/sqrt(fan_in),
    fan_in = kh*kw*c_in for a conv) and truncation (|w| <= 2 std /
    0.8796), drawn from one seed reproducibly."""
    _, params, tm, _ = _setup(case, 0)
    a = tm.init_params(torch.Generator().manual_seed(0))
    b = tm.init_params(torch.Generator().manual_seed(0))
    ref = params_from_jax(params)
    assert set(a) == set(ref)
    for k, t in a.items():
        assert t.dtype == torch.float32 and t.shape == ref[k].shape
        assert torch.equal(t, b[k])
        if k.endswith("bias"):
            assert not t.any() and not ref[k].any()
            continue
        fan_in = int(np.prod(t.shape[1:]))
        std = 1.0 / np.sqrt(fan_in)
        for w in (t.numpy(), ref[k].numpy()):
            assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
            # Sample std of n draws: relative sd about 1/sqrt(2n).
            assert abs(w.std() / std - 1) < 6 / np.sqrt(2 * w.size), (k, w.std(), std)


def test_registry_input_shapes():
    assert get_model("mlp2").build(input_shape=(784,)).dense[0].in_features == 784
    assert get_model("mlp2").build().dense[0].in_features == 784  # (28, 28, 1)
    assert get_model("cnn4").build(input_shape=(8, 8, 1)).conv[0].in_channels == 1
    pool = get_model("cnn4_pool").build(input_shape=(16, 16, 3))
    assert pool.dense[0].in_features == 4 * 4 * 64
    assert get_model("resnet18").build(input_shape=(32, 32, 3)).conv[0].in_channels == 3
    assert get_model("vit_tiny").build(input_shape=(28, 28, 1)).pos_embedding.shape[1] == 50
    with pytest.raises(KeyError):
        get_model("resnet50")
