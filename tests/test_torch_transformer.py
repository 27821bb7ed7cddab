"""The port's TextTransformer (dense, flash and ring attention) against the
JAX package's flax module on the same parameters, carried over by
olearning_sim_tpu_torch.weights; the weight converter's round trip; the
registry's defaults."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from olearning_sim_tpu.models import get_model as jax_get_model
from olearning_sim_tpu_torch.models import get_model
from olearning_sim_tpu_torch.weights import params_from_jax, params_to_jax

SMALL = dict(depth=2, width=32, heads=4, mlp_dim=64, vocab_size=97, max_len=16)
# f32 on both sides: the two differ in matmul and reduction order only.
LOGITS_ATOL = 1e-5


def _jax_model(impl, **extra):
    return jax_get_model("distilbert").build(
        **SMALL, dtype=jnp.float32, attention_impl=impl, **extra)


def _port_model(impl):
    return get_model("distilbert").build(**SMALL, dtype=torch.float32,
                                         attention_impl=impl)


def _jax_params(model, seed):
    p = model.init(jax.random.key(seed), jnp.ones((1, SMALL["max_len"]), jnp.int32))
    return jax.tree.map(np.asarray, p["params"])


def _tokens(seed=0, B=5, L=16):
    """Tokens with padding (id 0): full rows, trailing pads, scattered pads
    and one row that is all padding."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, SMALL["vocab_size"], size=(B, L)).astype(np.int32)
    tok[1, 9:] = 0
    tok[2, ::3] = 0
    tok[3, :] = 0
    return tok


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("seed", [0, 1])
def test_logits_match_jax(impl, seed):
    jm = _jax_model(impl)
    params = _jax_params(jm, seed)
    tok = _tokens(seed)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(tok)))
    model = _port_model(impl)
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        out = model(torch.from_numpy(tok).long())
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_params_round_trip_exact(impl):
    params = _jax_params(_jax_model(impl), 3)
    port = params_from_jax(params)
    assert set(port) == set(dict(_port_model(impl).named_parameters()))
    back = params_to_jax(port, heads=SMALL["heads"])
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)
    again = params_from_jax(back)
    for k, t in port.items():
        assert torch.equal(again[k], t), k


def test_bf16_model_logits_close_to_f32():
    # The default compute dtype: bf16 matmuls with f32 params, LayerNorm
    # statistics, pooling and head. Against the same model in f32, at a
    # bf16 tolerance (8 mantissa bits through two layers).
    params = _jax_params(_jax_model("dense"), 4)
    tok = torch.from_numpy(_tokens(4)).long()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = get_model("distilbert").build(**SMALL, dtype=dtype)
        m.load_state_dict(params_from_jax(params))
        with torch.no_grad():
            out[dtype] = m(tok)
    assert out[torch.bfloat16].dtype == torch.float32
    np.testing.assert_allclose(out[torch.bfloat16].numpy(),
                               out[torch.float32].numpy(), atol=5e-2, rtol=0)


def test_flash_model_refuses_training():
    model = _port_model("flash")
    with pytest.raises(RuntimeError, match="forward-only"):
        model(torch.from_numpy(_tokens()).long())


@pytest.mark.parametrize("ring_use_flash", [False, True])
def test_ring_of_one_matches_jax_ring_model(ring_use_flash):
    """The ring model with sp_group=None (a ring of one, as on one GPU)
    against JAX's ring model on a 1-device sp mesh (tests/test_ops.py), on
    the dense model's parameters, which both carry unchanged."""
    from jax.sharding import Mesh, PartitionSpec as P

    params = _jax_params(_jax_model("dense"), 5)
    tok = _tokens(5)
    jm = _jax_model("ring", ring_use_flash=ring_use_flash)
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("sp",))
    ref = jax.jit(jax.shard_map(lambda p, t: jm.apply({"params": p}, t), mesh=mesh1,
                                in_specs=(P(), P(None, "sp")), out_specs=P()))(params, tok)
    model = get_model("distilbert").build(**SMALL, dtype=torch.float32,
                                          attention_impl="ring",
                                          ring_use_flash=ring_use_flash)
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        out = model(torch.from_numpy(tok).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGITS_ATOL, rtol=0)
    with pytest.raises(ValueError, match="max_len"):
        model(torch.ones((1, SMALL["max_len"] + 1), dtype=torch.long))


def test_registry_defaults_match_jax():
    spec, jspec = get_model("distilbert"), jax_get_model("distilbert")
    assert spec.defaults == jspec.defaults
    assert spec.example_input_shape == jspec.example_input_shape
    assert spec.num_classes == jspec.num_classes
    with pytest.raises(KeyError):
        get_model("no_such_model")


def test_init_params_shapes_and_seeding():
    model = _port_model("dense")
    a = model.init_params(torch.Generator().manual_seed(0))
    b = model.init_params(torch.Generator().manual_seed(0))
    c = model.init_params(torch.Generator().manual_seed(1))
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert {k: tuple(t.shape) for k, t in a.items()} == shapes
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.weight"], c["embed.weight"])
    # Same init families as flax: embeddings normal(0.02), unit LN scales.
    assert abs(float(a["embed.weight"].std()) - 0.02) < 2e-3
    assert torch.equal(a["blocks.0.ln_1.weight"], torch.ones(SMALL["width"]))
